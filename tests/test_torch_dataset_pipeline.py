"""The port's dataset construction (``ha2g_torch/dataset_pipeline``)
against the JAX package's on the same inputs: speaker tracking and the
clip filter's verdicts and messages, the split, ``parse_vtt``, the
OpenPose / ExPose adapters, ``build_dataset`` over one work directory of
tool artifacts (equal clip stores: skeletons, words and audio exact, the
log-mel within 1e-6), and the QA report's decisions, with its contact
sheets decoded by Pillow."""

import base64
import io
import json
import re
import wave

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import cli
from ha2g_torch.data.storage import load_clips
from ha2g_torch.dataset_pipeline import filtering as pf
from ha2g_torch.dataset_pipeline import pipeline as pp
from ha2g_torch.dataset_pipeline import report as pr
from ha2g_torch.dataset_pipeline import runners as prun
from ha2g_torch.dataset_pipeline.assemble import split_clips
from ha2g_tpu.dataset_pipeline import filtering as jf
from ha2g_tpu.dataset_pipeline import pipeline as jp
from ha2g_tpu.dataset_pipeline import report as jr
from ha2g_tpu.dataset_pipeline import runners as jrun
from ha2g_tpu.dataset_pipeline.assemble import split_clips as jsplit


def _person(x0, conf=0.9, facing_front=True, shoulder=150.0, n_points=8):
    """Frontal upper-body keypoints around x0 (nose, neck, r-shoulder,
    r-elbow, r-wrist, l-shoulder, l-elbow, l-wrist), padded with zero
    rows to ``n_points``."""
    p = np.zeros((n_points, 3), np.float32)
    xs = [x0, x0, x0 - shoulder / 2, x0 - shoulder / 2 - 10,
          x0 - shoulder / 2 - 20, x0 + shoulder / 2, x0 + shoulder / 2 + 10,
          x0 + shoulder / 2 + 20]
    if not facing_front:
        xs[2], xs[5] = xs[5], xs[2]
    p[:8, 0] = xs
    p[:8, 1] = [100, 160, 160, 220, 280, 160, 220, 280]
    p[:8, 2] = conf
    return p


def _scene(kind, n=100):
    if kind == "short":
        return _scene("good")[:10]
    if kind == "crowd":
        return [np.stack([_person(100 * k) for k in range(1, 8)])
                for _ in range(n)]
    if kind == "sideways":
        out = []
        for _ in range(n):
            p = _person(500)
            p[0, 0] = 800            # nose outside the shoulders
            out.append(np.stack([p]))
        return out
    if kind == "missing":
        out = []
        for _ in range(n):
            p = _person(500)
            p[4, :] = 0              # a wrist not found
            out.append(np.stack([p]))
        return out
    if kind == "tracking":
        # the speaker jumps across the frame half-way: tracking fails
        return [np.stack([_person(200 if t < 40 else 1800)])
                for t in range(n)]
    kw = {"good": {}, "back": {"facing_front": False},
          "small": {"shoulder": 40}}[kind]
    return [np.stack([_person(500 + 0.2 * t, **kw)]) for t in range(n)]


SCENES = ("good", "short", "back", "small", "crowd", "sideways", "missing",
          "tracking")


def _same_tracks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kind", SCENES)
def test_filter_and_speaker_equal_jax(kind):
    scene = _scene(kind)
    tracked = pf.select_main_speaker(scene)
    _same_tracks(tracked, jf.select_main_speaker(scene))
    got, want = pf.ClipFilter(scene, tracked), jf.ClipFilter(scene, tracked)
    assert got.is_correct_clip() == want.is_correct_clip()
    assert got.message == want.message
    expected = {"good": "PASS", "short": "too short",
                "back": "looking behind", "small": "too small",
                "crowd": "too many people", "sideways": "looking sideways",
                "missing": "too many missing joints",
                # frames without the tracked speaker count against every
                # check; the first that trips is the back check
                "tracking": "looking behind"}[kind]
    assert got.message == expected


def test_two_people_tracking_equal_jax():
    scene = [np.stack([_person(200 + t, conf=0.4),
                       _person(600 + 2 * t, conf=0.9)]) for t in range(10)]
    tracked = pf.select_main_speaker(scene)
    _same_tracks(tracked, jf.select_main_speaker(scene))
    assert abs(tracked[0][0, 0] - 600) < 5 and abs(tracked[-1][0, 0] - 618) < 5


@pytest.mark.parametrize("n", (1, 10, 37, 100))
def test_split_equal_jax(n):
    assert split_clips(n) == jsplit(n)


VTT = """WEBVTT
Kind: captions
Language: en

00:00:00.000 --> 00:00:02.000 align:start position:0%

hello<00:00:00.500><c> there</c><00:00:01.100><c> friends</c>

00:00:02.000 --> 00:00:04.000
plain cue words here

1:02:03,250 --> 1:02:05,750
late<01:02:04.000><c> words</c>

1:02:06.000 --> 1:02:08.000
<c.colorE5E5E5>tagged</c><01:02:07.000><c> cue</c>
"""


def test_parse_vtt_equal_jax(tmp_path):
    path = tmp_path / "a.vtt"
    path.write_text(VTT)
    got = pp.parse_vtt(path)
    assert got == jp.parse_vtt(path)
    assert got[:3] == [("hello", 0.0, 0.5), ("there", 0.5, 1.1),
                       ("friends", 1.1, 2.0)]
    assert got[3] == ("plain", 2.0, 2.5)
    assert got[-3:] == [("words", 3724.0, 3725.75),
                        ("tagged", 3726.0, 3727.0), ("cue", 3727.0, 3728.0)]


def test_openpose_expose_adapters_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    vid = "vid00000001"
    op_dir = tmp_path / "openpose" / vid
    op_dir.mkdir(parents=True)
    for i in range(6):
        people = []
        if i != 3:                      # frame 3: nobody
            for _ in range(2 if i == 1 else 1):
                flat = rng.uniform(0, 640, 75).astype(np.float32).tolist()
                key = "pose_keypoints" if i == 4 else "pose_keypoints_2d"
                people.append({key: flat})
        (op_dir / f"{vid}_{i:012d}_keypoints.json").write_text(
            json.dumps({"version": 1.3, "people": people}))
    ex_dir = tmp_path / "expose" / vid
    ex_dir.mkdir(parents=True)
    for i in range(6):
        joints = rng.normal(size=(1, 118, 3)).astype(np.float32)
        np.savez(ex_dir / f"frame_{i:012d}_params.npz", joints=joints)

    video = str(tmp_path / "videos" / f"{vid}.mp4")
    got = np.load(prun.pose_estimation(video, str(tmp_path / "p"),
                                       str(op_dir), str(ex_dir)),
                  allow_pickle=True)
    want = np.load(jrun.pose_estimation(video, str(tmp_path / "j"),
                                        str(op_dir), str(ex_dir)),
                   allow_pickle=True)
    assert [f.shape for f in got["keypoints_2d"]] == \
        [(1, 25, 3), (2, 25, 3), (1, 25, 3), (0, 25, 3), (1, 25, 3),
         (1, 25, 3)]
    for a, b in zip(got["keypoints_2d"], want["keypoints_2d"]):
        assert a.tobytes() == b.tobytes()
    assert got["skeletons_3d"].shape == (6, 23, 3)
    assert got["skeletons_3d"].tobytes() == want["skeletons_3d"].tobytes()
    # resume: the second call returns the file as it is
    assert prun.pose_estimation(video, str(tmp_path / "p")) == \
        tmp_path / "p" / "keypoints" / f"{vid}.npz"
    with pytest.raises(prun.StepUnavailable):
        prun.pose_estimation(str(tmp_path / "videos" / "other.mp4"),
                             str(tmp_path / "p"))


def _artifacts(work, vid, seed, good_frames, n_frames=250):
    """A work directory's artifacts of one video, as the outside tools
    would leave them: the video (resume marker), a 16 kHz wav, keypoints
    (a speaker in [0, good_frames), nobody after), 3-D skeletons, scenes
    and an auto-subtitle .vtt."""
    rng = np.random.default_rng(seed)
    for d in ("videos", "audio", "keypoints", "scenes"):
        (work / d).mkdir(parents=True, exist_ok=True)
    (work / "videos" / f"{vid}.mp4").write_bytes(b"\x00")
    pcm = (rng.normal(size=int(16000 * n_frames / 25)) * 3000).astype("<i2")
    with wave.open(str(work / "audio" / f"{vid}.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    kp = np.empty(n_frames, dtype=object)
    for i in range(n_frames):
        kp[i] = (np.stack([_person(300 + 0.2 * i, n_points=25)])
                 if i < good_frames else np.zeros((0, 25, 3), np.float32))
    np.savez_compressed(work / "keypoints" / f"{vid}.npz", keypoints_2d=kp,
                        skeletons_3d=rng.normal(size=(n_frames, 23, 3))
                        .astype(np.float32))
    (work / "scenes" / f"{vid}.csv").write_text(
        f"0,{good_frames // 2}\n{good_frames // 2},{good_frames}\n"
        f"{good_frames},{n_frames}\n")
    cues = "".join(
        f"00:00:{2 * c:02d}.000 --> 00:00:{2 * c + 2:02d}.000\n"
        f"w{c}a<00:00:{2 * c:02d}.600><c> w{c}b</c><00:00:{2 * c + 1:02d}"
        f".300><c> w{c}c</c>\n\n" for c in range(n_frames // 50))
    (work / "videos" / f"{vid}-en-auto.vtt").write_text("WEBVTT\n\n" + cues)


def test_build_dataset_equal_jax_and_cli_report(tmp_path):
    from PIL import Image

    work = tmp_path / "work"
    ids = ["vid_a", "vid_b", "vid_none"]
    _artifacts(work, "vid_a", 0, 200)
    _artifacts(work, "vid_b", 1, 180)
    # a video whose pose estimation never ran: skipped
    (work / "videos" / "vid_none.mp4").write_bytes(b"\x00")
    with wave.open(str(work / "audio" / "vid_none.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(b"\x00\x00" * 16000)

    got = pp.build_dataset(ids, str(work), str(tmp_path / "port"))
    want = jp.build_dataset(ids, str(work), str(tmp_path / "jax"))
    assert got == want
    assert got["videos"] == 2 and got["skipped"] == ["vid_none"]
    assert got["train"] + got["val"] + got["test"] == 4
    for split in ("train", "val", "test"):
        if not got[split]:
            assert not (tmp_path / "port" / split).exists()
            continue
        a = load_clips(tmp_path / "port" / split)
        b = load_clips(tmp_path / "jax" / split)
        assert len(a) == len(b) == got[split]
        for x, y in zip(a, b):
            for k in ("skeletons_3d", "audio_raw"):
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes(), k
            assert x["audio_spec"].dtype == y["audio_spec"].dtype
            np.testing.assert_allclose(x["audio_spec"].astype(np.float32),
                                       y["audio_spec"].astype(np.float32),
                                       atol=1e-6, rtol=0)
            for k in ("vid", "words", "start_time", "end_time",
                      "start_frame_no", "end_frame_no"):
                assert x[k] == y[k], k

    # the command line with the QA report
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["build-dataset", *ids, "--work", str(work), "--out",
                       str(tmp_path / "cli"), "--qa-report"])
    assert rc == 0 and "'videos': 2" in buf.getvalue()
    text = (tmp_path / "cli" / "qa_report.html").read_text()
    pngs = re.findall(r'data:image/png;base64,([A-Za-z0-9+/=]+)"', text)
    # 6 scenes: 4 pass, 2 (nobody in frame) rejected -> 3 + 2 sheets
    assert len(pngs) == 5 and "66.7%" in text
    for b64 in pngs:
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        assert img.size == (4 * pr.PANEL_PX, pr.PANEL_PX)
        assert np.asarray(img.convert("RGB")).min() < 255  # something drawn
    assert cli.main(["build-dataset", "--work", str(work), "--out",
                     str(tmp_path / "none")]) == 1


def test_qa_decisions_equal_jax(tmp_path):
    from PIL import Image

    scenes = [_scene(k) for k in ("good", "short", "back", "tracking")]
    got, want = pr.run_filter_pass(scenes), jr.run_filter_pass(scenes)
    assert [d["verdict"] for d in got] == [d["verdict"] for d in want] == \
        ["PASS", "too short", "looking behind", "looking behind"]
    for a, b in zip(got, want):
        assert {k: a[k] for k in ("index", "passed", "n_frames")} == \
            {k: b[k] for k in ("index", "passed", "n_frames")}
        _same_tracks(a["speakers"], b["speakers"])
    out = pr.write_qa_report(scenes, got, tmp_path / "qa.html")
    text = out.read_text()
    assert "looking behind" in text and "50.0%" in text
    pngs = re.findall(r'data:image/png;base64,([A-Za-z0-9+/=]+)"', text)
    assert len(pngs) == 4
    sheet = np.asarray(Image.open(io.BytesIO(base64.b64decode(pngs[0])))
                       .convert("RGB"))
    assert sheet.shape == (pr.PANEL_PX, 4 * pr.PANEL_PX, 3)
    # the tracked speaker's joints in red, bones in blue
    assert (sheet == (214, 39, 40)).all(-1).any()
    assert (sheet == (31, 119, 180)).all(-1).any()
