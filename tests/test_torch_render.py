"""The port's skeleton animations (``ha2g_torch/render.py``) without
matplotlib or Pillow: the 2-D projection against matplotlib's own 3D
axes (``mpl_toolkits.mplot3d.proj3d``, within 1e-6), the GIF read back by
Pillow (frames, size, delay), the LZW encoder exact on random frames, the
file names, the ffmpeg branch against a stubbed ffmpeg, and ``cli
synthesize --render`` and ``Trainer.fit(render_every=1)`` on a narrow CPU
hierarchy (matplotlib and Pillow in the tests only)."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import cli, render
from ha2g_torch.config import Config
from ha2g_torch.data.dataset import window_clips
from ha2g_torch.data.synthetic import default_mean_dir_vec, synthetic_clips
from ha2g_torch.data.vocab import Vocab, build_vocab
from ha2g_torch.skeleton import SKELETONS, TED_GESTURE
from ha2g_torch.train.loop import Trainer
from ha2g_torch.utils.image import gif_bytes, lzw_encode

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "hierarchy.yaml"


def _mpl_axes(elev, azim):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 4))
    ax = fig.add_subplot(1, 2, 1, projection="3d")
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlim3d(-0.5, 0.5)
    ax.set_ylim3d(0.5, -0.5)
    ax.set_zlim3d(0.5, -0.5)
    return fig, ax


@pytest.mark.parametrize("elev,azim", ((20, -60), (35, 40)))
def test_projection_matches_matplotlib(elev, azim):
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import proj3d
    fig, ax = _mpl_axes(elev, azim)
    M = ax.get_proj()
    np.testing.assert_allclose(render.projection_matrix(elev, azim), M,
                               atol=1e-12, rtol=0)
    assert np.allclose(ax.viewLim.intervalx, render.VIEW_LIMITS)
    plt.close(fig)
    rng = np.random.default_rng(0)
    pose = rng.uniform(-0.6, 0.6, (4, 43, 3))
    # the JAX renderer plots (x, z, y)
    tx, ty, _ = proj3d.proj_transform(pose[..., 0].ravel(),
                                      pose[..., 2].ravel(),
                                      pose[..., 1].ravel(), M)
    got = render.project(pose, render.projection_matrix(elev, azim))
    assert got.shape == (4, 43, 2)
    np.testing.assert_allclose(got.reshape(-1, 2), np.stack([tx, ty], 1),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_colors,shape", ((2, (7, 5)), (12, (64, 96)),
                                            (256, (90, 130))))
def test_lzw_gif_exact_under_pillow(n_colors, shape):
    from PIL import Image
    rng = np.random.default_rng(n_colors)
    frames = [rng.integers(0, n_colors, shape).astype(np.uint8)
              for _ in range(3)]
    # a long run too: the code table fills and is cleared
    frames.append(np.repeat(np.arange(shape[0] * shape[1]) % n_colors,
                            1).reshape(shape).astype(np.uint8))
    palette = rng.integers(0, 256, (n_colors, 3)).astype(np.uint8)
    im = Image.open(io.BytesIO(gif_bytes(frames, palette, 66)))
    assert im.n_frames == len(frames) and im.size == shape[::-1]
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      palette[f])
    assert im.info["duration"] == 60 and im.info["loop"] == 0
    # one pixel: clear (4), the pixel, end (5), 3 bits each
    assert lzw_encode(b"\x01", 2) == bytes([0b01001100, 0b1])


def test_create_video_names_and_frames(tmp_path):
    from PIL import Image
    spec = SKELETONS["ted_expressive"]
    mean = default_mean_dir_vec(spec)
    rng = np.random.default_rng(1)
    out = (rng.normal(size=(34, spec.pose_dim)) * 0.05).astype(np.float32)
    path = render.create_video_and_save(
        str(tmp_path / "v"), 7, "val", 2, out[:30], out, mean, "t", spec,
        audio=np.zeros(16000, np.float32))
    assert path == f"{tmp_path / 'v'}/val_007_2.gif"
    im = Image.open(path)
    assert im.n_frames == 34 and im.size == (2 * render.PANEL_PX,
                                             render.PANEL_PX)
    assert im.info["duration"] == (1000 // 15) // 10 * 10
    # frame 31: the human panel is empty (30 frames), the generated not
    im.seek(31)
    px = np.asarray(im.convert("RGB"))
    left, right = px[2:-2, 2:render.PANEL_PX - 2], px[2:-2,
                                                       render.PANEL_PX + 2:-2]
    assert (left == 255).all() and (right < 255).any()
    # no target: the left panel stays empty throughout
    path = render.create_video_and_save(str(tmp_path), 0, "synth", 0, None,
                                        out[:3], mean, "t", spec, fps=25)
    im = Image.open(path)
    assert Path(path).name == "synth_000_0.gif" and im.n_frames == 3
    assert im.info["duration"] == 40


@pytest.mark.parametrize("with_audio,delete_audio",
                         ((False, True), (True, True), (True, False)),
                         ids=("no-audio", "audio", "audio-kept"))
def test_ffmpeg_branch(tmp_path, monkeypatch, with_audio, delete_audio):
    """Where ffmpeg exists: the raw rgb24 frames piped at -s WxH, the
    WAV muxed into ``<stem>.mp4``, the temp video and (unless asked to
    keep it) the WAV removed.  ffmpeg itself is stubbed: each call writes
    its output file, as ffmpeg would."""
    spec = SKELETONS["ted_expressive"]
    mean = default_mean_dir_vec(spec)
    out = (np.random.default_rng(2).normal(size=(5, spec.pose_dim))
           * 0.05).astype(np.float32)
    calls = []

    def fake(argv, input=None, **kw):
        calls.append((argv, input))
        Path(argv[-1]).write_bytes(b"mp4")
        return 0

    monkeypatch.setattr(render.shutil, "which",
                        lambda name: "/bin/ffmpeg" if name == "ffmpeg"
                        else None)
    monkeypatch.setattr(render.subprocess, "run", fake)
    monkeypatch.setattr(render.subprocess, "call", fake)
    audio = np.zeros(8000, np.float32) if with_audio else None
    stem = tmp_path / "val_003_1"
    path = render.create_video_and_save(
        str(tmp_path), 3, "val", 1, out, out, mean, "t", spec, audio=audio,
        delete_audio_file=delete_audio)
    assert path == f"{stem}.mp4"
    (argv, piped), *rest = calls
    assert argv[0] == "/bin/ffmpeg"
    assert argv[argv.index("-s") + 1] == f"{2 * render.PANEL_PX}x" \
        f"{render.PANEL_PX}" == "480x240"
    assert argv[argv.index("-pix_fmt") + 1] == "rgb24"
    assert argv[argv.index("-r") + 1] == "15"
    assert len(piped) == 5 * 480 * 240 * 3
    if not with_audio:
        assert argv[-1] == path and not rest
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["val_003_1.mp4"]
        return
    assert argv[-1] == f"{stem}_temp.mp4"
    (mux, _), = rest
    assert mux[mux.index("-i") + 1] == f"{stem}_temp.mp4"
    assert mux[mux.index("-i", mux.index("-i") + 1) + 1] == f"{stem}.wav"
    assert mux[-1] == path
    kept = ["val_003_1.mp4"] + ([] if delete_audio else ["val_003_1.wav"])
    assert sorted(p.name for p in tmp_path.iterdir()) == kept


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A narrow TED Gesture hierarchy fit for one epoch with
    render_every=1 on the CPU."""
    root = tmp_path_factory.mktemp("render")
    cfg = Config.from_yaml(CONFIG, hidden_size=8, n_layers=1, batch_size=4,
                           compute_dtype="float32", epochs=1,
                           eval_net_path="", random_seed=0,
                           model_save_path=str(root / "out"))
    clips = synthetic_clips(TED_GESTURE, n_clips=2, clip_seconds=5.0, seed=0)
    lang = build_vocab("words", [clips])
    lang.random_word_vectors(cfg.wordembed_dim)
    speaker = Vocab("vid", insert_default_tokens=False)
    for c in clips:
        speaker.index_word(c["vid"])
    samples = window_clips(clips, TED_GESTURE, lang, speaker,
                           cfg.mean_pose_array, cfg.mean_dir_vec_array)
    trainer = Trainer(cfg, samples, samples, lang, speaker, device="cpu")
    trainer.fit(render_every=1)
    return root, trainer


def test_fit_renders_every_epoch(trained, monkeypatch, caplog):
    from PIL import Image
    root, trainer = trained
    im = Image.open(root / "out" / "videos" / "val_000_0.gif")
    assert im.n_frames == 34
    # the gate, on a fit whose epochs, evaluations and saves are stubs:
    # every render_every-th epoch, only with save_result_video
    calls = []
    monkeypatch.setattr(trainer, "render_sample",
                        lambda epoch, path: calls.append(epoch))
    monkeypatch.setattr(trainer, "train_epoch", lambda epoch: {})
    monkeypatch.setattr(trainer, "validate", lambda epoch: {"loss": 1.0})
    monkeypatch.setattr(trainer, "save", lambda path, extra: None)
    trainer.fit(epochs=5, save_path=root / "gated", render_every=2)
    assert calls == [0, 2, 4]
    trainer.cfg = trainer.cfg.replace(save_result_video=False)
    trainer.fit(epochs=3, save_path=root / "gated", render_every=1)
    assert calls == [0, 2, 4]
    trainer.cfg = trainer.cfg.replace(save_result_video=True)

    def boom(*a):
        raise ValueError("no frames")

    monkeypatch.setattr(trainer, "render_sample", boom)
    trainer.fit(epochs=1, save_path=root / "failed", render_every=1)
    assert "sample render failed: no frames" in caplog.text
    assert Config.from_dict({"save_result_video": False}).save_result_video \
        is False


def test_cli_synthesize_render(trained, tmp_path):
    from PIL import Image
    root, _ = trained
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["synthesize", str(root / "out" / "checkpoint_final"),
                       "--n", "1", "--render", "--device", "cpu",
                       "--out", str(tmp_path / "synth.npz")])
    assert rc == 0
    gif = tmp_path / "synth_000_0.gif"
    assert f"rendered {gif}" in buf.getvalue()
    frames = np.load(tmp_path / "synth.npz")["dir_vec"].shape[1]
    im = Image.open(gif)
    assert im.n_frames == frames and im.size == (2 * render.PANEL_PX,
                                                 render.PANEL_PX)
    assert torch.get_num_threads() == 1
