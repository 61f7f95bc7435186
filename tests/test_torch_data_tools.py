"""The port's H36M windows, dataset statistics and trajectory tools against
the JAX package's (numpy and the CPU), and the commands of the data path
on the CPU: ``import-lmdb`` then ``train`` of a narrow hierarchy on the
imported samples with fastText word vectors, ``compare-trajectory`` on its
history, ``train`` of the gesture autoencoder on an H36M npz,
``import-embeddings``, ``motion-stats``, ``angle-stats``,
``parse-reference-log`` and ``doctor --device cpu``."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import skeleton as jsk
from ha2g_tpu import tools as jtools
from ha2g_tpu.data import fasttext_bin as jft
from ha2g_tpu.data import h36m as jh36m
from ha2g_tpu.data import storage as jstorage
from ha2g_tpu.data import vocab as jvocab
from ha2g_tpu.data.synthetic import default_mean_dir_vec, synthetic_clips
from ha2g_tpu.eval import trajectory as jtj
from tests.test_trajectory import FAKE_LOG, OLD_STYLE_VAL

from ha2g_torch import cli
from ha2g_torch import skeleton as psk
from ha2g_torch import tools as ptools
from ha2g_torch.config import parse_cli
from ha2g_torch.data import h36m as ph36m
from ha2g_torch.data import lmdb_import as pli
from ha2g_torch.data.arrow_legacy import serialize
from ha2g_torch.data.fasttext_bin import write_model
from ha2g_torch.data.lmdb_mini import write_lmdb
from ha2g_torch.eval import trajectory as ptj

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-5


def _rel_close(got, want):
    """|got - want| within 1e-5 of want's largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max(), \
        np.abs(got - want).max()


def _run(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _yaml(text: str) -> dict:
    return yaml.safe_load("\n".join(ln for ln in text.splitlines()
                                    if not ln.startswith("#")))


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    rng = np.random.default_rng(2)
    positions = {"S1": {"Walking": rng.normal(size=(300, 32, 3))},
                 "S9": {"Sitting": rng.normal(size=(160, 32, 3))},
                 "S11": {"Eating": rng.normal(size=(150, 32, 3))},
                 "S2": {"Other": rng.normal(size=(100, 32, 3))}}
    path = tmp_path_factory.mktemp("h36m") / "h36m.npz"
    np.savez(path, positions_3d=np.array(
        {s: {a: p.astype(np.float32) for a, p in acts.items()}
         for s, acts in positions.items()}, dtype=object))
    return path


@pytest.mark.parametrize("is_train", [True, False])
def test_h36m_windows_equal_jax(h36m, is_train):
    mean = default_mean_dir_vec(jsk.TED_GESTURE)
    got = ph36m.h36m_windows(h36m, mean, is_train=is_train)
    want = jh36m.h36m_windows(str(h36m), mean, is_train=is_train)
    assert got.dtype == want.dtype and got.shape[1:] == (34, 27)
    _rel_close(got, want)
    raw = np.random.default_rng(0).normal(size=(5, 12, 3)).astype(np.float32)
    _rel_close(ph36m.normalize_h36m(raw), jh36m.normalize_h36m(raw))


@pytest.mark.parametrize("name", ["ted_gesture", "ted_expressive"])
def test_motion_and_angle_stats_equal_jax(name):
    jspec, pspec = jsk.SKELETONS[name], psk.SKELETONS[name]
    clips = synthetic_clips(jspec, n_clips=3, clip_seconds=4.0, seed=3)
    got, want = ptools.motion_stats(clips, pspec), \
        jtools.motion_stats(clips, jspec)
    assert got["n_frames"] == want["n_frames"]
    for k in ("mean_pose", "mean_dir_vec", "mean_bone_lengths"):
        _rel_close(got[k], want[k])
    mean = default_mean_dir_vec(jspec)
    targets = (np.random.default_rng(1).normal(
        size=(6, 34, jspec.pose_dim)) * 0.2).astype(np.float32)
    got, want = ptools.angle_stats(targets, mean, pspec), \
        jtools.angle_stats(targets, mean, jspec)
    for k in ("avg_angle", "var_angle", "change_angle"):
        _rel_close(got[k], want[k])


def test_trajectory_parse_and_compare_equal_jax(tmp_path):
    log = tmp_path / "ref.log"
    log.write_text(FAKE_LOG + OLD_STYLE_VAL)
    assert ptj.parse_reference_log(log).to_json() == \
        jtj.parse_reference_log(log).to_json()
    for name in ("ted_gesture_new", "ted_gesture_original",
                 "ted_expressive_new", "ted_expressive_original"):
        assert ptj.load_baseline(name).to_json() == \
            jtj.load_baseline(name).to_json()
    history = tmp_path / "history.jsonl"
    history.write_text("\n".join(json.dumps(r) for r in [
        {"epoch": 0, "frechet": 300.0, "diversity": 20.0, "loss": 0.3},
        {"epoch": 50, "frechet": 2.0, "diversity": 105.0, "loss": 0.3}]))
    keys = ("frechet", "diversity", "loss", "joint_mae", "feat_dist")
    for name in ("ted_gesture_new", "ted_expressive_original"):
        got = ptj.compare_trajectories(ptj.load_baseline(name),
                                       ptj.load_history_jsonl(history), keys)
        want = jtj.compare_trajectories(jtj.load_baseline(name),
                                        jtj.load_history_jsonl(history), keys)
        assert got == want
        assert ptj.format_report(got) == jtj.format_report(want)
    short = ptj.Trajectory("short", val=[{"epoch": 0, "loss": 0.1}])
    short.best = ptj.best_of(short.val)
    ours = ptj.Trajectory("ours", val=[{"epoch": 0, "loss": 5.0}])
    ours.best = ptj.best_of(ours.val)
    assert ptj.compare_trajectories(short, ours, ("loss",))["metrics"][
        "loss"]["verdict"] == "INSUFFICIENT_REF"
    rc, out = _run(["parse-reference-log", str(log), "--out",
                    str(tmp_path / "ref.json")])
    assert rc == 0 and "parsed 3 val epochs" in out
    assert json.loads((tmp_path / "ref.json").read_text()) == json.loads(
        json.dumps(jtj.parse_reference_log(log).to_json()))


def _cache_lmdb(path, n=12):
    """A cache lmdb of ``n`` TED Gesture windows (reference layout)."""
    rng = np.random.default_rng(5)
    records = {}
    for i in range(n):
        words = [[f"w{rng.integers(0, 12)}", 1.0 + i + 0.25 * k,
                  1.2 + i + 0.25 * k] for k in range(8)]
        aux = {"vid": f"vid_{i % 3}", "start_frame_no": i * 10,
               "end_frame_no": i * 10 + 42, "start_time": 1.0 + i,
               "end_time": 1.0 + i + 42 / 15}
        records[f"{i:010}".encode()] = serialize([
            words, rng.normal(size=(42, 10, 3)).astype(np.float32),
            (rng.normal(size=(42, 9, 3)) * 0.1).astype(np.float32),
            (rng.normal(size=44800) * 0.1).astype(np.float32),
            rng.normal(size=(128, 87)).astype(np.float32), aux])
    write_lmdb(path, records)


def _fasttext(path, dim=16):
    words = ["</s>"] + [f"w{i}" for i in range(6)]
    matrix = np.random.default_rng(6).normal(
        size=(len(words) + 100, dim)).astype(np.float32)
    write_model(path, words, matrix, bucket=100, minn=3, maxn=6)


def test_cli_import_then_train_on_imported_samples(tmp_path):
    """import-lmdb --format cache, train a narrow hierarchy on the samples
    (fastText vectors, validation on the training set) for one step, and
    compare-trajectory on its history (structure; exit 1: one step is
    behind the reference)."""
    _cache_lmdb(tmp_path / "cache")
    rc, out = _run(["import-lmdb", str(tmp_path / "cache"),
                    str(tmp_path / "samples"), "--format", "cache"])
    assert rc == 0 and "imported 12 windowed samples" in out
    # a checkpoint's vocabularies win over the imported ones
    from ha2g_torch.data.vocab import Vocab
    lang, speaker = Vocab("words"), Vocab("vid", insert_default_tokens=False)
    cfg = parse_cli(["--config", str(ROOT / "configs" / "hierarchy.yaml"),
                     "--train_data_path", str(tmp_path / "samples")])
    got = cli._prepare(cfg, lang, speaker)
    assert got[1] is lang and got[2] is speaker and len(got[3]) == 12
    _fasttext(tmp_path / "vectors.bin")
    rc, _ = _run([
        "train", "--config", str(ROOT / "configs" / "hierarchy.yaml"),
        "--device", "cpu", "--hidden_size", "16", "--n_layers", "1",
        "--batch_size", "8", "--compute_dtype", "float32", "--epochs", "1",
        "--loss_warmup", "0", "--random_seed", "0", "--wordembed_dim", "16",
        "--wordembed_path", str(tmp_path / "vectors.bin"),
        "--train_data_path", str(tmp_path / "samples"),
        "--test_data_path", "", "--val_data_path", "",
        "--eval_net_path", "", "--model_save_path", str(tmp_path / "out")])
    assert rc == 0
    rows = [json.loads(ln) for ln in
            (tmp_path / "out" / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    rc, out = _run(["compare-trajectory",
                    str(tmp_path / "out" / "history.jsonl"), "--ref",
                    "ted_gesture_new", "--json", str(tmp_path / "rep.json")])
    report = json.loads((tmp_path / "rep.json").read_text())
    assert rc == 1 and "trajectory: history vs reference" in out
    assert set(report["metrics"]) == {"frechet", "joint_mae", "diversity",
                                      "feat_dist", "loss"}


def test_cli_train_autoencoder_on_h36m(h36m, tmp_path):
    cfg = tmp_path / "h36m.yaml"
    cfg.write_text(f"model: gesture_autoencoder\ndataset: ted_gesture\n"
                   f"train_data_path: {h36m}\nepochs: 1\nbatch_size: 8\n")
    rc, _ = _run(["train", "--config", str(cfg), "--device", "cpu",
                  "--model_save_path", str(tmp_path / "out")])
    assert rc == 0
    saved = json.loads((tmp_path / "out" / "checkpoint_final" /
                        "config.json").read_text())
    assert saved["config"]["embed_pose_diff_loss"] is True


def test_cli_import_embeddings_and_stats(tmp_path):
    clips = synthetic_clips(jsk.TED_GESTURE, n_clips=3, clip_seconds=6.0,
                            n_speakers=2, seed=3)
    jstorage.save_clips(tmp_path / "clips", clips)
    _fasttext(tmp_path / "model.bin")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"model: hierarchy\ndataset: ted_gesture\n"
                   f"train_data_path: {tmp_path / 'clips'}\n"
                   f"test_data_path: {tmp_path / 'clips'}\n")
    lang = jvocab.build_vocab("words", [clips, clips])
    for model in ("model.bin", "model.vec"):
        if model.endswith(".vec"):
            m = jft.load_model(tmp_path / "model.bin")
            (tmp_path / model).write_text(f"{len(m.words)} 16\n" + "".join(
                w + " " + " ".join(map(str, m.get_word_vector(w))) + "\n"
                for w in m.words))
        rc, out = _run(["import-embeddings", str(tmp_path / model),
                        str(tmp_path / "table.npy"), "--config", str(cfg),
                        "--dim", "16"])
        assert rc == 0 and f"aligned {lang.n_words} words" in out
        lang.load_word_vectors(tmp_path / model, 16)
        np.testing.assert_allclose(np.load(tmp_path / "table.npy"),
                                   lang.word_embedding_weights, atol=1e-6,
                                   rtol=0)

    rc, out = _run(["motion-stats", str(tmp_path / "clips"), "--dataset",
                    "ted_gesture"])
    want = jtools.motion_stats(clips, jsk.TED_GESTURE)
    got = _yaml(out)
    assert rc == 0
    for k in ("mean_pose", "mean_dir_vec"):
        _rel_close(got[k], want[k])

    rc, out = _run(["angle-stats", "--config", str(cfg),
                    "--wordembed_dim", "8"])
    got = _yaml(out)
    assert rc == 0
    assert got["angle_pairs"] == [list(p) for p in
                                  jsk.TED_GESTURE.angle_prior.pairs]
    _, _, _, train_s, _ = cli._prepare(parse_cli(
        ["--config", str(cfg), "--wordembed_dim", "8"]))
    want = jtools.angle_stats(np.asarray(train_s.target),
                              default_mean_dir_vec(jsk.TED_GESTURE),
                              jsk.TED_GESTURE)
    for k in ("avg_angle", "var_angle", "change_angle"):
        _rel_close(got[k], want[k])


def test_cli_doctor_on_the_cpu():
    rc, out = _run(["doctor", "--device", "cpu"])
    assert rc == 0 and out.splitlines()[-1] == "OK"
    assert "device: cpu" in out and "mel front-end" in out
