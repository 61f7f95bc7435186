"""The port's importers of the reference's lmdb stores against the JAX
package's, on stores in the reference's bytes: the clip store of a source
lmdb (``--limit`` too) and the samples and vocabularies of a cache lmdb
(with ``max_words`` and ``remove_word_timing``, through the function and
through ``cli import-lmdb``) equal the JAX package's bit for bit, from
stores written by either package; and ``window_clips``, which shares the
word encoding, equals the JAX package's numpy path."""

import json

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import skeleton as jsk
from ha2g_tpu.data import dataset as jds
from ha2g_tpu.data import lmdb_import as jli
from ha2g_tpu.data import lmdb_mini as jlm
from ha2g_tpu.data import pyarrow_legacy as jal
from ha2g_tpu.data import vocab as jvocab
from ha2g_tpu.data.synthetic import default_mean_dir_vec, synthetic_clips

from ha2g_torch import skeleton as psk
from ha2g_torch.data import dataset as pds
from ha2g_torch.data import lmdb_import as pli
from ha2g_torch.data import vocab as pvocab


def _videos():
    """Three video records of two 6 s TED Gesture clips each, in the
    reference's record layout (make_ted_dataset.py)."""
    clips = synthetic_clips(jsk.TED_GESTURE, n_clips=6, clip_seconds=6.0,
                            n_speakers=3, seed=11)
    rng = np.random.default_rng(1)
    return [{"vid": f"vid_{i}", "clips": [{
        "words": [list(w) for w in c["words"]],
        "skeletons_3d": c["skeletons_3d"],
        "audio_feat": rng.normal(size=(128, 188)).astype(np.float32),
        "audio_raw": c["audio_raw"],
        "start_frame_no": c["start_frame_no"],
        "end_frame_no": c["end_frame_no"],
        "start_time": c["start_time"], "end_time": c["end_time"],
    } for c in clips[2 * i:2 * i + 2]]} for i in range(3)]


def _cache_records():
    """Twelve windows in the reference's cache layout
    (data_preprocessor.py:150-165), words past the window and long
    windows included."""
    rng = np.random.default_rng(3)
    n_ext = 42
    records = {}
    for i in range(12):
        n_words = 4 if i % 3 else 40
        words = [[f"w{rng.integers(0, 9)}", 1.0 + i + 0.08 * k,
                  1.05 + i + 0.08 * k] for k in range(n_words)]
        audio = rng.normal(size=int(n_ext / 15 * 16000) - 37 * (i % 2))
        aux = {"vid": f"vid_{i % 3}", "start_frame_no": i * 10,
               "end_frame_no": i * 10 + n_ext, "start_time": 1.0 + i,
               "end_time": 1.0 + i + n_ext / 15}
        records[f"{i:010}".encode("ascii")] = [
            words, rng.normal(size=(n_ext, 10, 3)).astype(np.float32),
            (rng.normal(size=(n_ext, 9, 3)) * 0.1).astype(np.float32),
            (audio * 0.1).astype(np.float32),
            rng.normal(size=(128, 87)).astype(np.float32), aux]
    return records


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Source and cache lmdbs written by the JAX package and by the
    port."""
    tmp = tmp_path_factory.mktemp("lmdb")
    videos = _videos()
    jli.write_reference_lmdb(tmp / "src_jax", videos)
    pli.write_reference_lmdb(tmp / "src_port", videos)
    cache = _cache_records()
    jlm.write_lmdb(tmp / "cache_jax", {k: jal.serialize(v)
                                       for k, v in cache.items()})
    pli.write_lmdb(tmp / "cache_port", {
        k: pli.serialize(v, legacy_envelope=False) for k, v in cache.items()})
    return tmp


def _assert_dirs_equal(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        if name.endswith(".npz"):
            with np.load(a / name) as x, np.load(b / name) as y:
                assert x.files == y.files
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, k
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            assert json.loads((a / name).read_text()) == \
                json.loads((b / name).read_text()), name


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("limit", [None, 3])
def test_import_lmdb_equals_jax(stores, tmp_path, writer, limit):
    src = str(stores / f"src_{writer}")
    n = pli.import_lmdb(src, tmp_path / "port", limit=limit)
    assert n == jli.import_lmdb(src, str(tmp_path / "jax"), limit) == \
        (limit or 6)
    _assert_dirs_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("options", [
    {}, {"max_words": 6}, {"remove_word_timing": True}, {"limit": 5},
    {"n_poses": 30, "fps": 15}], ids=lambda o: ",".join(o) or "default")
def test_import_cache_lmdb_equals_jax(stores, tmp_path, writer, options):
    src = str(stores / f"cache_{writer}")
    n = pli.import_cache_lmdb(src, tmp_path / "port", **options)
    assert n == jli.import_cache_lmdb(src, str(tmp_path / "jax"), **options)
    _assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    samples, lang, speaker = pli.load_imported_samples(tmp_path / "port")
    want, jlang, jspeaker = jli.load_imported_samples(tmp_path / "jax")
    for k in pli.SAMPLE_KEYS:
        np.testing.assert_array_equal(getattr(samples, k), getattr(want, k))
    assert lang.to_dict() == jlang.to_dict()
    assert speaker.to_dict() == jspeaker.to_dict()
    assert samples.word_lengths.max() <= options.get("max_words", 32)


def test_missing_store_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pli.import_lmdb(tmp_path / "nothing", tmp_path / "out")


@pytest.mark.parametrize("argv", [
    ["--max_words", "6"], ["--remove_word_timing"],
    ["--limit", "5", "--max_words", "8", "--remove_word_timing"],
    ["--n_poses", "30"]], ids=" ".join)
def test_cli_import_cache_options_equal_jax(stores, tmp_path, argv):
    from ha2g_torch import cli
    src = str(stores / "cache_port")
    assert cli.main(["import-lmdb", src, str(tmp_path / "port"), "--format",
                     "cache", *argv]) == 0
    options = {k.lstrip("-"): int(v) for k, v in zip(argv, argv[1:])
               if k.startswith("--") and not v.startswith("--")}
    jli.import_cache_lmdb(src, str(tmp_path / "jax"), **options,
                          remove_word_timing="--remove_word_timing" in argv)
    _assert_dirs_equal(tmp_path / "port", tmp_path / "jax")


def test_cli_import_source_refuses_cache_options(stores, tmp_path):
    from ha2g_torch import cli
    with pytest.raises(SystemExit):
        cli.main(["import-lmdb", str(stores / "src_port"),
                  str(tmp_path / "out"), "--max_words", "6"])


@pytest.mark.parametrize("use_native", (False, True),
                         ids=("numpy", "native"))
def test_window_clips_equals_jax(use_native):
    if use_native:
        from ha2g_torch import native as pnative
        from ha2g_tpu import native as jnative
        if not pnative.available():
            pytest.skip("no g++ on the PATH")
        if not jnative.available():
            pytest.skip("the JAX package's engine did not build")
    clips = synthetic_clips(jsk.TED_GESTURE, n_clips=3, clip_seconds=6.0,
                            n_speakers=2, seed=4)
    # a still clip the motion filter rejects
    clips[1]["skeletons_3d"] = np.repeat(clips[1]["skeletons_3d"][:1],
                                         len(clips[1]["skeletons_3d"]), 0)
    samples = []
    for ds, vocab, spec in ((pds, pvocab, psk.TED_GESTURE),
                            (jds, jvocab, jsk.TED_GESTURE)):
        lang = vocab.build_vocab("words", [clips])
        speaker = vocab.Vocab("vid", insert_default_tokens=False)
        for c in clips:
            speaker.index_word(c["vid"])
        samples.append(ds.window_clips(
            clips, spec, lang, speaker, np.zeros(30, np.float32),
            default_mean_dir_vec(jsk.TED_GESTURE), use_native=use_native))
    got, want = samples
    for k in pli.SAMPLE_KEYS:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
