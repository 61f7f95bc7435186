"""The port's data path against the JAX package's: synthetic clips and
windowed samples equal bit for bit, vocabularies and clip stores that
each package reads from the other, and the batch loader's index order for
a seed.  numpy and the CPU only."""

import json

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import skeleton as jsk
from ha2g_tpu.data import dataset as jds
from ha2g_tpu.data import loader as jloader
from ha2g_tpu.data import storage as jstorage
from ha2g_tpu.data import synthetic as jsyn
from ha2g_tpu.data import vocab as jvocab

from ha2g_torch import skeleton as psk
from ha2g_torch.data import dataset as pds
from ha2g_torch.data import loader as ploader
from ha2g_torch.data import storage as pstorage
from ha2g_torch.data import synthetic as psyn
from ha2g_torch.data import vocab as pvocab
from ha2g_torch.utils.average_meter import AverageMeter

SKELETONS = ("ted_gesture", "ted_expressive")
FIELDS = ("text", "word_seq", "word_lengths", "pose", "target", "audio",
          "spec", "vids")


def _assert_clips_equal(a_clips, b_clips):
    assert len(a_clips) == len(b_clips)
    for a, b in zip(a_clips, b_clips):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def _need_native_engines():
    from ha2g_torch import native as pnative
    from ha2g_tpu import native as jnative
    if not pnative.available():
        pytest.skip("no g++ on the PATH")
    if not jnative.available():
        pytest.skip("the JAX package's engine did not build")


def _speakers(module, clips):
    speaker = module.Vocab("vid", insert_default_tokens=False)
    for c in clips:
        speaker.index_word(c["vid"])
    return speaker


@pytest.mark.parametrize("use_native", (False, True),
                         ids=("numpy", "native"))
@pytest.mark.parametrize("name", SKELETONS)
def test_synthetic_clips_and_windows_equal_jax(name, use_native):
    """The same seed gives the same clips, vocabulary and windowed
    samples, bit for bit, through the numpy windowing path and through
    the native engine (the same source built with the same flags in both
    packages)."""
    if use_native:
        _need_native_engines()
    jspec, pspec = jsk.SKELETONS[name], psk.SKELETONS[name]
    np.testing.assert_array_equal(psyn.default_mean_dir_vec(pspec),
                                  jsyn.default_mean_dir_vec(jspec))
    jc = jsyn.synthetic_clips(jspec, n_clips=3, seed=5)
    pc = psyn.synthetic_clips(pspec, n_clips=3, seed=5)
    _assert_clips_equal(jc, pc)
    jlang = jvocab.build_vocab("words", [jc])
    plang = pvocab.build_vocab("words", [pc])
    assert plang.word2index == jlang.word2index
    assert plang.n_words == jlang.n_words
    mean_vec = jsyn.default_mean_dir_vec(jspec)
    mean_pose = np.zeros(jspec.n_joints * 3, np.float32)
    static = (6, 7) if name == "ted_expressive" else (6, 9)
    want = jds.window_clips(jc, jspec, jlang, _speakers(jvocab, jc),
                            mean_pose, mean_vec, static_joints=static,
                            use_native=use_native)
    got = pds.window_clips(pc, pspec, plang, _speakers(pvocab, pc),
                           mean_pose, mean_vec, static_joints=static,
                           use_native=use_native)
    assert len(got) == len(want) > 10
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_resample_and_motion_filter_equal_jax():
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(50, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(pds.resample_pose_seq(poses, 4.0, 15),
                                  jds.resample_pose_seq(poses, 4.0, 15))
    mean = np.zeros(30, np.float32)
    for skel in (poses, np.zeros_like(poses), poses * 1e-3):
        assert pds.MotionFilter(mean).check(skel) == \
            jds.MotionFilter(mean).check(skel)


def test_vocab_files_cross_load(tmp_path):
    """A vocabulary saved by one package loads in the other (words,
    specials, counts, the speaker table's n_words quirk)."""
    words = ["hello", "world", "hello", "gesture"]
    for src, dst in ((jvocab, pvocab), (pvocab, jvocab)):
        for specials in (True, False):
            v = src.Vocab("words", insert_default_tokens=specials)
            v.index_words_from_list(words)
            path = tmp_path / f"{src.__name__}_{specials}.json"
            v.save(path)
            w = dst.Vocab.load(path)
            assert w.to_dict() == v.to_dict()
            assert w.word2index == v.word2index
            assert w.get_word_index("unseen") == 3
    assert pvocab.normalize_string(" Hello, World!? It's ") == \
        jvocab.normalize_string(" Hello, World!? It's ")
    v = pvocab.Vocab("words")
    v.index_words_from_list(words)
    v.random_word_vectors(8, seed=3)
    j = jvocab.Vocab("words")
    j.index_words_from_list(words)
    j.random_word_vectors(8, seed=3)
    np.testing.assert_array_equal(v.word_embedding_weights,
                                  j.word_embedding_weights)
    np.save(tmp_path / "vec.npy", v.word_embedding_weights)
    v.load_word_vectors(tmp_path / "vec.npy", 8)
    with pytest.raises(FileNotFoundError, match="vec.bin"):
        v.load_word_vectors(tmp_path / "vec.bin", 8)


def test_clip_stores_cross_load(tmp_path):
    """clips.json + clips.npz written by one package load in the other,
    with a stored spectrogram (float16 on disk) and without."""
    clips = psyn.synthetic_clips(psk.TED_GESTURE, n_clips=2, seed=2)
    clips[1]["audio_spec"] = np.random.default_rng(0).normal(
        size=(128, 40)).astype(np.float32)
    pstorage.save_clips(tmp_path / "p", clips)
    jstorage.save_clips(tmp_path / "j", clips)
    _assert_clips_equal(jstorage.load_clips(tmp_path / "p"),
                        pstorage.load_clips(tmp_path / "p"))
    _assert_clips_equal(pstorage.load_clips(tmp_path / "j"),
                        jstorage.load_clips(tmp_path / "j"))
    assert json.loads((tmp_path / "p" / "clips.json").read_text()) == \
        json.loads((tmp_path / "j" / "clips.json").read_text())


def _index_samples(n):
    """Samples whose vids are their own index."""
    z = np.zeros
    return pds.WindowedSamples(
        text=z((n, 4), np.int32), word_seq=z((n, 2), np.int32),
        word_lengths=z(n, np.int32), pose=z((n, 4, 3), np.float32),
        target=np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3),
        audio=z((n, 5), np.float32), spec=z((n, 2, 3), np.float32),
        vids=np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("shuffle,drop_last", ((True, True), (True, False),
                                               (False, False)))
def test_batch_loader_order_equals_jax(shuffle, drop_last):
    """Two epochs of the port's loader give JAX's index order for a seed;
    drop_last and keys as JAX's; a CPU device gives CPU tensors."""
    s = _index_samples(23)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7,
              keys=("vids", "target"))
    jl = jloader.BatchLoader(s, 5, prefetch=0, **kw)
    pl = ploader.BatchLoader(s, 5, **kw)
    tl = ploader.BatchLoader(s, 5, device="cpu", **kw)
    assert len(pl) == len(jl) == (4 if drop_last else 5)
    for _ in range(2):
        want = [b["vids"] for b in jl]
        got = [b["vids"] for b in pl]
        tens = list(tl)
        assert len(got) == len(want) == len(tens)
        for w, g, t in zip(want, got, tens):
            np.testing.assert_array_equal(g, w)
            assert set(t) == {"vids", "target"}
            assert isinstance(t["vids"], torch.Tensor)
            np.testing.assert_array_equal(t["vids"].numpy(), w)
            np.testing.assert_array_equal(t["target"].numpy(),
                                          s.target[w])
    assert pl.batch_bytes() == 5 * (4 + 6 * 4)


def test_average_meter():
    m = AverageMeter("loss")
    m.update(2.0, 3)
    m.update(4.0)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 10.0, 4, 2.5)
    assert str(m) == "loss 4.0000 (2.5000)"
