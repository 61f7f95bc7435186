"""The port's native window engine (``ha2g_torch/native``): bit for bit
the JAX package's engine on the same clips (the same source, built with
the same compiler and flags), within 2e-5 of the port's numpy windowing
path (as tests/test_native.py holds the JAX engine), the default
selection of ``window_clips``, and a build that fails raises, once built
and on every later call."""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import native
from ha2g_torch.data import dataset as pds
from ha2g_torch.data.synthetic import default_mean_dir_vec, synthetic_clips
from ha2g_torch.data.vocab import Vocab, build_vocab
from ha2g_torch.skeleton import SKELETONS

SAMPLE_FIELDS = ("text", "word_seq", "word_lengths", "pose", "target",
                 "audio", "spec", "vids")


@pytest.fixture(autouse=True)
def _engine():
    if not native.available():
        pytest.skip("no g++ on the PATH")


def _clips(name, seed):
    clips = synthetic_clips(SKELETONS[name], n_clips=3, clip_seconds=8.0,
                            seed=seed)
    # a still clip: the motion filter rejects every window of it
    clips[1]["skeletons_3d"] = np.repeat(clips[1]["skeletons_3d"][:1],
                                         len(clips[1]["skeletons_3d"]), 0)
    return clips


@pytest.mark.parametrize("name", sorted(SKELETONS))
def test_engine_bit_equal_to_jax_engine(name):
    from ha2g_tpu import native as jnative
    from ha2g_tpu.skeleton import SKELETONS as JSKELETONS
    if not jnative.available():
        pytest.skip("the JAX package's engine did not build")
    spec = SKELETONS[name]
    mdv = default_mean_dir_vec(spec)
    mp = np.zeros(spec.n_joints * 3, np.float32)
    static = (6, 7) if name == "ted_expressive" else (6, 9)
    n_windows = 0
    for clip in _clips(name, 5):
        args = (clip["skeletons_3d"], 8.0, 15)
        rest = (mdv, mp, 34, 42, 10, static)
        got = native.window_clip_native(*args, spec, *rest)
        want = jnative.window_clip_native(*args, JSKELETONS[name], *rest)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        n_windows += len(got[0])
    assert n_windows > 10


@pytest.mark.parametrize("name", sorted(SKELETONS))
def test_window_clips_engine_against_numpy_and_default(name, monkeypatch):
    spec = SKELETONS[name]
    clips = _clips(name, 7)
    lang = build_vocab("words", [clips])
    speaker = Vocab("vid", insert_default_tokens=False)
    for c in clips:
        speaker.index_word(c["vid"])
    kw = dict(spec=spec, lang=lang, speaker=speaker,
              mean_pose=np.zeros(spec.n_joints * 3, np.float32),
              mean_dir_vec=default_mean_dir_vec(spec),
              static_joints=(6, 7) if name == "ted_expressive" else (6, 9))
    a = pds.window_clips(clips, use_native=True, **kw)
    b = pds.window_clips(clips, use_native=False, **kw)
    assert len(a) == len(b) > 10
    np.testing.assert_allclose(a.target, b.target, atol=2e-5, rtol=0)
    np.testing.assert_allclose(a.pose, b.pose, atol=1e-6, rtol=0)
    for f in ("text", "word_seq", "word_lengths", "audio", "spec", "vids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    # the default: the engine where it is available, numpy where not
    d = pds.window_clips(clips, **kw)
    for f in SAMPLE_FIELDS:
        assert getattr(d, f).tobytes() == getattr(a, f).tobytes(), f
    monkeypatch.setattr(native, "available", lambda: False)
    d = pds.window_clips(clips, **kw)
    for f in SAMPLE_FIELDS:
        assert getattr(d, f).tobytes() == getattr(b, f).tobytes(), f


def test_failed_build_raises_and_no_compiler_falls_back(tmp_path,
                                                        monkeypatch):
    broken = tmp_path / "window_engine.cpp"
    broken.write_text("extern \"C\" int window_clip( { }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    runs = []
    real_run = native.subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: runs.append(a) or real_run(*a, **k))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))
    # later calls raise the same error without running g++ again
    for call in (native.available, lambda: pds.window_clips(
            [], None, None, None, None, None, use_native=None)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    assert len(runs) == 1

    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="unavailable"):
        native.window_clip_native(np.zeros((30, 10, 3), np.float32), 2.0,
                                  15, SKELETONS["ted_gesture"],
                                  np.zeros(27), np.zeros(30), 34, 42, 10)
