"""The port's live stream (ha2g_torch.synthesis.GestureStream) on the
CPU in fp32, mirroring tests/test_streaming.py: against the JAX stream on
the same chunks (1e-4), against the port's own batch path under any
chunking, with the length unknown, for a clip of one window, and for
int16 / mu-law chunks; and fade_out_to_mean against the JAX package's
(1e-6).

Stream against the port's batch path: the stream frames each segment of
the audio with its own DFT product, whose row count differs from the
whole clip's, and the CPU's sgemm sums a row in another order for another
row count; so a frame may differ from the batch path's in its last bits
(1-4 ulps), and the running maximum and the network carry that on.
Measured on the CPU over 47 random cuttings of 3-7 s clips: frames
within 1.7e-5 dB (of values up to ~31 dB), poses within 3.3e-5.
STREAM_VS_BATCH is 1e-4: three times that, and half the JAX package's
own 2e-4 between its stream and its batch path.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.synthesis import HierarchySynthesizer as JaxSynthesizer
from ha2g_tpu.synthesis import fade_out_to_mean as jax_fade_out
from tests.test_torch_bridge import (N_SPK, T, jax_hierarchy, jax_state_dict,
                                     port_config, vocabs)
from tests.torch_serving import no_thread_outlives_module  # noqa: F401

from ha2g_torch.ops.mel import log_mel_abs, mulaw_encode_np
from ha2g_torch.synthesis import (_window_layout, fade_out_to_mean,
                                  make_synthesizer)
from ha2g_torch.train.hierarchy import HierarchySystem

SR = 16000
# port stream against the JAX stream: fp32 in two frameworks
ATOL = 1e-4
# port stream against the port's batch path (see the module docstring)
STREAM_VS_BATCH = 1e-4


def _synths(dataset="ted_gesture", pose_dim=27):
    """-> (JAX synthesizer, port synthesizer, JAX lang, port lang) with the
    same parameters."""
    _, system, state = jax_hierarchy(dataset, pose_dim)
    port = HierarchySystem(port_config(dataset, pose_dim), 16, N_SPK,
                           device="cpu")
    (jlang, _), (lang, _) = vocabs()
    return (JaxSynthesizer(system, state),
            make_synthesizer(port, jax_state_dict(state)), jlang, lang)


@pytest.fixture(scope="module")
def synths():
    return _synths()


def _clip(seconds=6.0, seed=3):
    """Audio whose loudest mel frame is in the first window (a click at
    0.5 s), so the running dB reference is the whole clip's from window 0
    on, and words every 0.4 s."""
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=int(seconds * SR)) * 0.05).astype(np.float32)
    audio[8000:8640] += np.sin(np.arange(640) * 0.7).astype(np.float32)
    words = [(f"w{rng.integers(0, 10)}", float(t), float(t + 0.2))
             for t in np.arange(0.2, seconds - 0.3, 0.4)]
    return audio, words


def _run(stream, audio, cuts, words):
    stream.feed(words=words)
    outs, prev = [], 0
    for c in list(cuts) + [len(audio)]:
        outs.append(stream.feed(audio[prev:c]))
        prev = c
    outs.append(stream.finish())
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("dataset,pose_dim", [("ted_gesture", 27),
                                              ("ted_expressive", 126)])
def test_stream_matches_the_jax_stream(dataset, pose_dim):
    jsynth, synth, jlang, lang = _synths(dataset, pose_dim)
    audio, words = _clip(4.5, seed=21)
    cuts = [4800, 36800, 37600, 60000]
    want = _run(jsynth.stream(jlang, vid=1, total_seconds=4.5), audio, cuts,
                words)
    got = _run(synth.stream(lang, vid=1, total_seconds=4.5), audio, cuts,
               words)
    assert got.shape == want.shape == (T + 2 * (T - 4), pose_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stream_matches_the_batch_path_known_total(synths):
    """Known length and an early peak: the stream equals ``generate``,
    speaker-z noise included (drawn from a generator of the same seed in
    the same order), and its frames equal the whole clip's transform."""
    _, synth, _, lang = synths
    audio, words = _clip(6.0)
    g = lambda: torch.Generator().manual_seed(7)
    want = synth.generate(audio[None], [words], lang, np.asarray([2]),
                          g())[0]
    stream = synth.stream(lang, vid=2, total_seconds=6.0, generator=g())
    got, t0, pos = [], 0.0, 0
    for c in [0.3, 1.9, 0.05, 2.2, 1.0, 0.55]:
        n = int(c * SR)
        got.append(stream.feed(audio[pos:pos + n],
                               words=[x for x in words
                                      if t0 <= x[1] < t0 + c]))
        pos, t0 = pos + n, t0 + c
    got.append(stream.finish())
    got = np.concatenate(got, axis=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STREAM_VS_BATCH, rtol=0)
    frames = log_mel_abs(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(stream._frames, frames, atol=STREAM_VS_BATCH,
                               rtol=0)


def test_stream_random_chunking_fuzz(synths):
    """Any cut of the audio (one-sample and many-window chunks) gives the
    batch path's output."""
    _, synth, _, lang = synths
    for seed in (13, 17, 29):
        rng = np.random.default_rng(seed)
        seconds = float(rng.uniform(3.0, 7.0))
        audio, words = _clip(seconds, seed=seed)
        want = synth.generate(audio[None], [words], lang,
                              np.asarray([seed % N_SPK]))[0]
        cuts = np.sort(rng.integers(1, len(audio), rng.integers(2, 9)))
        cuts[0] = 1
        got = _run(synth.stream(lang, vid=seed % N_SPK,
                                total_seconds=seconds), audio, cuts, words)
        assert got.shape == want.shape, seed
        np.testing.assert_allclose(got, want, atol=STREAM_VS_BATCH, rtol=0,
                                   err_msg=f"seed {seed}")


def test_stream_emits_while_audio_arrives_and_unknown_length(synths):
    """Window 0's frames come once its audio is in; with the length
    unknown the layout is sample-exact, with the batch path's frame
    count."""
    _, synth, _, lang = synths
    audio, words = _clip(5.0, seed=9)
    stream = synth.stream(lang, vid=1, total_seconds=5.0)
    need = (stream._s0(0) + stream.spec_len) * 512
    assert stream.feed(audio[:need - 1], words=words).shape == (0, 27)
    assert stream.feed(audio[need - 1:need]).shape == (T - 4, 27)
    live = synth.stream(lang, vid=0)
    out = np.concatenate([live.feed(audio[:40000], words=words),
                          live.feed(audio[40000:]), live.finish()])
    _, _, num = _window_layout(synth.cfg, 5.0)
    assert out.shape == (T + (num - 1) * (T - 4), 27)
    assert np.isfinite(out).all()
    with pytest.raises(RuntimeError, match="finished"):
        live.feed(audio[:10])


def test_stream_short_clips(synths):
    """A clip under one window runs as one edge-padded window at finish,
    as the batch path does; under 512 samples nothing comes out."""
    _, synth, _, lang = synths
    audio, words = _clip(1.5, seed=5)
    want = synth.generate(audio[None], [words], lang, np.asarray([1]))[0]
    stream = synth.stream(lang, vid=1, total_seconds=1.5)
    got = np.concatenate([stream.feed(audio, words=words), stream.finish()])
    assert got.shape == want.shape == (T, 27)
    np.testing.assert_allclose(got, want, atol=STREAM_VS_BATCH, rtol=0)
    tiny = synth.stream(lang, vid=0)
    assert tiny.feed(audio[:400]).shape == (0, 27)
    assert tiny.finish().shape == (0, 27)


def test_stream_compact_pcm_chunks(synths):
    """int16 and mu-law chunks are decoded on the host to the float
    stream of the same samples."""
    _, synth, _, lang = synths
    audio, words = _clip(3.0, seed=11)
    i16 = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    mu = mulaw_encode_np(audio)

    def run(x, cut=20000):
        s = synth.stream(lang, vid=3, total_seconds=3.0)
        return np.concatenate([s.feed(x[:cut], words=words),
                               s.feed(x[cut:]), s.finish()])

    from ha2g_torch.ops.mel import pcm_to_float_np
    np.testing.assert_array_equal(run(i16), run(pcm_to_float_np(i16)))
    np.testing.assert_array_equal(run(mu), run(pcm_to_float_np(mu)))
    assert np.abs(run(i16) - run(audio)).max() < 2e-2


def test_fade_out_matches_jax(synths):
    """fade_out_to_mean against the JAX package's within 1e-6 (a hierarchy
    has no end padding: the fade appends 2 * n_pre_poses frames), and
    ``generate(fade_out=True)`` is ``generate`` followed by it."""
    jsynth, synth, _, lang = synths
    rng = np.random.default_rng(4)
    for pad_s in (0.0, 0.4):
        poses = rng.normal(size=(64, 27)).astype(np.float32)
        want = jax_fade_out(poses.copy(), jsynth.cfg, pad_s)
        got = fade_out_to_mean(poses.copy(), synth.cfg, pad_s)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    audio, words = _clip(3.0, seed=2)
    plain = synth.generate(audio[None], [words], lang, np.asarray([0]))
    faded = synth.generate(audio[None], [words], lang, np.asarray([0]),
                           fade_out=True)
    assert faded.shape == (1, plain.shape[1] + 2 * synth.cfg.n_pre_poses, 27)
    np.testing.assert_array_equal(
        faded[0], fade_out_to_mean(plain[0].copy(), synth.cfg, 0.0))
