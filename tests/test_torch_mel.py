"""The port's batched log-mel front-ends against ha2g_tpu.ops.mel and its
numpy oracle, with two clips of very different loudness so that a
batch-wide dB reference (instead of librosa's per-clip one) would fail."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu.ops import mel as jmel
from ha2g_torch.ops import mel as tmel
import tests.torch_cpu  # noqa: F401  (one torch thread)

# fp32 matrix products on both sides, summed in different orders; the dB
# scale magnifies relative error most in the quietest bins
ATOL_JAX = 2e-3
# against the float64 rfft oracle (the JAX package's own tolerance)
ATOL_NP = 2e-2


def _clips(seed=0, n=24000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    loud = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(size=n)
    quiet = 1e-3 * (np.sin(2 * np.pi * 1500 * t) + 0.3 * rng.normal(size=n))
    return np.stack([loud, quiet]).astype(np.float32)


def test_tables_equal_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    for a, b in zip(tmel.dft_basis(), jmel.dft_basis()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["float32", "int16", "mulaw"])
def test_batched_front_ends_match_jax(kind):
    audio = _clips()
    if kind == "float32":
        wire, want = audio, jmel.batched_log_mel(jnp.asarray(audio))
        got = tmel.batched_log_mel(torch.from_numpy(wire))
        ref_audio = audio
    elif kind == "int16":
        wire = (audio * 32767).astype(np.int16)
        want = jmel.batched_log_mel_i16(jnp.asarray(wire))
        got = tmel.batched_log_mel_i16(torch.from_numpy(wire))
        ref_audio = wire.astype(np.float32) / 32768.0
    else:
        wire = jmel.mulaw_encode_np(audio)
        want = jmel.batched_log_mel_mulaw(jnp.asarray(wire))
        got = tmel.batched_log_mel_mulaw(torch.from_numpy(wire))
        ref_audio = jmel.mulaw_decode_np(wire)
        np.testing.assert_allclose(tmel.mulaw_decode(torch.from_numpy(wire)),
                                   ref_audio, atol=1e-6, rtol=0)
    got = got.numpy()
    assert got.shape == (2, 128, audio.shape[1] // 512 + 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)
    for i in range(2):
        # each clip is referenced to its own peak: 0 dB max, -80 dB floor
        assert got[i].max() == 0.0 and got[i].min() >= -80.0
        np.testing.assert_allclose(got[i], jmel.log_mel_np(ref_audio[i]),
                                   atol=ATOL_NP, rtol=0)
