"""Log-mel front-end as matrix products.

librosa's ``melspectrogram(sr=16000, n_fft=1024, hop_length=512, power=2)``
followed by ``power_to_db(ref=np.max)`` (reference data_utils.py:34-38),
batched over clips: with hop = n_fft/2 the frames are two shifted reshape
views of the reflect-padded signal, the STFT is one product against a
window-folded DFT basis and the mel projection a second one.

``power_to_db`` references every clip to its OWN maximum, as librosa does
on one clip at a time; a batch-wide maximum would make each clip's
features depend on the loudest clip in the batch.

``log_mel_abs`` is the log-mel before that reference, for the live stream
(``synthesis.GestureStream``), which applies a running reference of its
own; with ``center=False`` it frames a hop-aligned segment as it is, so a
segment with real context on both sides gives the frames of the whole
clip's transform.  Both paths compute frames with one function
(``_mel_power``).  ``mulaw_encode_np`` / ``mulaw_decode_np`` /
``pcm_to_float_np`` are the host-side codecs of the compact wire formats.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
N_FFT = 1024
HOP = 512
N_MELS = 128
_MULAW_MU = 255.0


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = f_sp * m
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(1 + n_fft//2, n_mels) slaney-normalized triangular filterbank,
    equal to librosa.filters.mel(htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@lru_cache(maxsize=None)
def dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT bases: (n_fft, 1 + n_fft//2) cos and -sin with
    a periodic hann window baked in, so STFT = frames @ basis."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


@lru_cache(maxsize=8)
def _bases(device: torch.device):
    """The DFT bases and filterbank as one (n_fft, 2*bins) basis and a
    (bins, n_mels) projection, uploaded once per device."""
    cos_b, sin_b = dft_basis(N_FFT)
    basis = torch.from_numpy(np.concatenate([cos_b, sin_b], axis=1))
    fb = torch.from_numpy(mel_filterbank(SR, N_FFT, N_MELS))
    return basis.to(device), fb.to(device)


def log_mel_np(y: np.ndarray, n_fft: int = N_FFT, hop: int = HOP,
               n_mels: int = N_MELS) -> np.ndarray:
    """One clip's log-mel (n_mels, n_frames) in numpy, float64 FFT: the
    windowing pipeline's spectrogram of a clip that has none stored."""
    yp = np.pad(y.astype(np.float64), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.stack([yp[i * hop: i * hop + n_fft] * window
                       for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(SR, n_fft, n_mels).astype(np.float64)
    log_spec = 10.0 * np.log10(np.maximum(mel, 1e-10))
    log_spec -= log_spec.max()
    return np.maximum(log_spec, -80.0).T


def mulaw_encode_np(x: np.ndarray) -> np.ndarray:
    """float waveform in [-1, 1] -> uint8 G.711 mu-law bytes (the
    continuous-mu approximation), for clients and tests."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MULAW_MU * np.abs(x)) / np.log1p(_MULAW_MU)
    return ((y + 1.0) / 2.0 * _MULAW_MU + 0.5).astype(np.uint8)


def mulaw_decode_np(u8: np.ndarray) -> np.ndarray:
    """Host twin of ``mulaw_decode`` (the same formula)."""
    y = np.asarray(u8, np.uint8).astype(np.float32) * (2.0 / _MULAW_MU) - 1.0
    return np.sign(y) * (np.power(1.0 + _MULAW_MU, np.abs(y)) - 1.0) \
        / _MULAW_MU


def pcm_to_float_np(samples: np.ndarray) -> np.ndarray:
    """Any wire sample format to float32 on the host: int16 PCM (x/32768,
    the soundfile convention), uint8 mu-law, or float."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        return samples.astype(np.float32) / 32768.0
    if samples.dtype == np.uint8:
        return mulaw_decode_np(samples)
    return samples.astype(np.float32)


def mulaw_decode(u8: torch.Tensor) -> torch.Tensor:
    """uint8 G.711 mu-law bytes -> float32 waveform in [-1, 1]."""
    y = u8.to(torch.float32) * (2.0 / _MULAW_MU) - 1.0
    return torch.sign(y) * (torch.pow(1.0 + _MULAW_MU, y.abs()) - 1.0) \
        / _MULAW_MU


def _mel_power(y: torch.Tensor, center: bool) -> torch.Tensor:
    """(B, n_samples) float32 -> mel power (B, n_frames, n_mels).  With
    hop = n_fft / 2 a frame is two adjacent hop chunks; ``center`` pads
    n_fft / 2 reflected samples at both ends first (librosa center=True)."""
    B = y.shape[0]
    yp = F.pad(y[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0] \
        if center else y
    n_chunks = yp.shape[-1] // HOP
    chunks = yp[:, :n_chunks * HOP].reshape(B, n_chunks, HOP)
    frames = torch.cat([chunks[:, :-1], chunks[:, 1:]], dim=-1)
    basis, fb = _bases(y.device)
    ri = frames @ basis
    n_bins = fb.shape[0]
    re, im = ri[..., :n_bins], ri[..., n_bins:]
    return (re * re + im * im) @ fb


def batched_log_mel(y: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float32 -> (B, n_mels, n_frames) log-mel in dB,
    each clip referenced to its own maximum and floored 80 dB below it."""
    if y.dim() != 2:
        raise ValueError(f"expected (B, n_samples) audio, got {tuple(y.shape)}")
    mel = _mel_power(y.to(torch.float32), center=True)
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    log_spec = log_spec - log_spec.amax(dim=(1, 2), keepdim=True)
    return torch.clamp_min(log_spec, -80.0).transpose(1, 2)


def log_mel_abs(y: torch.Tensor, center: bool = True) -> torch.Tensor:
    """One clip's UN-referenced log-mel ``10 log10(max(mel, 1e-10))``:
    (n_samples,) -> (n_mels, n_frames) float32, without the per-clip
    maximum subtracted and without the 80 dB floor (JAX
    ops/mel.py::log_mel_abs)."""
    if y.dim() != 1:
        raise ValueError(f"expected (n_samples,) audio, got {tuple(y.shape)}")
    mel = _mel_power(y.to(torch.float32)[None], center=center)[0]
    return (10.0 * torch.log10(torch.clamp_min(mel, 1e-10))).T


def batched_log_mel_i16(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM variant, dequantized with the soundfile convention x/32768."""
    return batched_log_mel(pcm.to(torch.float32) / 32768.0)


def batched_log_mel_mulaw(u8: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law variant, decoded on the tensor's device."""
    return batched_log_mel(mulaw_decode(u8))
