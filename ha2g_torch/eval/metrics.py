"""MAJE, acceleration difference and beat consistency (the port of
ha2g_tpu/eval/metrics.py; reference train.py:423-479 and
train_expressive.py:538-573).

* MAJE + accel: forward kinematics of the mean-added direction vectors,
  mean |joint error| over the frames after the seed poses, and the mean
  |second finite difference| gap.
* Beat consistency: motion beats are local minima of the normalised summed
  angle-change signal; audio beats come from onset detection; the score is
  the mean Gaussian kernel (sigma 0.1) of each onset's distance to its
  nearest motion beat.
* Audio onsets: librosa 0.8's onset_strength / onset_detect defaults in
  numpy, float64.

numpy on the host throughout, except forward kinematics and the extended
direction vectors, which are the port's torch versions on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ha2g_torch.ops.mel import mel_filterbank
from ha2g_torch.skeleton import SkeletonSpec


def _fk(spec: SkeletonSpec, dir_vec: np.ndarray) -> np.ndarray:
    return spec.dir_vec_to_pose(
        torch.from_numpy(np.ascontiguousarray(dir_vec, np.float32))).numpy()


def maje_and_accel(out_dir_vec: np.ndarray, target_dir_vec: np.ndarray,
                   mean_dir_vec: np.ndarray, spec: SkeletonSpec,
                   n_pre_poses: int = 4) -> tuple[float, float]:
    """(B, T, pose_dim) mean-subtracted direction vectors -> (joint MAE,
    accel difference)."""
    out = out_dir_vec + mean_dir_vec.reshape(1, 1, -1)
    tgt = target_dir_vec + mean_dir_vec.reshape(1, 1, -1)
    out_pos, tgt_pos = _fk(spec, out), _fk(spec, tgt)
    diff = out_pos[:, n_pre_poses:] - tgt_pos[:, n_pre_poses:]
    mae = float(np.mean(np.abs(diff)))
    accel = float(np.mean(np.abs(np.diff(tgt_pos, n=2, axis=1) -
                                 np.diff(out_pos, n=2, axis=1))))
    return mae, accel


# ---------------------------------------------------------------------------
# audio onsets (librosa 0.8 semantics)
# ---------------------------------------------------------------------------

def onset_strength(y: np.ndarray, sr: int = 16000, n_fft: int = 2048,
                   hop: int = 512, n_mels: int = 128) -> np.ndarray:
    """Spectral-flux onset envelope: positive first difference of the
    log-mel spectrogram, mean over bands, lag-compensated."""
    yp = np.pad(y.astype(np.float64), (n_fft // 2, n_fft // 2),
                mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop]
    frames = frames[:n_frames] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    s_db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    s_db = np.maximum(s_db, s_db.max() - 80.0)
    diff = np.maximum(0.0, s_db[1:] - s_db[:-1])  # lag 1
    env = np.mean(diff, axis=1)
    # librosa pads 1 + n_fft // (2 * hop) frames at the start and trims
    pad = 1 + n_fft // (2 * hop)
    return np.concatenate([np.zeros(pad), env])[:n_frames]


def onset_detect_times(y: np.ndarray, sr: int = 16000,
                       hop: int = 512) -> np.ndarray:
    """librosa.onset.onset_detect(units='time'): the normalised envelope,
    peak-picked with the library's default windows."""
    env = onset_strength(y, sr=sr, hop=hop)
    if env.max() > 0:
        env = env / env.max()
    t2f = lambda t: int(np.floor(t * sr / hop))
    pre_max, post_max = t2f(0.03), t2f(0.0) + 1
    pre_avg, post_avg = t2f(0.10), t2f(0.10) + 1
    wait, delta = t2f(0.03), 0.07

    n = len(env)
    peaks = []
    last = -1 - wait
    for i in range(n):
        lo, hi = max(0, i - pre_max), min(n, i + post_max)
        if env[i] != env[lo:hi].max():
            continue
        lo_a, hi_a = max(0, i - pre_avg), min(n, i + post_avg)
        if env[i] < env[lo_a:hi_a].mean() + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks) * hop / sr


# ---------------------------------------------------------------------------
# beat consistency
# ---------------------------------------------------------------------------

def motion_beat_times(out_dir_vec: np.ndarray, mean_dir_vec: np.ndarray,
                      spec: SkeletonSpec, fps: int = 15,
                      thres: float = 0.03) -> list[np.ndarray]:
    """Per-sample motion beat times from the normalised angle-change
    signal (train.py:424-448).  out_dir_vec: (B, T, pose_dim)."""
    prior = spec.angle_prior
    if prior is None or not prior.change:
        raise ValueError(f"{spec.name} has no angle-change table")
    B, T, _ = out_dir_vec.shape
    raw = out_dir_vec + mean_dir_vec.reshape(1, 1, -1)
    vecs = spec.extended_dir_vecs(
        torch.from_numpy(np.ascontiguousarray(raw, np.float32))).numpy()
    i = np.asarray([p[0] for p in prior.pairs])
    j = np.asarray([p[1] for p in prior.pairs])
    inner = np.clip(np.einsum("btpd,btpd->btp", vecs[:, :, i], vecs[:, :, j]),
                    -1.0, 1.0)
    angle = np.arccos(inner) / math.pi                      # (B, T, P)
    change = np.asarray(prior.change)
    d = np.abs(angle[:, 1:] - angle[:, :-1]) / change / len(change)
    angle_diff = np.concatenate([np.zeros((B, 1)), d.sum(-1)], axis=1)

    beats = []
    for b in range(B):
        ts = []
        for t in range(2, T - 1):
            if angle_diff[b, t] < angle_diff[b, t - 1] and \
                    angle_diff[b, t] < angle_diff[b, t + 1]:
                if (angle_diff[b, t - 1] - angle_diff[b, t] >= thres or
                        angle_diff[b, t + 1] - angle_diff[b, t] >= thres):
                    ts.append(t / fps)
        beats.append(np.asarray(ts))
    return beats


def beat_consistency(out_dir_vec: np.ndarray, audio: np.ndarray,
                     mean_dir_vec: np.ndarray, spec: SkeletonSpec,
                     fps: int = 15, sigma: float = 0.1,
                     thres: float = 0.03) -> tuple[float, int]:
    """-> (mean Gaussian-kernel alignment of the audio onsets to their
    nearest motion beat, number of onsets), for AverageMeter-style
    accumulation (train.py:449-455)."""
    beats = motion_beat_times(out_dir_vec, mean_dir_vec, spec, fps, thres)
    total, count = 0.0, 0
    for b in range(out_dir_vec.shape[0]):
        if len(beats[b]) == 0:
            continue
        onset_times = onset_detect_times(audio[b])
        if len(onset_times) == 0:
            continue
        s = sum(math.exp(-np.min((t - beats[b]) ** 2) / (2 * sigma * sigma))
                for t in onset_times)
        total += s
        count += len(onset_times)
    return (total / count if count else 0.0), count
