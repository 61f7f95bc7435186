"""Dataset statistics (the port of ha2g_tpu/tools.py; reference
calculate_motion_stats.py and calculate_angle_stats.py):

* ``motion_stats``: the mean pose, mean unit direction vector and mean
  bone lengths over clips, the constants the YAML configs carry
  (calculate_motion_stats.py:12-51);
* ``angle_stats``: each angle pair's mean, variance and mean frame-to-frame
  change over windowed targets, the physical prior's constants in
  ``skeleton.py`` (calculate_angle_stats.py:39-197);
* ``librosa_golden_signals`` / ``make_librosa_goldens``: the fixture
  signals of the DSP parity protocol and their mel / onset goldens
  computed by librosa itself, imported inside the function only (neither
  the port nor its tests need librosa; the command fails without it, as
  the JAX package's does).
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from ha2g_torch.data.dataset import resample_pose_seq
from ha2g_torch.skeleton import SkeletonSpec


def motion_stats(clips: Iterable[dict], spec: SkeletonSpec,
                 fps: int = 15) -> dict:
    """-> mean_pose (n_joints*3), mean_dir_vec (n_bones*3) of unit vectors,
    mean bone lengths from the raw skeletons, and the frames counted."""
    pose_sum = np.zeros((spec.n_joints, 3))
    unit_sum = np.zeros((spec.n_bones, 3))
    len_sum = np.zeros(spec.n_bones)
    n = 0
    for clip in clips:
        skel = resample_pose_seq(
            np.asarray(clip["skeletons_3d"], np.float32),
            clip["end_time"] - clip["start_time"], fps)
        skel = skel.reshape(len(skel), spec.n_joints, 3)
        d = skel[:, spec.children] - skel[:, spec.parents]
        norm = np.linalg.norm(d, axis=-1)
        unit = d / np.maximum(norm[..., None], 1e-12)
        pose_sum += skel.sum(0)
        unit_sum += unit.sum(0)
        len_sum += norm.sum(0)
        n += len(skel)
    return {"mean_pose": (pose_sum / n).reshape(-1),
            "mean_dir_vec": (unit_sum / n).reshape(-1),
            "mean_bone_lengths": len_sum / n,
            "n_frames": n}


def angle_stats(targets: np.ndarray, mean_dir_vec: np.ndarray,
                spec: SkeletonSpec) -> dict:
    """targets: (N, T, pose_dim) mean-subtracted direction vectors ->
    avg_angle / var_angle / change_angle of each pair of the prior over
    the extended (cross-product) vector set, angles in units of pi."""
    prior = spec.angle_prior
    if prior is None:
        raise ValueError(f"{spec.name} has no angle prior")
    raw = targets + mean_dir_vec.reshape(1, 1, -1)
    vecs = spec.extended_dir_vecs(torch.from_numpy(
        np.ascontiguousarray(raw, np.float32))).numpy()
    i = np.asarray([p[0] for p in prior.pairs])
    j = np.asarray([p[1] for p in prior.pairs])
    inner = np.clip(np.einsum("btpd,btpd->btp", vecs[:, :, i],
                              vecs[:, :, j]), -1.0, 1.0)
    angle = np.arccos(inner) / math.pi            # (N, T, P)
    flat = angle.reshape(-1, angle.shape[-1])
    return {"avg_angle": flat.mean(0), "var_angle": flat.var(0),
            "change_angle": np.abs(np.diff(angle, axis=1)).mean((0, 1))}


def librosa_golden_signals(sr: int = 16000) -> dict[str, np.ndarray]:
    """The deterministic fixture signals of the goldens (4 s each): a click
    train, a chirp, band-limited noise, speech-like AM noise and silence
    with bursts, the cases that exercise the mel triangles' edges, the dB
    floor and onset peak picking."""
    rng = np.random.default_rng(20260816)
    t = np.arange(4 * sr) / sr
    sig = {}
    clicks = np.zeros(4 * sr, np.float32)
    clicks[(np.arange(8) * 0.5 * sr + 0.25 * sr).astype(int)] = 1.0
    sig["clicks"] = clicks
    sig["chirp"] = np.sin(
        2 * np.pi * (200 * t + (3800 / 8.0) * t ** 2)).astype(np.float32)
    sig["noise"] = (rng.normal(size=4 * sr) * 0.3).astype(np.float32)
    am = (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
    sig["am_noise"] = (rng.normal(size=4 * sr) * am * 0.4).astype(np.float32)
    bursts = np.zeros(4 * sr, np.float32)
    for s0 in (0.5, 1.7, 2.9):
        i0 = int(s0 * sr)
        bursts[i0:i0 + sr // 10] = rng.normal(size=sr // 10) * 0.8
    sig["bursts"] = bursts
    return sig


def make_librosa_goldens(out_path: str) -> str:
    """The goldens of ``librosa_golden_signals`` computed by librosa
    (0.8.x, the version the reference pins): each signal's mel in dB, onset
    envelope and onset times, written to ``out_path`` (.npz).  Reference
    calls: scripts/utils/data_utils.py:34-38 (melspectrogram +
    power_to_db), scripts/train.py:440 (onset_detect)."""
    import librosa  # the goldens must come from librosa itself

    out: dict[str, np.ndarray] = {"librosa_version":
                                  np.str_(librosa.__version__)}
    for name, y in librosa_golden_signals().items():
        mel = librosa.feature.melspectrogram(
            y=y, sr=16000, n_fft=1024, hop_length=512, power=2)
        out[f"{name}/mel_db"] = librosa.power_to_db(mel, ref=np.max)
        out[f"{name}/onset_env"] = librosa.onset.onset_strength(y=y, sr=16000)
        out[f"{name}/onset_times"] = librosa.onset.onset_detect(
            y=y, sr=16000, units="time")
    np.savez(out_path, **out)
    return out_path
