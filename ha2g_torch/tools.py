"""Dataset statistics (the port of ha2g_tpu/tools.py; reference
calculate_motion_stats.py and calculate_angle_stats.py):

* ``motion_stats``: the mean pose, mean unit direction vector and mean
  bone lengths over clips, the constants the YAML configs carry
  (calculate_motion_stats.py:12-51);
* ``angle_stats``: each angle pair's mean, variance and mean frame-to-frame
  change over windowed targets, the physical prior's constants in
  ``skeleton.py`` (calculate_angle_stats.py:39-197).

The librosa goldens of the JAX package (``make_librosa_goldens``) are not
ported: they need librosa.
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
