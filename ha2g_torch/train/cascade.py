"""Coarse-to-fine hierarchy cascade driven by SkeletonSpec routing tables
(reference train_hierarchy.py:100-117, train_hierarchy_expressive.py:
155-213)."""

from __future__ import annotations

from typing import Sequence

import torch

from ha2g_torch.skeleton import SkeletonSpec


def build_pre_seq(level_target: torch.Tensor, prev_out, level: int,
                  spec: SkeletonSpec, n_pre: int) -> torch.Tensor:
    """pre_seq for one level: the first n_pre frames are the level target
    plus a constraint bit of 1; later frames hold the previous level's
    output copied to this level's bone columns (zeros for level 0).  The
    routing is one-to-one, so an indexed copy moves the values exactly;
    its index tensors are the spec's, uploaded once a device
    (``SkeletonSpec.on_device``)."""
    B, T, D = level_target.shape
    pre = level_target.new_zeros((B, T, D + 1))
    pre[:, :n_pre, :D] = level_target[:, :n_pre]
    pre[:, :n_pre, D] = 1.0
    if prev_out is not None:
        src, dst = spec.on_device("routing_indices", level - 1,
                                  level_target.device)
        pre[:, n_pre:, dst] = prev_out[:, n_pre:].index_select(-1, src) \
            .to(pre.dtype)
    return pre


def run_cascade(gens: Sequence, spec: SkeletonSpec, target: torch.Tensor,
                in_text: torch.Tensor, blend_feats: torch.Tensor,
                vid_indices: torch.Tensor, n_pre: int,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
    """Run all hierarchy levels.

    gens[l]: the level-l HierarchicalPoseGenerator.
    target: (B, T, pose_dim) dir vecs; only its level slices and first
        n_pre frames are read.
    blend_feats: (L, B, T, 32) speaker-blended audio features.
    Returns (outs per level, targets per level, z, mu, logvar of the last
    level).
    """
    outs, targets = [], []
    prev = None
    z = mu = logvar = None
    for level in range(spec.n_levels):
        t_l = spec.extract_level_target(target, level)
        pre = build_pre_seq(t_l, prev, level, spec, n_pre)
        out, z, mu, logvar = gens[level](pre, in_text, blend_feats[level],
                                         vid_indices, dtype, generator)
        outs.append(out)
        targets.append(t_l)
        prev = out
    return outs, targets, z, mu, logvar
