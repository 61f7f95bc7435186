"""Loss functions of the hierarchy train step, the port of
ha2g_tpu/train/losses.py (reference scripts/train_eval/*).

* scaled Huber: torch ``smooth_l1_loss(x/beta, y/beta) * beta``;
* softmax contrastive on inverse-L2 similarity: rows L2-normalised here,
  then ``ops/contrastive.py::flash_contrastive`` (kernels B2-B4 on the
  card), so no (N, N) tensor exists on the card's path; under a mesh on
  the rows of every rank;
* speaker KLD, the diversity regulariser (its three stop-gradients), the
  ns-GAN pair, the physical angle prior and an L1 loss.

Every function takes and returns float32 (the train step casts at the
loss boundary).  Under a mesh (``parallel/mesh.py``) each rank holds its
rows of the global batch, and the gradients are averaged over the ranks
after the backward: a mean over the batch (Huber, KLD, the diversity
term, the GAN pair, the physical prior, L1) is then exact as a local
mean, since every rank holds as many rows; the contrastive loss gathers
its rows.
"""

from __future__ import annotations

import math

import torch

from ha2g_torch.ops.contrastive import flash_contrastive
from ha2g_torch.parallel.mesh import current_mesh
from ha2g_torch.skeleton import SkeletonSpec


def scaled_huber(pred, target, beta: float = 0.1, reduce: bool = True):
    """torch F.smooth_l1_loss(pred/beta, target/beta) * beta."""
    d = torch.abs(pred - target)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean() if reduce else loss


def _normalize_rows(x, eps: float):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=eps)


def softmax_contrastive(feat_a, feat_b, eps: float = 1e-8):
    """CE over inverse-L2 similarity with diagonal labels
    (SoftmaxContrastiveLoss, train_hierarchy.py:54-68).  feat_a, feat_b:
    (N, D) per-frame features, N = B*T.  Under a mesh the loss spans the
    global batch: both normalised sets are all-gathered with autograd, every
    rank computes the same global loss, and the gather's backward sums the
    ranks' cotangents, so the gradient average over the ranks gives the
    global loss's gradient (a gather that kept only the local rows' graph
    would give 1 / W of it).  The mesh is the one of the enclosing
    ``Mesh.part`` (every system's ``train_step`` runs inside it through
    ``distributed_step``): called outside it, the loss spans this rank's
    rows alone."""
    a = _normalize_rows(feat_a, eps).contiguous()
    b = _normalize_rows(feat_b, eps).contiguous()
    mesh = current_mesh()
    if mesh is not None:
        a, b = mesh.all_gather_rows(a), mesh.all_gather_rows(b)
    return flash_contrastive(a, b)


def speaker_kld(mu, logvar):
    """-0.5 mean(1 + logvar - mu^2 - e^logvar)  (train_gan.py:81)."""
    return -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))


def diversity_regularizer(out, out_rand, z, z_rand, beta: float = 0.05):
    """-(pose_l1 / z_l1) clamped at -1000 (train_gan.py:68-77).  The
    gradient flows only through ``out``: the other three are detached, as
    in the reference."""
    out_rand, z, z_rand = out_rand.detach(), z.detach(), z_rand.detach()
    pose_l1 = scaled_huber(out, out_rand, beta=beta, reduce=False)
    pose_l1 = pose_l1.sum(dim=(1, 2))                 # (B,)
    z_l1 = torch.abs(z - z_rand).mean(dim=1)          # (B,)
    div = -(pose_l1 / (z_l1 + 1e-5))
    return torch.clamp(div, min=-1000.0).mean()


def nsgan_d_loss(d_real, d_fake, eps: float = 1e-8):
    """-mean(log D(real) + log(1 - D(fake)))  (train_gan.py:41)."""
    return -torch.mean(torch.log(d_real + eps) + torch.log(1.0 - d_fake + eps))


def nsgan_g_loss(d_fake, eps: float = 1e-8):
    return -torch.mean(torch.log(d_fake + eps))


def physical_angle_prior(out_dir_vec, mean_dir_vec, spec: SkeletonSpec):
    """Gaussian prior over inter-bone angles (train_hierarchy.py:242-262,
    train_hierarchy_expressive.py:424-449).  out_dir_vec: (B, T, pose_dim)
    mean-subtracted prediction; mean_dir_vec: (pose_dim,)."""
    prior = spec.angle_prior
    if prior is None:
        raise ValueError(f"skeleton {spec.name} has no angle prior")
    raw = out_dir_vec + mean_dir_vec[None, None, :]
    vecs = spec.extended_dir_vecs(raw)                 # (B, T, n_ext, 3)
    flat = vecs.reshape(-1, vecs.shape[-2], 3)
    i = [p[0] for p in prior.pairs]
    j = [p[1] for p in prior.pairs]
    inner = (flat[:, i] * flat[:, j]).sum(dim=-1)      # (N, n_pairs)
    inner = torch.clamp(inner, -1.0 + 1e-7, 1.0 - 1e-7)
    angle = torch.acos(inner) / math.pi
    avg = torch.tensor(prior.avg, dtype=angle.dtype, device=angle.device)
    var = torch.tensor(prior.var, dtype=angle.dtype, device=angle.device)
    # the reference sums the per-pair means
    return torch.sum(torch.mean((angle - avg) ** 2 / (2.0 * var), dim=0))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))
