"""Embedding-space (FGD) evaluator (the port of ha2g_tpu/eval/fgd.py,
reference scripts/model/embedding_space_evaluator.py).

A frozen gesture autoencoder embeds real and generated pose windows; the
scores are the Fréchet distance between Gaussian fits of the two feature
populations, the mean L1 feature distance, and the diversity score.  The
embedding runs on the device; the covariance and ``scipy.linalg.sqrtm``
statistics run on the host, as in the JAX package (mseitzer's FID
semantics, with its eps fallback).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ha2g_torch.device import resolve_device
from ha2g_torch.models.embedding_net import EmbeddingNet
from ha2g_torch.models.motion_ae import MotionAE


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))
    (embedding_space_evaluator.py:157-209)."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # without disp=False, which newer scipy versions no longer take
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component {}".format(
                np.max(np.abs(covmean.imag))))
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def pca_2d(x: np.ndarray) -> np.ndarray:
    """The first two principal components' scores of the rows of x, in
    float64: scikit-learn's ``PCA(n_components=2).fit_transform`` (the
    JAX package's view) in numpy, its sign rule included (``svd_flip``
    with ``u_based_decision=False``: each component's entry of largest
    magnitude positive)."""
    x = np.asarray(x, np.float64)
    centred = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(centred, full_matrices=False)
    vt = vt[:2]
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    return centred @ (vt * signs[:, None]).T


def make_embedder(pose_dim: int, n_frames: int = 34,
                  latent_dim: int = 128) -> torch.nn.Module:
    """The reference's embedder for a pose width: MotionAE for TED
    Expressive (126), EmbeddingNet(mode="pose") otherwise
    (embedding_space_evaluator.py:27-34)."""
    if pose_dim == 126:
        return MotionAE(pose_dim, latent_dim)
    return EmbeddingNet(pose_dim, n_frames, mode="pose")


def _recon_err(recon: np.ndarray, target: np.ndarray) -> float:
    """Sum over samples of the mean |recon - target| plus the mean
    |velocity gap| (embedding_space_evaluator.py:79-101)."""
    e = np.mean(np.abs(recon - target), axis=(1, 2))
    e += np.mean(np.abs(np.diff(recon, axis=1) - np.diff(target, axis=1)),
                 axis=(1, 2))
    return np.sum(e)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class EmbeddingSpaceEvaluator:
    """``push_samples`` embeds on ``device`` (CUDA unless ``device="cpu"``);
    ``get_scores`` / ``get_diversity_scores`` compute on the host.
    ``state_dict`` is the embedder's, in the reference's key layout."""

    def __init__(self, pose_dim: int, n_frames: int, state_dict: dict,
                 latent_dim: int = 128, device=None):
        self.device = resolve_device(device)
        self.pose_dim = pose_dim
        self.net = make_embedder(pose_dim, n_frames, latent_dim)
        self.net.load_state_dict(state_dict, strict=True)
        self.net.to(self.device).eval()
        self.reset()

    def reset(self):
        self.real_feat_list: list[np.ndarray] = []
        self.generated_feat_list: list[np.ndarray] = []
        self.recon_err_diff: list[float] = []

    def get_no_of_samples(self) -> int:
        return len(self.real_feat_list)

    def _embed(self, poses):
        """Pose windows (numpy, or a tensor on any device) -> (features,
        reconstructions) as float32 numpy."""
        x = torch.as_tensor(poses).to(self.device, torch.float32)
        feat, recon = self.net.embed(x)
        return feat.cpu().numpy(), recon.cpu().numpy()

    def push_samples(self, generated_poses, real_poses):
        """generated / real: (B, T, pose_dim) direction vectors."""
        real_feat, real_recon = self._embed(real_poses)
        gen_feat, gen_recon = self._embed(generated_poses)
        self.real_feat_list.append(real_feat)
        self.generated_feat_list.append(gen_feat)
        self.recon_err_diff.append(
            _recon_err(gen_recon, _host(generated_poses))
            - _recon_err(real_recon, _host(real_poses)))

    def get_scores(self) -> tuple[float, float]:
        """-> (Fréchet distance, mean L1 feature distance)."""
        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        try:
            fd = frechet_distance(
                np.mean(generated, axis=0), np.cov(generated, rowvar=False),
                np.mean(real, axis=0), np.cov(real, rowvar=False))
        except ValueError:
            fd = 1e10
        feat_dist = float(np.mean(
            np.sum(np.abs(real - generated[:real.shape[0]]), axis=-1)))
        return fd, feat_dist

    def get_features_for_viz(self) -> tuple[np.ndarray, np.ndarray]:
        """A 2-D view of the real and the generated features, -> (real,
        generated), each (n, 2), as the reference returns them
        (embedding_space_evaluator.py:104-113): UMAP where ``umap`` imports,
        else a 2-component PCA of both together (``pca_2d``)."""
        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        stacked = np.vstack([generated, real])
        try:
            import umap  # type: ignore
            emb = umap.UMAP().fit_transform(stacked)
        except ImportError:
            emb = pca_2d(stacked)
        n = generated.shape[0]
        return emb[n:], emb[:n]

    def get_diversity_scores(self, rng: Optional[np.random.Generator] = None
                             ) -> float:
        """Mean L1 between the first 500 batches' features and a shuffled
        batch order of them (embedding_space_evaluator.py:115-125).  The
        default rng draws fresh entropy, like the reference's randperm."""
        rng = rng or np.random.default_rng()
        feat1 = np.vstack(self.generated_feat_list[:500])
        idx = rng.permutation(len(self.generated_feat_list))[:500]
        feat2 = np.vstack([self.generated_feat_list[i] for i in idx])
        n = min(feat1.shape[0], feat2.shape[0])
        return float(np.mean(np.sum(np.abs(feat1[:n] - feat2[:n]), axis=-1)))
