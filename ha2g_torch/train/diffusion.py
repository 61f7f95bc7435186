"""The training system of DiffGesture's pose diffusion (``model:
pose_diffusion``; ``models/diffusion.py``): the model itself with one Adam
``opt`` at ``learning_rate`` (torch's default betas, eps 1e-8), as the
single-optimiser systems of ``train/baselines.py``.  Its state dict is the
model's; there is no GAN and no ``loss_warmup`` gating."""

from __future__ import annotations

import torch

from ha2g_torch.config import Config
from ha2g_torch.models.diffusion import PoseDiffusion
from ha2g_torch.parallel.mesh import distributed_step
from ha2g_torch.train.baselines import _on_device, _SingleSystem


class DiffusionSystem(_SingleSystem, PoseDiffusion):
    """pose_diffusion: ``train_step`` takes the epsilon loss on a batch's
    windows; ``eval_step`` (through ``_SingleSystem``) samples each
    window's poses from its seed frames and audio with the guided chain."""

    batch_keys = ("audio", "target")

    def __init__(self, cfg: Config, n_words: int = 0, n_speakers: int = 0,
                 device=None, generator: torch.Generator | None = None):
        PoseDiffusion.__init__(
            self, cfg.pose_dim, cfg.n_poses, cfg.n_pre_poses,
            width=cfg.diff_hidden_dim, depth=cfg.block_depth,
            heads=cfg.n_heads, mlp_ratio=cfg.mlp_ratio,
            steps=cfg.diffusion_steps, beta_1=cfg.beta_1, beta_T=cfg.beta_T,
            null_cond_prob=cfg.null_cond_prob,
            guidance_scale=cfg.guidance_scale)
        self._setup(cfg, device, generator, (0.9, 0.999))

    def _forward(self, batch, generator):
        audio, target = _on_device(self, batch, ("audio", "target"))
        cond = self.condition(target[:, :self.n_pre], audio, self.dtype)
        return self.sample(cond, generator, self.dtype)

    @distributed_step
    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        """One step on ``batch`` {audio (B, n) raw 16 kHz waveform, target
        (B, T, pose_dim)}; -> {loss}: the epsilon loss, its t, noise and
        null-condition coin drawn from ``generator``."""
        audio, target = _on_device(self, batch, ("audio", "target"))
        self.train()
        loss = self.eps_loss(target, audio, generator, self.dtype)
        self._step(loss)
        return {"loss": loss.detach()}
