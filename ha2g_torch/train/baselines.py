"""Training systems of the GAN baselines (the port of
ha2g_tpu/train/baselines.py): ``MultimodalGanSystem`` (multimodal_context,
reference train_gan.py:13-103) and ``S2GSystem`` (speech2gesture,
train_speech2gesture.py:5-37).

Each holds a generator ``gen`` and a discriminator ``dis`` (its state dict
``gen.*`` / ``dis.*``: the reference's ``gen_dict`` / ``dis_dict`` keys),
two Adam optimisers (b1 0.5, b2 0.999, eps 1e-8), G at ``learning_rate``
and D at ``learning_rate * discriminator_lr_weight``, and the train and
eval steps, in the style of ``train/hierarchy.py``:

* the generator's batch norms update their running statistics once a
  step, in the G phase; the D phase's fake forward and the diversity
  forward run in train mode (batch statistics) without updating them, as
  the JAX package throws those updates away (``mutable=False``);
* the discriminator's statistics chain D(real) -> D(fake) in the D phase,
  and D(out) in the G phase starts from there and updates them even
  when its GAN term is off;
* in the G phase D's parameters take no gradient;
* the diversity regulariser detaches the second forward's output and both
  z, so that forward takes no gradient and runs without a graph.

Losses are taken in float32 whatever the compute dtype.  After a step,
every parameter's ``.grad`` holds that step's gradient (None where the
step gave it none).  Randomness (speaker z, dropout, the speaker
permutation) comes from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.config import Config
from ha2g_torch.device import resolve_device
from ha2g_torch.models.common import init_parameters_, keep_running_stats
from ha2g_torch.models.hierarchy import ConvDiscriminator
from ha2g_torch.models.multimodal_context import PoseGenerator
from ha2g_torch.models import speech2gesture as s2g
from ha2g_torch.ops.precision import resolve_dtype
from ha2g_torch.train import losses


class _GanSystem(nn.Module):
    """Shared set-up: initialise ``gen`` and ``dis`` from ``generator`` (a
    CPU generator; seed 0 when None), move them to ``device`` (CUDA unless
    ``device="cpu"``), and build both optimisers."""

    batch_keys: tuple[str, ...] = ()

    def _setup(self, cfg: Config, device, generator):
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.to(device)
        self.device = device
        self.dtype = resolve_dtype(cfg.compute_dtype)
        self.g_opt = torch.optim.Adam(self.gen.parameters(),
                                      lr=cfg.learning_rate,
                                      betas=(0.5, 0.999), eps=1e-8)
        self.d_opt = torch.optim.Adam(
            self.dis.parameters(),
            lr=cfg.learning_rate * cfg.discriminator_lr_weight,
            betas=(0.5, 0.999), eps=1e-8)

    def _batch(self, batch: dict, keys=None) -> tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(batch[k]).to(self.device)
                     for k in keys or self.batch_keys)

    def _d_step(self, d_loss: torch.Tensor) -> None:
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()

    def _g_step(self, loss: torch.Tensor) -> None:
        self.g_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.g_opt.step()


class MultimodalGanSystem(_GanSystem):
    """multimodal_context: the trimodal PoseGenerator against the
    ConvDiscriminator with slope 1.0 (multimodal_context_net.py:213-221),
    ns-GAN loss."""

    batch_keys = ("text", "audio", "target", "vids")

    def __init__(self, cfg: Config, n_words: int, n_speakers: int,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.gen = PoseGenerator(
            pose_dim=cfg.pose_dim, n_words=n_words, n_speakers=n_speakers,
            word_embed_dim=cfg.wordembed_dim, hidden_size=cfg.hidden_size,
            n_layers=cfg.n_layers, dropout=cfg.dropout_prob,
            z_type=cfg.z_type, input_context=cfg.input_context,
            freeze_wordembed=cfg.freeze_wordembed)
        self.dis = ConvDiscriminator(cfg.pose_dim, cfg.n_poses, slope=1.0)
        self._setup(cfg, device, generator)

    def _pre_seq(self, target):
        """(B, T, pose_dim+1): the first n_pre target poses and a 1 flag."""
        n_pre = self.cfg.n_pre_poses
        B, T, D = target.shape
        pre = target.new_zeros((B, T, D + 1))
        pre[:, :n_pre, :D] = target[:, :n_pre]
        pre[:, :n_pre, D] = 1.0
        return pre

    def _gen(self, text, audio, target, vids, generator):
        out, z, mu, logvar = self.gen(self._pre_seq(target), text, audio,
                                      vids, self.dtype, generator)
        f32 = lambda t: None if t is None else t.float()
        return out.float(), f32(z), f32(mu), f32(logvar)

    def train_step(self, batch: dict, gan_on: bool,
                   generator: torch.Generator,
                   rand_vids: torch.Tensor | None = None) -> dict:
        """One step (see module doc) on ``batch`` {text (B, T) tokens,
        audio (B, n) raw 16 kHz waveform, target (B, T, pose_dim), vids
        (B,)}.  ``rand_vids`` overrides the speaker permutation of the
        diversity term (drawn from ``generator`` otherwise).  -> the
        metrics (0-d float32 tensors): dis (D phase only), loss (weighted
        Huber), DIV_REG and KLD (speaker z), gen (with ``gan_on``)."""
        cfg = self.cfg
        text, audio, target, vids = self._batch(batch)
        self.train()
        metrics: dict[str, torch.Tensor] = {}

        # ---------------- D phase ----------------
        if gan_on and cfg.loss_gan_weight > 0.0:
            with torch.no_grad(), keep_running_stats(self.gen):
                fake = self._gen(text, audio, target, vids, generator)[0]
            d_real = self.dis(target, self.dtype, generator).float()
            d_fake = self.dis(fake, self.dtype, generator).float()
            d_loss = losses.nsgan_d_loss(d_real, d_fake)
            self._d_step(d_loss)
            metrics["dis"] = d_loss.detach()

        # ---------------- G phase (against the updated D) ----------------
        out, z, mu, logvar = self._gen(text, audio, target, vids, generator)
        loss = cfg.loss_regression_weight * losses.scaled_huber(out, target)
        metrics["loss"] = loss.detach()

        # D on the generated poses: its statistics update in any case; its
        # parameters take no gradient
        self.dis.requires_grad_(False)
        try:
            with torch.set_grad_enabled(gan_on):
                gen_error = losses.nsgan_g_loss(
                    self.dis(out, self.dtype, generator).float())
        finally:
            self.dis.requires_grad_(True)

        if cfg.z_type in ("speaker", "random") and cfg.loss_reg_weight > 0.0:
            if rand_vids is None:
                rand_vids = vids
                if cfg.z_type == "speaker":
                    perm = torch.randperm(vids.shape[0], generator=generator,
                                          device=generator.device)
                    rand_vids = vids[perm.to(vids.device)]
            with torch.no_grad(), keep_running_stats(self.gen):
                out_r, z_r, _, _ = self._gen(
                    text, audio, target,
                    torch.as_tensor(rand_vids, device=self.device), generator)
            div = cfg.loss_reg_weight * losses.diversity_regularizer(
                out, out_r, z, z_r)
            loss = loss + div
            metrics["DIV_REG"] = div.detach()
            if cfg.z_type == "speaker":
                kld = cfg.loss_kld_weight * losses.speaker_kld(mu, logvar)
                loss = loss + kld
                metrics["KLD"] = kld.detach()

        if gan_on:
            gen = cfg.loss_gan_weight * gen_error
            loss = loss + gen
            metrics["gen"] = gen.detach()

        self._g_step(loss)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator):
        """Eval-mode generator (speaker z keeps its noise): -> (out
        (B, T, pose_dim) float32, mean L1 to the target)."""
        text, audio, target, vids = self._batch(batch)
        was_training = self.training
        self.eval()
        try:
            out = self._gen(text, audio, target, vids, generator)[0]
        finally:
            self.train(was_training)
        return out, losses.l1_loss(out, target)


class S2GSystem(_GanSystem):
    """speech2gesture: the spectrogram U-Net generator against the patch
    discriminator, LS-GAN on pose differences, a D phase every step (the
    reference has no warm-up)."""

    batch_keys = ("spec", "target", "vids")

    def __init__(self, cfg: Config, n_words: int = 0, n_speakers: int = 0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.gen = s2g.Generator(cfg.n_poses, cfg.pose_dim, cfg.n_pre_poses)
        self.dis = s2g.Discriminator(cfg.pose_dim)
        self._setup(cfg, device, generator)

    def _gen(self, spec, target):
        pre = target[:, :self.cfg.n_pre_poses]
        return self.gen(spec, pre, self.dtype).float()

    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        """One step on ``batch`` {spec (B, 128, S) log-mel, target
        (B, T, pose_dim)}; ``generator`` is unused (the step draws no
        noise).  -> the metrics: loss (weighted L1), gen (weighted LS-GAN
        term), dis."""
        cfg = self.cfg
        spec, target = self._batch(batch, ("spec", "target"))
        self.train()
        motion = lambda p: p[:, 1:] - p[:, :-1]

        # D phase, every step
        with torch.no_grad(), keep_running_stats(self.gen):
            fake_motion = motion(self._gen(spec, target))
        d_real = self.dis(motion(target), self.dtype).float()
        d_fake = self.dis(fake_motion, self.dtype).float()
        d_loss = torch.mean((1.0 - d_real) ** 2) + torch.mean(d_fake ** 2)
        self._d_step(d_loss)

        # G phase against the updated D, whose parameters take no gradient
        out = self._gen(spec, target)
        l1 = losses.l1_loss(out, target)
        self.dis.requires_grad_(False)
        try:
            d_out = self.dis(motion(out), self.dtype).float()
        finally:
            self.dis.requires_grad_(True)
        gen_error = torch.mean((1.0 - d_out) ** 2)
        loss = cfg.loss_regression_weight * l1 + \
            cfg.loss_gan_weight * gen_error
        self._g_step(loss)
        return {"loss": (cfg.loss_regression_weight * l1).detach(),
                "gen": (cfg.loss_gan_weight * gen_error).detach(),
                "dis": d_loss.detach()}

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator):
        """Eval-mode generator: -> (out (B, T, pose_dim) float32, mean L1
        to the target)."""
        spec, target = self._batch(batch, ("spec", "target"))
        was_training = self.training
        self.eval()
        try:
            out = self._gen(spec, target)
        finally:
            self.train(was_training)
        return out, losses.l1_loss(out, target)
