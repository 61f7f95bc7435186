"""Training systems of the baseline families (the port of
ha2g_tpu/train/baselines.py).

The GAN systems, ``MultimodalGanSystem`` (multimodal_context, reference
train_gan.py:13-103) and ``S2GSystem`` (speech2gesture,
train_speech2gesture.py:5-37), each hold a generator ``gen`` and a discriminator ``dis`` (its state dict
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

The single-optimiser systems are the model itself with one Adam ``opt``
(so their state dict is the net's, with the reference's ``gen_dict``
keys, and an FGD embedder's checkpoint is the embedder's state dict):

* ``Seq2SeqSystem`` (seq2seq, train_seq2seq.py:6-51): Adam with optax's
  default betas (0.9, 0.999), the gradient's global norm clipped to 5.0
  as optax clips it (``clip_grad_norm_optax_``), the MSE + continuity +
  variance loss;
* ``EmbedSystem`` (gesture_autoencoder with pose 27: mode pose;
  joint_embedding: mode random; train_joint_embed.py:5-62): Adam (0.5,
  0.999), the per-sample mean L1 summed over the batch;
* ``MotionAESystem`` (gesture_autoencoder with pose 126, the TED
  Expressive FGD embedder; train_feature_extractor_expressive.py:113-148):
  Adam (0.9, 0.999) at ``lr_for_epoch`` (StepLR 30 / 0.1), L1 of the poses
  and of their differences plus the weighted sum of bone cosines.

Under a mesh (``system.mesh``, ``parallel/mesh.py``) a step is one rank's
part of the global batch's step, its gradients averaged over the ranks
before each Adam step.  Every batch reduction of the losses was checked
for it: a mean over the batch (the Huber and L1 terms, the GAN pairs, KLD,
the diversity term, seq2seq's MSE, continuity and variance terms, each a
sum over the rank's elements over their count) is exact as a local mean;
a sum over the batch (``EmbedSystem``'s and ``MotionAESystem``'s losses)
is scaled by the rank count (``as_global_sum``), so the mean over ranks
is the global sum; batch norm takes global statistics; the speaker
permutation runs over the global batch; seq2seq clips at the global
gradient norm.

Losses are taken in float32 whatever the compute dtype.  After a step,
every parameter's ``.grad`` holds that step's gradient (None where the
step gave it none; seq2seq's clipped; under FSDP a sharded leaf's shard).  Randomness (speaker z, dropout,
the speaker permutation, the variational noise, the random mode's coin)
comes from the ``torch.Generator`` the caller passes.  Every Adam has eps
1e-8.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.config import Config
from ha2g_torch.device import resolve_device
from ha2g_torch.models.common import init_parameters_, keep_running_stats
from ha2g_torch.models.embedding_net import EmbeddingNet
from ha2g_torch.models.hierarchy import ConvDiscriminator
from ha2g_torch.models.motion_ae import MotionAE
from ha2g_torch.models.multimodal_context import PoseGenerator
from ha2g_torch.models.seq2seq import Seq2SeqNet
from ha2g_torch.models import speech2gesture as s2g
from ha2g_torch.ops.precision import resolve_dtype
from ha2g_torch.parallel.mesh import (as_global_sum, distributed_step,
                                      local_rows, optimizer_step,
                                      permute_rows)
from ha2g_torch.train import losses


def _place(system: nn.Module, cfg: Config, device, generator) -> None:
    """Initialise ``system``'s parameters from ``generator`` (a CPU
    generator; seed 0 when None), move it to ``device`` (CUDA unless
    ``device="cpu"``) and set its ``device`` and compute ``dtype``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters_(system, generator)
    system.to(device)
    system.device = device
    system.dtype = resolve_dtype(cfg.compute_dtype)
    # the mesh of a multi-process run (``Mesh.place``), else None
    system.mesh = None


def _on_device(system, batch: dict, keys) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(batch[k]).to(system.device) for k in keys)


class _GanSystem(nn.Module):
    """Shared set-up: ``_place`` ``gen`` and ``dis`` and build both
    optimisers."""

    batch_keys: tuple[str, ...] = ()

    def _setup(self, cfg: Config, device, generator):
        _place(self, cfg, device, generator)
        self.g_opt = torch.optim.Adam(self.gen.parameters(),
                                      lr=cfg.learning_rate,
                                      betas=(0.5, 0.999), eps=1e-8)
        self.d_opt = torch.optim.Adam(
            self.dis.parameters(),
            lr=cfg.learning_rate * cfg.discriminator_lr_weight,
            betas=(0.5, 0.999), eps=1e-8)

    def _batch(self, batch: dict, keys=None) -> tuple[torch.Tensor, ...]:
        return _on_device(self, batch, keys or self.batch_keys)

    def _d_step(self, d_loss: torch.Tensor) -> None:
        # the G phase runs D again: gather its shards after the step
        optimizer_step(self.d_opt, d_loss, self.mesh, regather=True)

    def _g_step(self, loss: torch.Tensor) -> None:
        optimizer_step(self.g_opt, loss, self.mesh)


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

    @distributed_step
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
                    rand_vids = permute_rows(vids, generator)
            else:
                rand_vids = local_rows(torch.as_tensor(rand_vids))
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

    @distributed_step
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


# ---------------------------------------------------------------------------
# single-optimiser systems
# ---------------------------------------------------------------------------

def clip_grad_norm_optax_(params, max_norm: float,
                          mesh=None) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place:
    g / ||g|| * max_norm when ||g|| >= max_norm, else g unchanged (torch's
    ``clip_grad_norm_`` divides by ||g|| + 1e-6).  -> ||g||, on the
    device (no host read).  Under a ``mesh`` the gradients are the
    averaged global ones; the squares of FSDP-sharded leaves are summed
    over their shards, so ||g|| is the global norm there too."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    split = [] if mesh is None else [p.grad for p in params
                                     if mesh.sharded(p)]
    whole = [p.grad for p in params if mesh is None or not mesh.sharded(p)]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in whole]))
    if split:
        sq = torch.stack([torch.linalg.vector_norm(g) for g in split])
        norm = torch.sqrt(norm * norm + mesh.sq_norm_of_shards(
            torch.sum(sq * sq)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class _SingleSystem:
    """What the single-optimiser systems share: the model is the system
    itself, with one Adam ``opt``."""

    batch_keys: tuple[str, ...] = ()

    def _setup(self, cfg: Config, device, generator, betas) -> None:
        self.cfg = cfg
        _place(self, cfg, device, generator)
        self.opt = torch.optim.Adam(self.parameters(), lr=cfg.learning_rate,
                                    betas=betas, eps=1e-8)

    def _step(self, loss: torch.Tensor) -> None:
        optimizer_step(self.opt, loss, self.mesh)

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator):
        """Eval mode: -> (output (B, T, pose_dim) float32, mean L1 to the
        target)."""
        target = _on_device(self, batch, ("target",))[0]
        was_training = self.training
        self.eval()
        try:
            out = self._forward(batch, generator)
        finally:
            self.train(was_training)
        return out, losses.l1_loss(out, target)


class Seq2SeqSystem(_SingleSystem, Seq2SeqNet):
    """seq2seq: the text-to-gesture ``Seq2SeqNet`` (no speaker input, as in
    the JAX package, though the batch ships ``vids`` as its batch keys
    say), Adam (0.9, 0.999) after optax's global-norm clip at 5.0."""

    batch_keys = ("word_seq", "word_lengths", "target", "vids")
    max_grad_norm = 5.0

    def __init__(self, cfg: Config, n_words: int, n_speakers: int = 0,
                 device=None, generator: torch.Generator | None = None):
        Seq2SeqNet.__init__(
            self, pose_dim=cfg.pose_dim, n_frames=cfg.n_poses,
            n_words=n_words, word_embed_dim=cfg.wordembed_dim,
            hidden_size=cfg.hidden_size, n_layers=cfg.n_layers,
            dropout=cfg.dropout_prob, n_pre_poses=cfg.n_pre_poses)
        self._setup(cfg, device, generator, (0.9, 0.999))

    def _forward(self, batch, generator):
        words, lengths, target = _on_device(
            self, batch, ("word_seq", "word_lengths", "target"))
        return self(words, lengths, target, self.dtype, generator)

    def custom_loss(self, out, target) -> torch.Tensor:
        """MSE + continuity + variance bonus (train_seq2seq.py:6-33); the
        variance term is the norm over *time* of each (sample, feature)."""
        cfg = self.cfg
        n_el = out.numel()
        mse = torch.mean((out - target) ** 2) * cfg.loss_regression_weight
        cont = torch.sum(torch.abs(out[:, 1:] - out[:, :-1])) / n_el \
            * cfg.loss_kld_weight
        var = -torch.sum(torch.linalg.vector_norm(out, dim=1)) / n_el \
            * cfg.loss_reg_weight
        return mse + cont + var

    @distributed_step
    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        """One step on ``batch`` {word_seq (B, S) padded SOS..EOS tokens,
        word_lengths (B,), target (B, T, pose_dim) (its first n_pre frames
        teacher-force the decoder), vids}; -> {loss}."""
        target = _on_device(self, batch, ("target",))[0]
        self.train()
        loss = self.custom_loss(self._forward(batch, generator), target)
        optimizer_step(self.opt, loss, self.mesh, clip=lambda: (
            clip_grad_norm_optax_(self.parameters(), self.max_grad_norm,
                                  self.mesh)))
        return {"loss": loss.detach()}


class EmbedSystem(_SingleSystem, EmbeddingNet):
    """gesture_autoencoder at pose 27 (mode pose: the TED Gesture FGD
    embedder) and joint_embedding (mode random: one coin a step picks the
    speech or the pose latent, kept in ``last_coin``); Adam (0.5, 0.999).
    Pose mode reads only the target."""

    def __init__(self, cfg: Config, n_words: int = 0, n_speakers: int = 0,
                 device=None, generator: torch.Generator | None = None):
        mode = "pose" if cfg.model == "gesture_autoencoder" else "random"
        EmbeddingNet.__init__(self, cfg.pose_dim, cfg.n_poses, mode,
                              n_words, cfg.wordembed_dim, cfg.n_pre_poses)
        self.batch_keys = ("target", "vids") if mode == "pose" \
            else ("text", "audio", "target", "vids")
        self._setup(cfg, device, generator, (0.5, 0.999))

    def _forward(self, batch, generator):
        target = _on_device(self, batch, ("target",))[0]
        pre = target[:, :self.cfg.n_pre_poses]
        text = audio = None
        if self.mode != "pose":
            text, audio = _on_device(self, batch, ("text", "audio"))
        return self(text, audio, pre, target, dtype=self.dtype,
                    generator=generator)[-1]

    @distributed_step
    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        """One step; -> {loss}: the per-sample mean L1 summed over the
        batch, plus the difference term with ``embed_pose_diff_loss``
        (train_feature_extractor.py:68-71)."""
        target = _on_device(self, batch, ("target",))[0]
        self.train()
        recon = self._forward(batch, generator)
        per = torch.mean(torch.abs(recon - target), dim=(1, 2))
        if self.cfg.embed_pose_diff_loss:
            per = per + torch.mean(torch.abs(
                (recon[:, 1:] - recon[:, :-1])
                - (target[:, 1:] - target[:, :-1])), dim=(1, 2))
        loss = as_global_sum(torch.sum(per))
        self._step(loss)
        return {"loss": loss.detach()}


class MotionAESystem(_SingleSystem, MotionAE):
    """gesture_autoencoder at pose 126: the TED Expressive FGD embedder,
    Adam (0.9, 0.999) whose learning rate the trainer sets each epoch
    (``lr_for_epoch``: StepLR 30 / 0.1, train_feature_extractor_expressive
    .py:103)."""

    batch_keys = ("target", "vids")

    def __init__(self, cfg: Config, n_words: int = 0, n_speakers: int = 0,
                 device=None, generator: torch.Generator | None = None):
        MotionAE.__init__(self, cfg.pose_dim, cfg.latent_dim)
        self._setup(cfg, device, generator, (0.9, 0.999))

    def lr_for_epoch(self, epoch: int) -> float:
        return self.cfg.learning_rate * (0.1 ** (epoch // 30))

    def _forward(self, batch, generator):
        target = _on_device(self, batch, ("target",))[0]
        return self(target, self.dtype)[0]

    @distributed_step
    def train_step(self, batch: dict, generator: torch.Generator,
                   lr: float | None = None) -> dict:
        """One step at learning rate ``lr`` (the config's when None); ->
        {loss, l1}: the summed per-sample L1 of the poses and of their
        differences, plus ``cos_loss_weight`` times the plain sum over
        (B, T, bones) of 1 - cos(recon, target)
        (train_feature_extractor_expressive.py:130-143)."""
        target = _on_device(self, batch, ("target",))[0]
        if lr is not None:
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.train()
        recon = self._forward(batch, generator)
        l1 = torch.sum(torch.mean(torch.abs(recon - target), dim=(1, 2)))
        l1 = l1 + torch.sum(torch.mean(torch.abs(
            (recon[:, 1:] - recon[:, :-1]) - (target[:, 1:] - target[:, :-1])),
            dim=(1, 2)))
        rr = recon.reshape(*recon.shape[:2], -1, 3)
        tt = target.reshape(*target.shape[:2], -1, 3)
        norms = torch.linalg.vector_norm(rr, dim=-1) \
            * torch.linalg.vector_norm(tt, dim=-1)
        cos = 1.0 - torch.sum(rr * tt, dim=-1) / torch.clamp_min(norms, 1e-8)
        l1 = as_global_sum(l1)
        loss = l1 + as_global_sum(torch.sum(cos)) * self.cfg.cos_loss_weight
        self._step(loss)
        return {"loss": loss.detach(), "l1": l1.detach()}
