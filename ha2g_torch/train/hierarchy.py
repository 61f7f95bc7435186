"""The HA2G hierarchy system: the audio encoder, one generator cell per
level, the standalone text encoder of the contrastive loss, the conv
discriminator, their two Adam optimisers, and the GAN train step and eval
step (the port of ha2g_tpu/train/hierarchy.py).

Parameters follow the reference's state-dict layout: ``audio.`` holds the
reference's ``audio_dict`` (``feat_extractor.*``), ``gens.{l}.`` the
level-l ``gen_dict_{l+1}``, ``text.`` its ``text_dict`` and ``dis.`` its
``dis_dict``; ``convert.hierarchy_state`` produces the same keys from the
JAX package's parameters.

One train step keeps the JAX package's dataflow (and the reference's):

1. one train-mode audio forward, shared by every phase; its batch-norm
   statistics update once;
2. D phase (``gan_on`` and a positive GAN weight): the cascade on the
   detached blend features without a graph, D on the real then the fake
   poses (two batch-norm updates of D), ns-GAN loss, D's Adam step;
3. G phase against the updated D: the cascade, per-level Huber; D on the
   generated poses, whose batch-norm update is kept even in warm-up while
   its GAN term counts only with ``gan_on``, and whose parameters take no
   gradient; the contrastive +/- terms of the standalone text features
   against the high / low audio taps; the diversity term from a second
   cascade with permuted speakers, without a graph; KLD; the physical
   prior; one backward that trains audio, text and generators, and the G
   Adam step.

Under a mesh (``self.mesh``, set by ``parallel.mesh.Mesh.place``) a step
is one rank's part of the global batch's step: batch norm takes the global
batch's statistics, the contrastive loss spans every rank's rows, the noise
(dropout, speaker z, the speaker permutation over the global batch) is the
global batch's rows, and each phase's gradients are averaged over the
ranks before its Adam step (FSDP: reduce-scattered, each rank stepping its
shards, the discriminator gathered again for the G phase).

Losses are taken in float32 whatever the compute dtype.  After a step,
every parameter's ``.grad`` holds that step's gradient (None where the step
gave it none).  Randomness (speaker z, dropout, the speaker permutation)
comes from the ``torch.Generator`` the caller passes; a CUDA generator
keeps the draws on the card.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.config import Config
from ha2g_torch.device import resolve_device
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.models.hierarchy import (ConvDiscriminator,
                                         HierarchicalPoseGenerator,
                                         HierarchicalWavEncoder)
from ha2g_torch.models.tcn import TextEncoderTCN
from ha2g_torch.ops.precision import resolve_dtype
from ha2g_torch.parallel.mesh import (distributed_step, local_rows,
                                      optimizer_step, permute_rows)
from ha2g_torch.skeleton import SkeletonSpec
from ha2g_torch.train import losses
from ha2g_torch.train.cascade import run_cascade
from ha2g_torch.utils.spans import span


class HierarchySystem(nn.Module):
    """Builds the modules on ``device`` (CUDA unless ``device="cpu"``) with
    torch-default initialization drawn from ``generator`` (a CPU generator;
    seed 0 when None), then the optimisers: Adam(b1 0.5, b2 0.999, eps
    1e-8) at ``learning_rate`` for audio, text and generators, and at
    ``learning_rate * discriminator_lr_weight`` for the discriminator."""

    batch_keys = ("text", "spec", "target", "vids")

    def __init__(self, cfg: Config, n_words: int, n_speakers: int,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.spec: SkeletonSpec = cfg.skeleton
        L = self.spec.n_levels
        self.audio = HierarchicalWavEncoder(pose_level=L,
                                            n_speakers=n_speakers)
        self.gens = nn.ModuleList(
            HierarchicalPoseGenerator(
                pose_dim=self.spec.level_dim(level), n_words=n_words,
                n_speakers=n_speakers, word_embed_dim=cfg.wordembed_dim,
                hidden_size=cfg.hidden_size, n_layers=cfg.n_layers,
                dropout=cfg.dropout_prob, z_type=cfg.z_type,
                input_context=cfg.input_context,
                freeze_wordembed=cfg.freeze_wordembed)
            for level in range(L))
        self.text = TextEncoderTCN(
            n_words, embed_dim=cfg.wordembed_dim, hidden_size=cfg.hidden_size,
            n_layers=cfg.n_layers, dropout=cfg.dropout_prob,
            freeze=cfg.freeze_wordembed)
        self.dis = ConvDiscriminator(self.spec.pose_dim, cfg.n_poses,
                                     slope=0.01)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.to(device)
        self.device = device
        self.dtype = resolve_dtype(cfg.compute_dtype)
        # the mesh of a multi-process run (``Mesh.place``), else None
        self.mesh = None
        self.mean_dir_vec = torch.as_tensor(cfg.mean_dir_vec_array,
                                            device=device)
        g_params = [p for m in (self.audio, self.text, self.gens)
                    for p in m.parameters()]
        self.g_opt = torch.optim.Adam(g_params, lr=cfg.learning_rate,
                                      betas=(0.5, 0.999), eps=1e-8)
        self.d_opt = torch.optim.Adam(
            self.dis.parameters(),
            lr=cfg.learning_rate * cfg.discriminator_lr_weight,
            betas=(0.5, 0.999), eps=1e-8)

    # ------------------------------------------------------------------
    def _batch(self, batch: dict) -> tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(batch[k]).to(self.device)
                     for k in self.batch_keys)

    def _cascade(self, blend, text, target, vids, generator):
        """The level cascade on audio blend features; float32 out (outs,
        targets, z, mu, logvar)."""
        outs, targets, z, mu, logvar = run_cascade(
            self.gens, self.spec, target, text, blend, vids,
            self.cfg.n_pre_poses, self.dtype, generator)
        f32 = lambda t: None if t is None else t.float()
        return ([o.float() for o in outs], [t.float() for t in targets],
                f32(z), f32(mu), f32(logvar))

    # ------------------------------------------------------------------
    @distributed_step
    def train_step(self, batch: dict, gan_on: bool,
                   generator: torch.Generator,
                   rand_vids: torch.Tensor | None = None) -> dict:
        """One GAN step (see module doc) on ``batch`` {text (B, T) tokens,
        spec (B, 128, S) log-mel, target (B, T, pose_dim), vids (B,)}.
        ``rand_vids`` overrides the speaker permutation of the diversity
        term (drawn from ``generator`` otherwise; under a mesh, the global
        batch's).  Under ``self.mesh`` the batch is this rank's rows of the
        global batch (``parallel/mesh.py``).  Returns the metrics
        (0-d float32 tensors): dis (D phase only), loss (weighted Huber),
        c_pos, c_neg, DIV_REG, KLD, gen (with ``gan_on``), phy, each by
        the same conditions as the JAX step."""
        cfg, spec, dtype = self.cfg, self.spec, self.dtype
        text, spec_in, target, vids = self._batch(batch)
        self.train()
        metrics: dict[str, torch.Tensor] = {}

        # ONE audio forward for the step (its BN statistics update once)
        with span("ha2g.train.audio"):
            _, lo, _, hi, blend = self.audio(spec_in, vids, dtype)

        # ---------------- D phase ----------------
        if gan_on and cfg.loss_gan_weight > 0.0:
            with span("ha2g.train.d_phase"):
                with torch.no_grad():
                    fake = self._cascade(blend, text, target, vids,
                                         generator)[0][-1]
                d_real = self.dis(target, dtype, generator).float()
                d_fake = self.dis(fake, dtype, generator).float()
                d_loss = losses.nsgan_d_loss(d_real, d_fake)
                optimizer_step(self.d_opt, d_loss, self.mesh, regather=True)
                metrics["dis"] = d_loss.detach()

        # ---------------- G phase (against the updated D) ----------------
        with span("ha2g.train.g_forward"):
            outs, targets, z, mu, logvar = self._cascade(blend, text, target,
                                                         vids, generator)
            out = outs[-1]
            huber = sum(losses.scaled_huber(o, t)
                        for o, t in zip(outs, targets))
            loss = cfg.loss_regression_weight * huber
            metrics["loss"] = loss.detach()

            # D on the generated poses: its BN statistics update in any
            # case; its parameters take no gradient from the G loss
            self.dis.requires_grad_(False)
            try:
                with torch.set_grad_enabled(gan_on):
                    gen_error = losses.nsgan_g_loss(
                        self.dis(out, dtype, generator).float())
            finally:
                self.dis.requires_grad_(True)

        # contrastive: standalone text features vs the high (+) and low (-)
        # audio taps, one row per frame
        with span("ha2g.train.contrastive"):
            text_feat = self.text(text, dtype, generator).float()
            tf = text_feat.reshape(-1, text_feat.shape[-1])
            if cfg.loss_contrastive_pos_weight > 0.0:
                c_pos = cfg.loss_contrastive_pos_weight * \
                    losses.softmax_contrastive(
                        tf, hi.float().reshape(-1, hi.shape[-1]))
                loss = loss + c_pos
                metrics["c_pos"] = c_pos.detach()
            if cfg.loss_contrastive_neg_weight > 0.0:
                c_neg = -cfg.loss_contrastive_neg_weight * \
                    losses.softmax_contrastive(tf, lo.float().reshape(
                        -1, lo.shape[-1]))
                loss = loss + c_neg
                metrics["c_neg"] = c_neg.detach()

        # diversity regulariser (its cascade is detached whole) and KLD
        if cfg.z_type in ("speaker", "random") and cfg.loss_reg_weight > 0.0:
            with span("ha2g.train.diversity"):
                if rand_vids is None:
                    rand_vids = vids
                    if cfg.z_type == "speaker":
                        rand_vids = permute_rows(vids, generator)
                else:
                    rand_vids = local_rows(torch.as_tensor(rand_vids))
                with torch.no_grad():
                    outs_r, _, z_rand, _, _ = self._cascade(
                        blend, text, target, torch.as_tensor(
                            rand_vids, device=self.device), generator)
                div = cfg.loss_reg_weight * losses.diversity_regularizer(
                    out, outs_r[-1], z, z_rand)
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

        if cfg.loss_physical_weight > 0.0 and spec.angle_prior is not None:
            phy = cfg.loss_physical_weight * losses.physical_angle_prior(
                out, self.mean_dir_vec, spec)
            loss = loss + phy
            metrics["phy"] = phy.detach()

        with span("ha2g.train.g_update"):
            optimizer_step(self.g_opt, loss, self.mesh)
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator):
        """Validation cascade (eval-mode batch norm, no dropout; speaker z
        keeps its noise, as the reference's): -> (out (B, T, pose_dim)
        float32, mean L1 to the target)."""
        text, spec_in, target, vids = self._batch(batch)
        was_training = self.training
        self.eval()
        try:
            blend = self.audio(spec_in, vids, self.dtype)[-1]
            out = self._cascade(blend, text, target, vids, generator)[0][-1]
        finally:
            self.train(was_training)
        return out, losses.l1_loss(out, target)
