"""What the reference computes for the checks: the GAN train step
(HA2G train_hierarchy*.py: one train-mode audio forward, the D phase, the
G phase against the updated D, two Adam optimisers) and the fused sliding
window synthesis of a batch of clips (synthesize_hierarchy.py: windows of
n_poses frames at stride n_poses - n_pre, the carry seeding each window,
the n_pre overlap cross-faded).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import Hierarchy, log_mel, mulaw_decode
from .precision import FLOAT32, Precision


# ---------------------------------------------------------------------------
# losses (HA2G scripts/train_eval/*), float32
# ---------------------------------------------------------------------------

def huber(pred, target, beta=0.1, reduce=True):
    d = torch.abs(pred - target)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean() if reduce else loss


def contrastive(a, b, eps=1e-8):
    """Cross entropy over inverse-L2 similarities of unit rows, the
    diagonal as labels; the (N, N) matrix in full."""
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=eps)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=eps)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * (a @ b.T), min=0.0) + 1e-12)
    logits = torch.clamp(1.0 / (dist + eps), min=eps)
    return (torch.logsumexp(logits, dim=1) - torch.diagonal(logits)).mean()


def physical_prior(out, mean_dir_vec, sk):
    prior = sk.angle_prior
    v = sk.extended_dir_vecs(out + mean_dir_vec[None, None, :])
    v = v.reshape(-1, v.shape[-2], 3)
    i = [a for a, _ in prior.pairs]
    j = [b for _, b in prior.pairs]
    inner = torch.clamp((v[:, i] * v[:, j]).sum(-1), -1.0 + 1e-7, 1.0 - 1e-7)
    angle = torch.acos(inner) / math.pi
    avg = torch.tensor(prior.avg, device=out.device)
    var = torch.tensor(prior.var, device=out.device)
    return torch.sum(torch.mean((angle - avg) ** 2 / (2.0 * var), dim=0))


def g_params(model: Hierarchy):
    return [p for m in (model.audio, model.text, model.gens)
            for p in m.parameters()]


def optimizers(model: Hierarchy, cfg: dict):
    lr = cfg["learning_rate"]
    g = torch.optim.Adam(g_params(model), lr=lr, betas=(0.5, 0.999), eps=1e-8)
    d = torch.optim.Adam(model.dis.parameters(),
                         lr=lr * cfg.get("discriminator_lr_weight", 0.2),
                         betas=(0.5, 0.999), eps=1e-8)
    return g, d


def train_step(model: Hierarchy, g_opt, d_opt, batch: dict, gan_on: bool,
               gen: torch.Generator, p: Precision = FLOAT32) -> dict:
    """One GAN step on batch {text, spec, target, vids} (device tensors)
    -> its losses as floats: ``dis`` (D phase), ``g_total`` and, of its
    terms, the contrastive ``c_pos`` and ``c_neg`` (weighted)."""
    cfg, sk = model.cfg, model.sk
    text, spec, target, vids = (batch[k] for k in ("text", "spec", "target", "vids"))
    model.train()
    out = {}
    lo, hi, blend = model.audio(spec, vids, p)

    if gan_on and cfg["loss_gan_weight"] > 0.0:
        with torch.no_grad():
            fake = model.cascade(blend, text, target, vids, p, gen)[0][-1]
        d_real = model.dis(target, p, gen).float()
        d_fake = model.dis(fake, p, gen).float()
        d_loss = -torch.mean(torch.log(d_real + 1e-8)
                             + torch.log(1.0 - d_fake + 1e-8))
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d_opt.step()
        out["dis"] = d_loss.detach()

    outs, targets, z, mu, logvar = model.cascade(blend, text, target, vids, p, gen)
    gen_out = outs[-1]
    loss = cfg["loss_regression_weight"] * sum(
        huber(o, t) for o, t in zip(outs, targets))

    model.dis.requires_grad_(False)
    try:
        with torch.set_grad_enabled(gan_on):
            gen_error = -torch.mean(torch.log(
                model.dis(gen_out, p, gen).float() + 1e-8))
    finally:
        model.dis.requires_grad_(True)

    tf = model.text(text, p, gen).float()
    tf = tf.reshape(-1, tf.shape[-1])
    out["c_pos"] = cfg["loss_contrastive_pos_weight"] * contrastive(
        tf, hi.float().reshape(-1, hi.shape[-1]))
    out["c_neg"] = -cfg["loss_contrastive_neg_weight"] * contrastive(
        tf, lo.float().reshape(-1, lo.shape[-1]))
    loss = loss + out["c_pos"] + out["c_neg"]

    perm = torch.randperm(vids.shape[0], generator=gen, device=gen.device)
    rand_vids = vids[perm.to(vids.device)]
    with torch.no_grad():
        outs_r, _, z_rand, _, _ = model.cascade(blend, text, target, rand_vids,
                                                p, gen)
    pose_l1 = huber(gen_out, outs_r[-1].detach(), beta=0.05,
                    reduce=False).sum(dim=(1, 2))
    z_l1 = torch.abs(z.detach() - z_rand.detach()).mean(dim=1)
    div = torch.clamp(-(pose_l1 / (z_l1 + 1e-5)), min=-1000.0).mean()
    loss = loss + cfg["loss_reg_weight"] * div
    kld = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    loss = loss + cfg["loss_kld_weight"] * kld
    if gan_on:
        loss = loss + cfg["loss_gan_weight"] * gen_error
    mean_dir_vec = torch.tensor(cfg["mean_dir_vec"], device=gen_out.device)
    loss = loss + cfg["loss_physical_weight"] * physical_prior(
        gen_out, mean_dir_vec, sk)
    g_opt.zero_grad(set_to_none=True)
    loss.backward()
    g_opt.step()
    out["g_total"] = loss.detach()
    return {k: float(v.detach()) for k, v in out.items()}


# ---------------------------------------------------------------------------
# fused sliding-window synthesis
# ---------------------------------------------------------------------------

def window_plan(cfg: dict, n_samples: int) -> dict:
    """Window count, spectrogram offsets and lengths of a clip of
    ``n_samples`` at 16 kHz (synthesize_hierarchy.py:36-60)."""
    fps, T, n_pre = cfg["motion_resampling_framerate"], cfg["n_poses"], cfg["n_pre_poses"]
    seconds = n_samples / 16000
    unit, stride = T / fps, (T - n_pre) / fps
    W = 1 if seconds < unit else math.ceil((seconds - unit) / stride) + 1
    S_total = n_samples // 512 + 1
    spec_len = int(round((T / fps * 16000 - 1024) / 512 + 1))
    s0 = [math.floor(i * stride / seconds * S_total) for i in range(W)]
    return {"W": W, "unit": unit, "stride": stride, "s0": s0,
            "spec_len": spec_len, "S_total": S_total}


def frame_words(words, start, end, n_frames, index_of) -> np.ndarray:
    """One word index a frame: each word on the frame where it starts."""
    ext = np.zeros(n_frames, np.int64)
    dur = (end - start) / n_frames
    for w, t0, _ in words:
        if t0 < start or t0 > end:
            continue
        i = max(0, int(np.floor((t0 - start) / dur)))
        if i < n_frames:
            ext[i] = index_of(w)
    return ext


@torch.no_grad()
def synthesize(model: Hierarchy, audio: torch.Tensor, words, vids,
               gen: torch.Generator, rows, batch: int, index_of,
               p: Precision = FLOAT32) -> torch.Tensor:
    """The poses (len(rows), frames, pose_dim) of clips ``rows`` of a batch
    of ``batch`` clips synthesized in one fused call.  ``audio`` (float32
    samples, or uint8 mu-law), ``words``, ``vids`` hold only those rows.  The speaker-z noise is the
    call's: drawn window by window and level by level at the whole batch's
    size, each row keeping its own."""
    cfg, sk = model.cfg, model.sk
    model.eval()
    dev = audio.device
    T, n = cfg["n_poses"], cfg["n_pre_poses"]
    plan = window_plan(cfg, audio.shape[1])
    W, L = plan["W"], sk.n_levels
    spec = log_mel(mulaw_decode(audio) if audio.dtype == torch.uint8 else audio)
    pad = max(plan["s0"]) + plan["spec_len"] - spec.shape[2]
    if pad > 0:
        spec = torch.nn.functional.pad(spec, (0, pad), mode="replicate")
    vids = torch.as_tensor(vids, device=dev)
    rows_t = torch.as_tensor(rows, device=dev)
    text = torch.as_tensor(np.stack([np.stack([
        frame_words(w, i * plan["stride"], i * plan["stride"] + plan["unit"],
                    T, index_of) for w in words]) for i in range(W)]),
        device=dev)                                          # (W, R, T)
    R = audio.shape[0]
    pieces, tail = [], torch.zeros((R, n, sk.pose_dim), device=dev)
    for i in range(W):
        s0 = plan["s0"][i]
        blend = model.audio(spec[:, :, s0:s0 + plan["spec_len"]], vids, p)[2]
        target = torch.zeros((R, T, sk.pose_dim), device=dev)
        target[:, :n] = tail
        # the call's noise for this window: each level's (batch, 16) draw
        eps = [torch.randn((batch, 16), generator=gen, device=gen.device)
               for _ in range(L)]
        out = _cascade_with_eps(model, blend, text[i], target, vids, eps,
                                rows_t, p)
        head = out[:, :n] if i == 0 else \
            tail * (n - torch.arange(n, device=dev).view(1, n, 1)) / (n + 1) \
            + out[:, :n] * (torch.arange(n, device=dev).view(1, n, 1) + 1) / (n + 1)
        tail = out[:, -n:]
        pieces.append(torch.cat([head, out[:, n:T if i == W - 1 else T - n]], 1))
    return torch.cat(pieces, dim=1)


def _cascade_with_eps(model, blend, text, target, vids, eps, rows, p):
    """The eval-mode cascade with each level's speaker-z noise given."""
    sk, n_pre = model.sk, model.cfg["n_pre_poses"]
    prev = None
    for l, g in enumerate(model.gens):
        t_l = target[..., torch.as_tensor(sk.level_cols(l), device=target.device)]
        B, T, D = t_l.shape
        pre = t_l.new_zeros((B, T, D + 1))
        pre[:, :n_pre, :D] = t_l[:, :n_pre]
        pre[:, :n_pre, D] = 1.0
        if prev is not None:
            src, dst = (torch.as_tensor(c, device=target.device)
                        for c in sk.routing(l - 1))
            pre[:, n_pre:, dst] = prev[:, n_pre:][..., src]
        text_feat = g.text_encoder(text, p, None)
        e = g.speaker_embedding[1](g.speaker_embedding[0](vids), p)
        mu, logvar = g.speaker_mu(e, p), g.speaker_logvar(e, p)
        z = mu + eps[l].to(mu.device)[rows] * torch.exp(0.5 * logvar)
        x = torch.cat([pre, blend[l], text_feat,
                       z[:, None, :].expand(B, T, z.shape[-1])], dim=2)
        y = torch.nn.functional.leaky_relu(g.out[0](g.gru(x, p, None), p), 0.01)
        prev = g.out[2](y, p).float()
    return prev
