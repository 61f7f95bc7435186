"""DiffGesture's pose diffusion (Zhu et al., "Taming Diffusion Models for
Audio-Driven Co-Speech Gesture Generation", CVPR 2023, arXiv:2303.09119;
github.com/Advocate99/DiffGesture): a transformer denoiser over a window's
n_poses frames, a DDPM variance schedule, classifier-free guidance and the
epsilon-prediction loss.

* Condition, per frame: [seed poses (pose_dim) | seed flag (1) | the
  ``WavEncoder``'s audio feature (32)], the seed poses and flag built as
  the multimodal generator's ``pre_seq``; the null condition is one learned
  vector repeated over the frames.
* Schedule (``variance_schedule``; Luo & Hu's point-cloud diffusion at
  flexibility 0): beta_t = linspace(beta_1, beta_T, T)[t - 1] for t =
  1..T and beta_0 = 0, alpha_t = 1 - beta_t, alpha_bar_t = prod over s <= t,
  sigma_t^2 = beta_t (1 - alpha_bar_{t-1}) / (1 - alpha_bar_t); computed in
  float64, kept in float32.
* Denoiser eps(x_t, beta_t, c): per frame [x_t | beta, sin beta, cos beta |
  c] -> Linear(width) plus a learned positional embedding -> ``block_depth``
  pre-LN blocks (h += W_o softmax(Q K^T / sqrt(d)) V with Q, K, V from one
  Linear(width, 3 width) on LN(h); h += Linear(GELU(Linear(LN(h))))) -> LN
  -> Linear(pose_dim).  It computes in the compute dtype, layer norm's
  statistics in float32.
* Guidance: eps_u + s (eps_c - eps_u), the two passes run as one of 2B rows
  (conditioned rows first).
* Sampler: x_T ~ N(0, I); x_{t-1} = (x_t - beta_t / sqrt(1 - alpha_bar_t)
  eps) / sqrt(alpha_t) + sigma_t z, z ~ N(0, I) for t > 1 and no draw at
  t = 1.  The chain, the schedule's arithmetic and the guided combination
  are float32; the noise is drawn in float32 from the caller's generator on
  its own device (and moved), x_T first, then z_T .. z_2.
* Loss: t uniform in 1..T, eps ~ N(0, I), x_t = sqrt(alpha_bar_t) x_0 +
  sqrt(1 - alpha_bar_t) eps, the condition replaced by the null one with
  probability ``null_cond_prob``; mean((eps_theta - eps)^2).

Module names follow the benchmark's plain reference
(``benchmark/reference/diffgesture.py``), whose state dict loads here one
for one.  The paper's annealed-noise "gesture stabilizer" is left out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.hierarchy import FEAT_SIZE
from ha2g_torch.models.multimodal_context import WavEncoder
from ha2g_torch.parallel.mesh import draw_rows
from ha2g_torch.utils.spans import span

LN_EPS = 1e-5


def variance_schedule(steps: int, beta_1: float, beta_T: float) -> dict:
    """float32 (T + 1,) tables indexed by t: beta, alpha, alpha_bar, sigma,
    and ``temb`` (T + 1, 3), the denoiser's time input [beta, sin beta,
    cos beta]."""
    betas = torch.cat([torch.zeros(1, dtype=torch.float64), torch.linspace(
        beta_1, beta_T, steps, dtype=torch.float64)])
    alphas = 1.0 - betas
    alpha_bars = torch.cumprod(alphas, 0)
    sigmas = torch.zeros_like(betas)
    sigmas[1:] = torch.sqrt(betas[1:] * (1.0 - alpha_bars[:-1])
                            / (1.0 - alpha_bars[1:]))
    temb = torch.stack([betas, torch.sin(betas), torch.cos(betas)], -1)
    return {k: v.float() for k, v in (("beta", betas), ("alpha", alphas),
                                       ("alpha_bar", alpha_bars),
                                       ("sigma", sigmas), ("temb", temb))}


def step_coefficients(sched: dict) -> list[tuple[float, float, float]]:
    """Per t, (1 / sqrt(alpha_t), beta_t / sqrt(1 - alpha_bar_t), sigma_t)
    as float32 values (index 0 unused)."""
    c0 = 1.0 / torch.sqrt(sched["alpha"])
    c1 = sched["beta"] / torch.sqrt(1.0 - sched["alpha_bar"])
    return list(zip(c0.tolist(), c1.tolist(), sched["sigma"].tolist()))


def _noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """N(0, I) in float32 from ``generator`` on its own device, on
    ``device``; a part of a global batch keeps its rows of the global
    draw."""
    return draw_rows(shape, lambda s: torch.randn(
        s, generator=generator, device=generator.device)).to(device)


class Block(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, width: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, mlp_ratio * width)
        self.fc2 = nn.Linear(mlp_ratio * width, width)


class Denoiser(nn.Module):
    """eps_theta over (N, frames, pose_dim + 3 + cond_dim) inputs ->
    (N, frames, pose_dim) in the compute dtype.  ``pos`` is the learned
    positional embedding."""

    # init_parameters_: ``pos`` N(0, 1/n)
    init = "normal_1/n"

    def __init__(self, pose_dim: int, cond_dim: int, n_frames: int,
                 width: int, depth: int, heads: int, mlp_ratio: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} does not split into {heads} "
                             f"heads")
        self.heads = heads
        self.inp = nn.Linear(pose_dim + 3 + cond_dim, width)
        self.pos = nn.Parameter(torch.zeros(n_frames, width))
        self.blocks = nn.ModuleList([Block(width, mlp_ratio)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.out = nn.Linear(width, pose_dim)

    def cast(self, dtype: torch.dtype) -> dict:
        """Every parameter in ``dtype``, by name: one cast a chain (the
        tensors themselves in float32)."""
        return {k: p.to(dtype) for k, p in self.named_parameters()}

    def forward(self, x, w: dict) -> torch.Tensor:
        """x (N, L, in) in the compute dtype; ``w`` from ``cast``."""
        with span("ha2g.model.denoiser"):
            N, L, _ = x.shape
            h = F.linear(x, w["inp.weight"], w["inp.bias"]) + w["pos"]
            D = h.shape[-1]
            H = self.heads
            for i in range(len(self.blocks)):
                b = f"blocks.{i}."
                a = F.layer_norm(h, (D,), w[b + "norm1.weight"],
                                 w[b + "norm1.bias"], LN_EPS)
                qkv = F.linear(a, w[b + "qkv.weight"], w[b + "qkv.bias"])
                q, k, v = qkv.view(N, L, 3, H, D // H).permute(
                    2, 0, 3, 1, 4).unbind(0)
                a = F.scaled_dot_product_attention(q, k, v)
                a = a.transpose(1, 2).reshape(N, L, D)
                h = h + F.linear(a, w[b + "proj.weight"], w[b + "proj.bias"])
                a = F.layer_norm(h, (D,), w[b + "norm2.weight"],
                                 w[b + "norm2.bias"], LN_EPS)
                a = F.gelu(F.linear(a, w[b + "fc1.weight"], w[b + "fc1.bias"]))
                h = h + F.linear(a, w[b + "fc2.weight"], w[b + "fc2.bias"])
            h = F.layer_norm(h, (D,), w["norm.weight"], w["norm.bias"],
                             LN_EPS)
            return F.linear(h, w["out.weight"], w["out.bias"])


class PoseDiffusion(nn.Module):
    """The whole model: ``audio_encoder`` (the multimodal generator's
    ``WavEncoder``), ``denoiser`` and ``null_cond``; ``condition``,
    ``sample`` and ``eps_loss`` (see the module doc)."""

    # init_parameters_: ``null_cond`` N(0, 1/n)
    init = "normal_1/n"

    def __init__(self, pose_dim: int, n_poses: int, n_pre_poses: int, *,
                 width: int, depth: int, heads: int, mlp_ratio: int,
                 steps: int, beta_1: float, beta_T: float,
                 null_cond_prob: float, guidance_scale: float):
        super().__init__()
        self.pose_dim, self.n_pre = pose_dim, n_pre_poses
        self.steps, self.null_cond_prob = steps, null_cond_prob
        self.guidance_scale = guidance_scale
        cond_dim = pose_dim + 1 + FEAT_SIZE
        self.audio_encoder = WavEncoder()
        self.null_cond = nn.Parameter(torch.zeros(cond_dim))
        self.denoiser = Denoiser(pose_dim, cond_dim, n_poses, width, depth,
                                 heads, mlp_ratio)
        self.schedule = variance_schedule(steps, beta_1, beta_T)
        self.coefficients = step_coefficients(self.schedule)
        # the schedule's tables on a device by (device, dtype)
        self._tables: dict = {}

    def tables(self, device, dtype: torch.dtype) -> dict:
        """``temb`` (T + 1, 3) in ``dtype`` and ``alpha_bar`` (T + 1,) in
        float32 on ``device``, made once (outside inference mode, so a
        training step may save them; before any graph capture)."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            with torch.inference_mode(False):
                self._tables[key] = {
                    "temb": self.schedule["temb"].to(device, dtype),
                    "alpha_bar": self.schedule["alpha_bar"].to(device)}
        return self._tables[key]

    def condition(self, seed, audio, dtype: torch.dtype) -> torch.Tensor:
        """seed (B, n_pre, pose_dim) float32 poses, audio (B, n) raw 16 kHz
        waveform -> (B, n_poses, cond_dim) in ``dtype``."""
        feat = self.audio_encoder(audio, dtype)
        B, T, _ = feat.shape
        n, D = self.n_pre, self.pose_dim
        pre = seed.new_zeros((B, T, D + 1))
        pre[:, :n, :D] = seed
        pre[:, :n, D] = 1.0
        return torch.cat([pre.to(dtype), feat], -1)

    def _inputs(self, x, temb, cond, dtype):
        """[x | temb | cond] per frame in ``dtype``; temb (N, 3) or (3,)."""
        N, T, _ = cond.shape
        temb = temb.view(-1, 1, 3).expand(N, T, 3)
        return torch.cat([x.to(dtype), temb, cond], -1)

    def guided_rows(self, cond) -> torch.Tensor:
        """(2B, n_poses, cond_dim): the condition's rows, then as many of
        the null condition's."""
        return torch.cat([cond, self.null_cond.to(cond.dtype).expand_as(cond)])

    def guided_eps(self, x, t: int, both, w: dict,
                   dtype: torch.dtype) -> torch.Tensor:
        """eps_u + s (eps_c - eps_u) in float32 at step t for x (B,
        n_poses, pose_dim): one denoiser pass over the 2B rows of ``both``
        (``guided_rows``), ``w`` the denoiser's ``cast``."""
        B = x.shape[0]
        temb = self.tables(x.device, dtype)["temb"][t]
        eps = self.denoiser(self._inputs(x.to(dtype).repeat(2, 1, 1), temb,
                                         both, dtype), w).float()
        return torch.lerp(eps[B:], eps[:B], self.guidance_scale)

    def sample(self, cond, generator: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
        """The guided chain from x_T: cond (B, n_poses, cond_dim) in
        ``dtype`` -> x_0 float32 (B, n_poses, pose_dim)."""
        B, T, _ = cond.shape
        dev = cond.device
        w = self.denoiser.cast(dtype)
        both = self.guided_rows(cond)
        x = _noise((B, T, self.pose_dim), generator, dev)
        for t in range(self.steps, 0, -1):
            eps = self.guided_eps(x, t, both, w, dtype)
            c0, c1, sigma = self.coefficients[t]
            x = torch.add(x, eps, alpha=-c1).mul_(c0)
            if t > 1:
                x.add_(_noise(x.shape, generator, dev), alpha=sigma)
        return x

    def eps_loss(self, target, audio, generator: torch.Generator,
                 dtype: torch.dtype) -> torch.Tensor:
        """The epsilon loss on x_0 = ``target`` (B, n_poses, pose_dim), its
        first n_pre frames the seed; draws t, then eps, then the null
        condition's coin from ``generator``."""
        B = target.shape[0]
        dev = target.device
        g = generator
        cond = self.condition(target[:, :self.n_pre], audio, dtype)
        t = draw_rows((B,), lambda s: torch.randint(
            1, self.steps + 1, s, generator=g, device=g.device)).to(dev)
        eps = _noise(target.shape, g, dev)
        drop = draw_rows((B,), lambda s: torch.rand(
            s, generator=g, device=g.device)).to(dev) < self.null_cond_prob
        tab = self.tables(dev, dtype)
        abar = tab["alpha_bar"][t].view(B, 1, 1)
        x_t = torch.sqrt(abar) * target + torch.sqrt(1.0 - abar) * eps
        cond = torch.where(drop.view(B, 1, 1),
                           self.null_cond.to(dtype).expand_as(cond), cond)
        pred = self.denoiser(self._inputs(x_t, tab["temb"][t], cond, dtype),
                             self.denoiser.cast(dtype)).float()
        return torch.mean((pred - eps) ** 2)

