"""DiffGesture's plain reference (Zhu et al., CVPR 2023, arXiv:2303.09119;
github.com/Advocate99/DiffGesture): the raw-waveform audio encoder, the
transformer denoiser with attention written as softmax(Q K^T / sqrt(d)) V,
the DDPM schedule (computed here, not stored), the classifier-free-guided
sampler with two separate passes a step, the sliding-window synthesis of a
batch of clips, and the epsilon loss.  float32 (TF32 off: callers run it
under ``exact_float32``), ``Precision.q`` wherever the measured program
rounds to its compute dtype.  The paper's annealed-noise "gesture
stabilizer" is left out, as in the program.

Noise: drawn from the caller's generator on its own device at the whole
batch's size, each checked row keeping its own, in the program's order: a
window's x_T, then z_T .. z_2 (no draw at t = 1), window after window.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import BatchNorm, Conv1d, Linear, leaky_relu, mulaw_decode
from .precision import FLOAT32, Precision

FEAT = 32


class WavEncoder(nn.Module):
    """(B, n) waveform -> (B, 34, 32): four strided convs (5, 6, 6, 6; the
    first pads 1600), three batch norms, LeakyReLU(0.3)
    (multimodal_context_net.py:9-28)."""

    def __init__(self):
        super().__init__()
        self.feat_extractor = nn.Sequential(
            Conv1d(1, 16, 15, stride=5, padding=1600), BatchNorm(16),
            nn.LeakyReLU(0.3),
            Conv1d(16, 32, 15, stride=6), BatchNorm(32), nn.LeakyReLU(0.3),
            Conv1d(32, 64, 15, stride=6), BatchNorm(64), nn.LeakyReLU(0.3),
            Conv1d(64, 32, 15, stride=6))

    def forward(self, wav, p: Precision = FLOAT32):
        fe = self.feat_extractor
        x = wav[:, None]
        for i in (0, 3, 6):
            x = p.q(leaky_relu(fe[i + 1](p.q(fe[i](x, p)), p), 0.3))
        return p.q(fe[9](x, p)).transpose(1, 2)


class Block(nn.Module):
    def __init__(self, width: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-5)
        self.qkv = Linear(width, 3 * width)
        self.proj = Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=1e-5)
        self.fc1 = Linear(width, mlp_ratio * width)
        self.fc2 = Linear(mlp_ratio * width, width)


def _norm(ln: nn.LayerNorm, x, p):
    return p.q(F.layer_norm(x, ln.normalized_shape, p.q(ln.weight),
                            p.q(ln.bias), ln.eps))


def attention(q, k, v, p: Precision = FLOAT32):
    """softmax(q k^T / sqrt(d)) v over (N, heads, L, d)."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return p.q(p.q(torch.softmax(s, dim=-1)) @ v)


class Denoiser(nn.Module):
    def __init__(self, cfg: dict, cond_dim: int):
        super().__init__()
        d, D = cfg["diff_hidden_dim"], cfg["pose_dim"]
        self.heads = cfg["n_heads"]
        self.inp = Linear(D + 3 + cond_dim, d)
        self.pos = nn.Parameter(torch.empty(cfg["n_poses"], d))
        self.blocks = nn.ModuleList([Block(d, cfg["mlp_ratio"])
                                     for _ in range(cfg["block_depth"])])
        self.norm = nn.LayerNorm(d, eps=1e-5)
        self.out = Linear(d, D)

    def forward(self, x, p: Precision = FLOAT32):
        """x (N, L, pose_dim + 3 + cond_dim) -> eps (N, L, pose_dim)."""
        N, L, _ = x.shape
        h = p.q(p.q(self.inp(x, p)) + p.q(self.pos))
        d = h.shape[-1]
        H = self.heads
        for blk in self.blocks:
            qkv = p.q(blk.qkv(_norm(blk.norm1, h, p), p))
            q, k, v = qkv.view(N, L, 3, H, d // H).permute(2, 0, 3, 1, 4)
            a = attention(q, k, v, p).transpose(1, 2).reshape(N, L, d)
            h = p.q(h + p.q(blk.proj(a, p)))
            a = p.q(F.gelu(p.q(blk.fc1(_norm(blk.norm2, h, p), p))))
            h = p.q(h + p.q(blk.fc2(a, p)))
        return p.q(self.out(_norm(self.norm, h, p), p))


class DiffGesture(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        cond_dim = cfg["pose_dim"] + 1 + FEAT
        self.audio_encoder = WavEncoder()
        self.null_cond = nn.Parameter(torch.empty(cond_dim))
        self.denoiser = Denoiser(cfg, cond_dim)


def schedule(cfg: dict) -> dict:
    """beta, alpha, alpha_bar, sigma (the posterior's) and the time input
    [beta, sin beta, cos beta], indexed by t = 0..T, float32."""
    T = cfg["diffusion_steps"]
    beta = torch.zeros(T + 1, dtype=torch.float64)
    beta[1:] = torch.linspace(cfg["beta_1"], cfg["beta_T"], T,
                              dtype=torch.float64)
    alpha = 1.0 - beta
    alpha_bar = torch.cumprod(alpha, 0)
    sigma = torch.zeros(T + 1, dtype=torch.float64)
    for t in range(1, T + 1):
        sigma[t] = math.sqrt(beta[t] * (1.0 - alpha_bar[t - 1])
                             / (1.0 - alpha_bar[t]))
    temb = torch.stack([beta, torch.sin(beta), torch.cos(beta)], -1)
    return {"beta": beta.float(), "alpha": alpha.float(),
            "alpha_bar": alpha_bar.float(), "sigma": sigma.float(),
            "temb": temb.float()}


def condition(model: DiffGesture, seed, audio, p: Precision = FLOAT32):
    """seed (R, n_pre, pose_dim) poses, audio (R, n) -> (R, T, cond)."""
    cfg = model.cfg
    feat = model.audio_encoder(audio, p)
    R, T, _ = feat.shape
    n, D = cfg["n_pre_poses"], cfg["pose_dim"]
    pre = torch.zeros((R, T, D + 1), device=feat.device)
    pre[:, :n, :D] = seed
    pre[:, :n, D] = 1.0
    return torch.cat([p.q(pre), feat], -1)


def _inputs(x, temb, cond, p):
    R, T, _ = cond.shape
    return torch.cat([p.q(x), p.q(temb).view(-1, 1, 3).expand(R, T, 3),
                      cond], -1)


def _randn(shape, gen, rows, device):
    return torch.randn(shape, generator=gen, device=gen.device)[rows].to(device)


@torch.no_grad()
def sample(model: DiffGesture, cond, gen: torch.Generator, rows, batch: int,
           p: Precision = FLOAT32) -> torch.Tensor:
    """One window's guided chain for rows ``rows`` of a batch of ``batch``:
    cond (R, T, cond) -> x_0 (R, T, pose_dim)."""
    cfg = model.cfg
    sch = schedule(cfg)
    R, T, _ = cond.shape
    dev, D = cond.device, cfg["pose_dim"]
    # on the devices once, so no step waits on a host copy
    temb = sch["temb"].to(dev)
    rows = torch.as_tensor(rows).to(gen.device)
    beta, alpha, abar, sigma = (sch[k].tolist() for k in (
        "beta", "alpha", "alpha_bar", "sigma"))
    null = model.null_cond.view(1, 1, -1).expand(R, T, -1)
    s = cfg["guidance_scale"]
    x = _randn((batch, T, D), gen, rows, dev)
    for t in range(cfg["diffusion_steps"], 0, -1):
        e_c = model.denoiser(_inputs(x, temb[t], cond, p), p)
        e_u = model.denoiser(_inputs(x, temb[t], p.q(null), p), p)
        eps = e_u + s * (e_c - e_u)
        x = (x - beta[t] / math.sqrt(1.0 - abar[t]) * eps) / math.sqrt(alpha[t])
        if t > 1:
            x = x + sigma[t] * _randn((batch, T, D), gen, rows, dev)
    return x


def windows_of(cfg: dict, audio):
    """The raw-waveform windows, W of (R, n), of float32 clips (R,
    n_samples): window i from floor(i stride / clip n_samples), int(unit
    16000) samples, the last zero-padded."""
    fps, T, n = cfg["motion_resampling_framerate"], cfg["n_poses"], cfg["n_pre_poses"]
    n_samples = audio.shape[1]
    seconds = n_samples / 16000
    unit, stride = T / fps, (T - n) / fps
    W = 1 if seconds < unit else math.ceil((seconds - unit) / stride) + 1
    length = int(unit * 16000)
    out = []
    for i in range(W):
        a0 = math.floor(i * stride / seconds * n_samples)
        w = audio[:, a0:a0 + length]
        out.append(F.pad(w, (0, length - w.shape[1])))
    return out


@torch.no_grad()
def synthesize(model: DiffGesture, audio, gen: torch.Generator, rows,
               batch: int, p: Precision = FLOAT32, seeds=None):
    """Clips ``rows`` of a batch of ``batch`` (``audio`` holds those rows:
    uint8 mu-law or float32) -> (poses (R, frames, pose_dim), the windows'
    x_0, the restarted windows' x_0 or None).  Each window is seeded with
    the last n_pre frames of the last window's x_0; the n_pre overlap is
    cross-faded.  With ``seeds`` (one (R, n_pre, pose_dim) a window), a
    second copy of the rows runs in the same batch, with the same noise,
    each window restarted from its ``seeds[i]``."""
    cfg = model.cfg
    model.eval()
    n, T, D = cfg["n_pre_poses"], cfg["n_poses"], cfg["pose_dim"]
    wav = mulaw_decode(audio) if audio.dtype == torch.uint8 else audio.float()
    R, dev = wav.shape[0], wav.device
    rows = torch.as_tensor(rows)
    if seeds is not None:
        wav, rows = torch.cat([wav, wav]), torch.cat([rows, rows])
    tail = torch.zeros((R, n, D), device=dev)
    pieces, outs, restarted = [], [], []
    wins = windows_of(cfg, wav)
    for i, aw in enumerate(wins):
        seed = tail if seeds is None else torch.cat([tail, seeds[i]])
        out = sample(model, condition(model, seed, aw, p), gen, rows, batch, p)
        out, again = out[:R], out[R:]
        outs.append(out)
        restarted.append(again)
        j = torch.arange(n, device=dev).view(1, n, 1)
        head = out[:, :n] if i == 0 else \
            tail * (n - j) / (n + 1) + out[:, :n] * (j + 1) / (n + 1)
        tail = out[:, -n:]
        pieces.append(torch.cat([head, out[:, n:T if i == len(wins) - 1
                                             else T - n]], 1))
    return torch.cat(pieces, 1), outs, None if seeds is None else restarted


def eps_loss(model: DiffGesture, target, audio, gen: torch.Generator,
             p: Precision = FLOAT32) -> torch.Tensor:
    """The epsilon loss on windows ``target`` (B, T, pose_dim) with their
    raw audio (B, n), train-mode batch norm: t, eps and the null
    condition's coin drawn from ``gen`` in that order."""
    cfg = model.cfg
    B, dev = target.shape[0], target.device
    sch = schedule(cfg)
    cond = condition(model, target[:, :cfg["n_pre_poses"]], audio, p)
    t = torch.randint(1, cfg["diffusion_steps"] + 1, (B,), generator=gen,
                      device=gen.device).to(dev)
    eps = torch.randn(target.shape, generator=gen, device=gen.device).to(dev)
    drop = torch.rand((B,), generator=gen, device=gen.device).to(dev) \
        < cfg["null_cond_prob"]
    abar = sch["alpha_bar"].to(dev)[t].view(B, 1, 1)
    x_t = torch.sqrt(abar) * target + torch.sqrt(1.0 - abar) * eps
    null = model.null_cond.view(1, 1, -1).expand_as(cond)
    cond = torch.where(drop.view(B, 1, 1), p.q(null), cond)
    pred = model.denoiser(_inputs(x_t, sch["temb"].to(dev)[t], cond, p), p)
    return torch.mean((pred - eps) ** 2)
