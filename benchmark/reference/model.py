"""The HA2G hierarchy in plain PyTorch: the log-mel front end, the
SE-ResNet audio encoder with speaker blending, one generator cell a level
(TCN text encoder, speaker z, 4-layer bi-GRU, MLP), the level cascade, the
conv discriminator, and the GAN train step with its losses (HA2G's
hierarchy_net.py, ResNetSE34V2.py, tcn.py, train_hierarchy*.py,
data_utils.py).

Parameter and buffer names are the reference's state-dict names, so one
set of weights loads into this module and into the measured program
alike.  Every product runs in float32 (TF32 off, ``precision.
exact_float32``), or through ``Precision.q`` in the control's float8.  The
GRU recurrence is a plain loop over time, the contrastive loss the plain
(N, N) product.  Noise (dropout masks, speaker z, the diversity term's
speaker permutation) is drawn from the caller's ``torch.Generator`` in the
order the HA2G step draws it, so a generator seeded alike gives the same
draws to any implementation of that order.  Nothing here imports the
measured program.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import FLOAT32, Precision
from .skeletons import SkeletonSpec

Z_SIZE = 16
FEAT_SIZE = 32
SR, N_FFT, HOP, N_MELS = 16000, 1024, 512, 128


# ---------------------------------------------------------------------------
# log-mel (librosa melspectrogram(n_fft=1024, hop=512) + power_to_db(ref=max))
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 / 3 * m)


@lru_cache(maxsize=None)
def mel_filterbank() -> np.ndarray:
    """(513, 128) Slaney-normalised triangles (librosa htk=False)."""
    freqs = np.linspace(0.0, SR / 2.0, 1 + N_FFT // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0),
                                   N_MELS + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return w.T.astype(np.float32)


def mulaw_decode(u8: torch.Tensor) -> torch.Tensor:
    y = u8.float() * (2.0 / 255.0) - 1.0
    return torch.sign(y) * (torch.pow(256.0, y.abs()) - 1.0) / 255.0


def log_mel(y: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 waveform -> (B, 128, frames) dB, each clip referenced
    to its own maximum, floored at -80 (centre-padded, hann window)."""
    y = y.float()
    yp = F.pad(y[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    n_frames = 1 + (yp.shape[1] - N_FFT) // HOP
    frames = yp.unfold(1, N_FFT, HOP)[:, :n_frames]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                               device=y.device).float()
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.from_numpy(mel_filterbank()).to(y.device)
    db = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    db = db - db.amax(dim=(1, 2), keepdim=True)
    return torch.clamp_min(db, -80.0).transpose(1, 2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    def forward(self, x, p: Precision = FLOAT32):
        b = None if self.bias is None else p.q(self.bias)
        return F.linear(p.q(x), p.q(self.weight), b)


class Conv1d(nn.Conv1d):
    def forward(self, x, p: Precision = FLOAT32):
        b = None if self.bias is None else p.q(self.bias)
        return self._conv_forward(p.q(x), p.q(self.weight), b)


class Conv2d(nn.Conv2d):
    def forward(self, x, p: Precision = FLOAT32):
        b = None if self.bias is None else p.q(self.bias)
        return self._conv_forward(p.q(x), p.q(self.weight), b)


class BatchNorm(nn.BatchNorm2d):
    """Batch norm over axis 1 in float32: batch statistics in training
    (running statistics are not followed: no step reads them), running ones
    in eval."""

    def forward(self, x, p: Precision = FLOAT32):
        if self.training:
            out = F.batch_norm(x.float(), None, None, self.weight, self.bias,
                               True, 0.0, self.eps)
        else:
            out = F.batch_norm(x.float(), self.running_mean,
                               self.running_var, self.weight, self.bias,
                               False, 0.0, self.eps)
        return p.q(out)


def dropout(x, rate: float, training: bool, gen: torch.Generator):
    """Inverted dropout; the keep mask is uniform >= rate, drawn on the
    generator's device."""
    if not training or rate == 0.0:
        return x
    u = torch.rand(tuple(x.shape), generator=gen, device=gen.device)
    return torch.where((u >= rate).to(x.device), x / (1.0 - rate), 0.0)


def leaky_relu(x, slope: float):
    return torch.where(x >= 0, x, slope * x)


# ---------------------------------------------------------------------------
# the bidirectional GRU (torch.nn.GRU's gate order and parameter names)
# ---------------------------------------------------------------------------

def recurrence(xp, w_hh, b_hh, p: Precision = FLOAT32, h0=None):
    """Both directions of one layer: xp (T, 2, B, 3H) the input projection,
    w_hh (2, H, 3H), b_hh (2, 3H) -> the hidden states (T, 2, B, H), from
    h0 (zeros by default); gates (r, z, n) as torch.nn.GRU's."""
    T, _, B, G = xp.shape
    H = G // 3
    h = torch.zeros((2, B, H), device=xp.device) if h0 is None else h0
    outs = []
    for t in range(T):
        hh = torch.bmm(h, w_hh) + b_hh[:, None, :]
        xt = xp[t]
        r = torch.sigmoid(xt[..., :H] + hh[..., :H])
        z = torch.sigmoid(xt[..., H:2 * H] + hh[..., H:2 * H])
        n = torch.tanh(xt[..., 2 * H:] + r * hh[..., 2 * H:])
        h = p.q((1.0 - z) * n + z * h)
        outs.append(h)
    return torch.stack(outs)


class BiGRU(nn.Module):
    def __init__(self, input_size: int, hidden: int, n_layers: int,
                 rate: float):
        super().__init__()
        self.hidden, self.n_layers, self.rate = hidden, n_layers, rate
        H = hidden
        for layer in range(n_layers):
            d_in = input_size if layer == 0 else 2 * H
            for sfx in ("", "_reverse"):
                for name, shape in (("weight_ih", (3 * H, d_in)),
                                    ("weight_hh", (3 * H, H)),
                                    ("bias_ih", (3 * H,)),
                                    ("bias_hh", (3 * H,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.empty(shape)))

    def _both(self, name, layer):
        return [getattr(self, f"{name}_l{layer}{s}") for s in ("", "_reverse")]

    def forward(self, x, p: Precision, gen: torch.Generator):
        B, T, _ = x.shape
        H = self.hidden
        inp = p.q(x)
        for layer in range(self.n_layers):
            w_ih = torch.stack([p.q(w).t() for w in self._both("weight_ih", layer)])
            w_hh = torch.stack([p.q(w).t() for w in self._both("weight_hh", layer)])
            b_ih = torch.stack([p.q(b) for b in self._both("bias_ih", layer)])
            b_hh = torch.stack([p.q(b) for b in self._both("bias_hh", layer)])
            xp = torch.einsum("btd,ndg->tnbg", inp, w_ih) + b_ih[None, :, None]
            # direction 1 reads the reversed stream
            xp = p.q(torch.cat([xp[:, :1], xp[:, 1:].flip(0)], dim=1))
            o = recurrence(xp, w_hh, b_hh, p)                   # (T, 2, B, H)
            inp = torch.cat([o[:, 0], o[:, 1].flip(0)], dim=-1).transpose(0, 1)
            if layer < self.n_layers - 1:
                inp = dropout(inp, self.rate, self.training, gen)
        return inp[..., :H] + inp[..., H:]                      # directions summed


# ---------------------------------------------------------------------------
# SE-ResNet audio encoder
# ---------------------------------------------------------------------------

class SELayer(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.fc = nn.ModuleList([Linear(ch, ch // 8), nn.ReLU(),
                                 Linear(ch // 8, ch)])

    def forward(self, x, p):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc[2](F.relu(self.fc[0](y, p)), p))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.ModuleList([
                Conv2d(cin, planes, 1, stride, bias=False), BatchNorm(planes)])

    def forward(self, x, p):
        y = self.bn1(F.relu(self.conv1(x, p)), p)
        y = self.se(self.bn2(self.conv2(y, p), p), p)
        res = x if self.downsample is None else \
            self.downsample[1](self.downsample[0](x, p), p)
        return F.relu(y + res)


class ResNetSE(nn.Module):
    """(B, 128, S) log-mel, (B,) speakers -> (feat_low, feat_high, blend
    (L, B, T, 32))."""

    def __init__(self, n_speakers: int, levels: int):
        super().__init__()
        self.levels = levels
        filters, layers = (32, 64, 128, 256), (3, 4, 6, 3)
        self.conv1 = Conv2d(1, 32, 3, 1, 1)
        self.bn1 = BatchNorm(32)
        cin = 32
        for s, (planes, n) in enumerate(zip(filters, layers)):
            blocks = [SEBasicBlock(cin, planes, 1 if s == 0 else 2)]
            blocks += [SEBasicBlock(planes, planes) for _ in range(n - 1)]
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
            cin = planes
        for name, ch, shuffle, out, k, downs in (("low", 64, 1, 64, 2, 1),
                                                 ("mid", 128, 2, 32, 3, 2),
                                                 ("high", 256, 4, 16, 3, 3)):
            rows = N_MELS
            for _ in range(downs):
                rows = (rows - 1) // 2 + 1
            rows = rows * shuffle - (k - 1)
            setattr(self, f"conv_{name}", Conv2d(ch // shuffle ** 2, out, k))
            setattr(self, f"bn_{name}", BatchNorm(out))
            setattr(self, f"fc_{name}", Linear(out * rows, FEAT_SIZE))
        self.speaker_embedding = nn.ModuleList([nn.Embedding(n_speakers, 16),
                                                Linear(16, 16)])
        self.fc1 = Linear(16, 32)
        self.fc2 = Linear(32, 3 * levels)

    def _tap(self, name, x, shuffle, p):
        if shuffle > 1:
            x = F.pixel_shuffle(x, shuffle)
        conv, bn, fc = (getattr(self, f"{k}_{name}") for k in ("conv", "bn", "fc"))
        x = bn(F.relu(conv(x, p)), p)
        B, C, Hh, W = x.shape
        return fc(x.permute(0, 3, 1, 2).reshape(B, W, C * Hh), p)

    def forward(self, spec, vids, p: Precision = FLOAT32):
        x = self.bn1(F.relu(self.conv1(spec[:, None], p)), p)
        taps = []
        for s in range(4):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, p)
            taps.append(x)
        low = self._tap("low", taps[1], 1, p)
        mid = self._tap("mid", taps[2], 2, p)
        high = self._tap("high", taps[3], 4, p)
        e = self.speaker_embedding[1](self.speaker_embedding[0](vids), p)
        w = self.fc2(F.elu(self.fc1(F.elu(e), p)), p).reshape(-1, 3, self.levels)
        blend = torch.einsum("bsl,bstf->lbtf", torch.softmax(w, dim=1),
                             torch.stack([low, mid, high], dim=1))
        return low, high, blend


class AudioEncoder(nn.Module):
    def __init__(self, n_speakers: int, levels: int):
        super().__init__()
        self.feat_extractor = ResNetSE(n_speakers, levels)

    def forward(self, spec, vids, p: Precision = FLOAT32):
        return self.feat_extractor(spec, vids, p)


# ---------------------------------------------------------------------------
# TCN text encoder
# ---------------------------------------------------------------------------

class WeightNormConv1d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, dilation: int):
        super().__init__()
        self.dilation, self.pad = dilation, (k - 1) * dilation
        self.weight_v = nn.Parameter(torch.empty(cout, cin, k))
        self.weight_g = nn.Parameter(torch.empty(cout, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, p):
        norm = self.weight_v.flatten(1).norm(dim=1).clamp_min(1e-12)
        w = self.weight_v * (self.weight_g.view(-1) / norm)[:, None, None]
        return F.conv1d(F.pad(p.q(x), (self.pad, 0)), p.q(w), p.q(self.bias),
                        dilation=self.dilation)


class TemporalBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dilation: int, rate: float):
        super().__init__()
        self.rate = rate
        self.conv1 = WeightNormConv1d(cin, cout, 2, dilation)
        self.conv2 = WeightNormConv1d(cout, cout, 2, dilation)
        self.downsample = Conv1d(cin, cout, 1) if cin != cout else None

    def forward(self, x, p, gen):
        y = dropout(F.relu(self.conv1(x, p)), self.rate, self.training, gen)
        y = dropout(F.relu(self.conv2(y, p)), self.rate, self.training, gen)
        res = x if self.downsample is None else self.downsample(x, p)
        return F.relu(y + res)


class TemporalConvNet(nn.Module):
    def __init__(self, cin: int, hidden: int, n_layers: int, rate: float):
        super().__init__()
        self.network = nn.ModuleList(
            TemporalBlock(cin if i == 0 else hidden, hidden, 2 ** i, rate)
            for i in range(n_layers))


class TextEncoderTCN(nn.Module):
    def __init__(self, n_words: int, embed: int, hidden: int, n_layers: int,
                 rate: float):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed)
        self.tcn = TemporalConvNet(embed, hidden, n_layers, rate)
        self.decoder = Linear(hidden, FEAT_SIZE)

    def forward(self, tokens, p, gen):
        x = dropout(F.embedding(tokens, self.embedding.weight), 0.1,
                    self.training, gen).transpose(1, 2)
        for block in self.tcn.network:
            x = block(x, p, gen)
        return self.decoder(x.transpose(1, 2), p)


# ---------------------------------------------------------------------------
# generator cell, discriminator
# ---------------------------------------------------------------------------

class PoseGenerator(nn.Module):
    """[pre_seq, audio feat, text feat, speaker z] a frame -> bi-GRU ->
    Linear(H/2) -> leaky_relu(0.01) -> Linear(level_dim)."""

    def __init__(self, dim: int, n_words: int, n_speakers: int, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        rate = cfg.get("dropout_prob", 0.3)
        self.text_encoder = TextEncoderTCN(n_words, cfg["wordembed_dim"], H,
                                           cfg["n_layers"], rate)
        self.speaker_embedding = nn.ModuleList([nn.Embedding(n_speakers, Z_SIZE),
                                                Linear(Z_SIZE, Z_SIZE)])
        self.speaker_mu = Linear(Z_SIZE, Z_SIZE)
        self.speaker_logvar = Linear(Z_SIZE, Z_SIZE)
        self.gru = BiGRU(dim + 1 + 2 * FEAT_SIZE + Z_SIZE, H, cfg["n_layers"], rate)
        self.out = nn.ModuleList([Linear(H, H // 2), nn.LeakyReLU(0.01),
                                  Linear(H // 2, dim)])

    def forward(self, pre, text, audio_feat, vids, p, gen):
        B, T, _ = pre.shape
        text_feat = self.text_encoder(text, p, gen)
        e = self.speaker_embedding[1](self.speaker_embedding[0](vids), p)
        mu, logvar = self.speaker_mu(e, p), self.speaker_logvar(e, p)
        eps = torch.randn(tuple(mu.shape), generator=gen, device=gen.device)
        z = mu + eps.to(mu.device) * torch.exp(0.5 * logvar)
        x = torch.cat([pre, audio_feat, text_feat,
                       z[:, None, :].expand(B, T, Z_SIZE)], dim=2)
        y = leaky_relu(self.out[0](self.gru(x, p, gen), p), 0.01)
        return self.out[2](y, p), z, mu, logvar


class ConvDiscriminator(nn.Module):
    def __init__(self, pose_dim: int, n_poses: int, cfg: dict):
        super().__init__()
        self.pre_conv = nn.ModuleList([
            Conv1d(pose_dim, 16, 3), BatchNorm(16), nn.LeakyReLU(0.01),
            Conv1d(16, 8, 3), BatchNorm(8), nn.LeakyReLU(0.01),
            Conv1d(8, 8, 3)])
        self.gru = BiGRU(8, 64, 4, cfg.get("dropout_prob", 0.3))
        self.out = Linear(64, 1)
        self.out2 = Linear(n_poses - 6, 1)

    def forward(self, poses, p, gen):
        c = self.pre_conv
        x = poses.transpose(1, 2)
        x = leaky_relu(c[1](c[0](x, p), p), 0.01)
        x = leaky_relu(c[4](c[3](x, p), p), 0.01)
        x = c[6](x, p).transpose(1, 2)
        y = self.out(self.gru(x, p, gen), p)[..., 0]
        return torch.sigmoid(self.out2(y, p))


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

class Hierarchy(nn.Module):
    """audio / gens / text / dis, as the reference's four state dicts."""

    def __init__(self, cfg: dict, skeleton: SkeletonSpec, n_words: int,
                 n_speakers: int):
        super().__init__()
        self.cfg, self.sk = cfg, skeleton
        L = skeleton.n_levels
        self.audio = AudioEncoder(n_speakers, L)
        self.gens = nn.ModuleList(PoseGenerator(skeleton.level_dim(l), n_words,
                                                n_speakers, cfg)
                                  for l in range(L))
        self.text = TextEncoderTCN(n_words, cfg["wordembed_dim"],
                                   cfg["hidden_size"], cfg["n_layers"],
                                   cfg.get("dropout_prob", 0.3))
        self.dis = ConvDiscriminator(skeleton.pose_dim, cfg["n_poses"], cfg)

    def cascade(self, blend, text, target, vids, p, gen):
        """Every level, coarse to fine: -> (outs, level targets, z, mu,
        logvar of the last level)."""
        sk, n_pre = self.sk, self.cfg["n_pre_poses"]
        outs, targets, prev = [], [], None
        for l in range(sk.n_levels):
            t_l = target[..., torch.as_tensor(sk.level_cols(l), device=target.device)]
            B, T, D = t_l.shape
            pre = t_l.new_zeros((B, T, D + 1))
            pre[:, :n_pre, :D] = t_l[:, :n_pre]
            pre[:, :n_pre, D] = 1.0
            if prev is not None:
                src, dst = (torch.as_tensor(c, device=target.device)
                            for c in sk.routing(l - 1))
                pre[:, n_pre:, dst] = prev[:, n_pre:][..., src].float()
            prev, z, mu, logvar = self.gens[l](pre, text, blend[l], vids, p, gen)
            outs.append(prev.float())
            targets.append(t_l)
        return outs, targets, z, mu, logvar
