"""Temporal Convolutional Network text encoder (reference TextEncoderTCN,
hierarchy_net.py:22-52, over the locuslab TCN).

Causality is a left pad of (k-1)*dilation per dilated conv (the reference
pads both sides and chomps the right: the same outputs).  Weight norm is
explicit, ``weight = g * v / ||v||`` with the norm over (in, k) per output
channel, and keeps torch's ``weight_v`` / ``weight_g`` parameter names.
Dropout masks come from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.common import Conv1d, Linear, dropout
from ha2g_torch.utils.spans import span


class WeightNormConv1d(nn.Module):
    """Causal dilated conv with torch-style weight norm on (B, C, T)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = (kernel_size - 1) * dilation
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_ch, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def forward(self, x, dtype: torch.dtype = torch.float32):
        # weight-norm math in float32; only the conv runs in the compute dtype
        norm = self.weight_v.flatten(1).norm(dim=1).clamp_min(1e-12)
        weight = self.weight_v * (self.weight_g.view(-1) / norm)[:, None, None]
        return F.conv1d(F.pad(x.to(dtype), (self.pad, 0)), weight.to(dtype),
                        self.bias.to(dtype), dilation=self.dilation)


class TemporalBlock(nn.Module):
    """Two weight-normed causal convs + residual (reference tcn.py:16-46)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dilation: int, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.conv1 = WeightNormConv1d(in_ch, out_ch, kernel_size, dilation)
        self.conv2 = WeightNormConv1d(out_ch, out_ch, kernel_size, dilation)
        self.downsample = Conv1d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        p, train = self.dropout, self.training
        y = dropout(F.relu(self.conv1(x, dtype)), p, train, generator)
        y = dropout(F.relu(self.conv2(y, dtype)), p, train, generator)
        # an identity residual keeps its dtype and the sum promotes, as in
        # the JAX package
        res = x if self.downsample is None else self.downsample(x, dtype)
        return F.relu(y + res)


class TemporalConvNet(nn.Module):
    """Stack of TemporalBlocks with dilation 2^i (reference tcn.py:49-64)."""

    def __init__(self, in_ch: int, channels, kernel_size: int = 2,
                 dropout: float = 0.2):
        super().__init__()
        self.network = nn.ModuleList(
            TemporalBlock(in_ch if i == 0 else channels[i - 1], ch,
                          kernel_size, 2 ** i, dropout)
            for i, ch in enumerate(channels))

    def forward(self, x, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        for block in self.network:
            x = block(x, dtype, generator)
        return x


class TextEncoderTCN(nn.Module):
    """Word tokens (B, T) -> embedding -> TCN -> Linear(32): (B, T, 32).

    The embedding dropout stays at the reference's fixed 0.1 whatever
    ``dropout`` is (hierarchy_net.py:25); ``freeze`` stops the table's
    gradient (``freeze_wordembed``)."""

    def __init__(self, n_words: int, embed_dim: int = 300,
                 hidden_size: int = 300, n_layers: int = 4,
                 kernel_size: int = 2, dropout: float = 0.3,
                 emb_dropout: float = 0.1, freeze: bool = False):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.freeze = freeze
        self.embedding = nn.Embedding(n_words, embed_dim)
        self.tcn = TemporalConvNet(embed_dim, [hidden_size] * n_layers,
                                   kernel_size, dropout)
        self.decoder = Linear(hidden_size, 32)
        self.decoder.init = "normal_0.01"  # hierarchy_net.py:44-46

    def forward(self, tokens, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        with span("ha2g.model.text_encoder"):
            table = self.embedding.weight
            emb = F.embedding(tokens, table.detach() if self.freeze else table)
            emb = dropout(emb, self.emb_dropout, self.training, generator)
            y = self.tcn(emb.transpose(1, 2), dtype, generator)
            return self.decoder(y.transpose(1, 2), dtype)
