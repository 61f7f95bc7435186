"""Multi-granularity SE-ResNet audio encoder (reference ResNetSE34V2.py,
ResNetBlocks.py, hierarchy_net.py:10-19), in NCHW with the reference's
parameter names.

A conv stem and 4 SE-ResNet stages run over the (mels=128, frames) log-mel
image and are tapped at three depths; pixel shuffle trades channels for
time so all three taps align to the pose frame rate:

  layer2 -> conv(k2)                   -> fc -> feat_low   (B, T, 32)
  layer3 -> PixelShuffle(2) -> conv(k3) -> fc -> feat_mid   (B, T, 32)
  layer4 -> PixelShuffle(4) -> conv(k3) -> fc -> feat_high  (B, T, 32)

A speaker embedding maps to softmax weights over the 3 scales per level,
which blend the taps into one feature sequence per hierarchy level.

Layout notes against the JAX package (NHWC): its channel-major
``pixel_shuffle`` ``(c i j)`` is torch's ``F.pixel_shuffle`` on NCHW, and its
tap fold ``b h w c -> b w (c h)`` is ``permute(0, 3, 1, 2)`` then a reshape.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.common import BatchNorm, Conv2d, Linear
from ha2g_torch.utils.spans import span


def _he_conv(*args, **kw) -> Conv2d:
    conv = Conv2d(*args, **kw)
    conv.init = "kaiming_normal_fan_out"  # ResNetSE34V2.py:89-91
    return conv


class SELayer(nn.Module):
    """Squeeze-and-excitation, reduction 8 (ResNetBlocks.py:81-96)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        # index 1 holds the ReLU so the linears keep the keys fc.0 and fc.2
        self.fc = nn.ModuleList([Linear(channels, channels // reduction),
                                 nn.ReLU(),
                                 Linear(channels // reduction, channels)])

    def forward(self, x, dtype):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc[2](F.relu(self.fc[0](y, dtype)), dtype))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv3x3 -> relu -> bn -> conv3x3 -> bn -> SE -> +res -> relu
    (ResNetBlocks.py:7-37)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _he_conv(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _he_conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.ModuleList([
                _he_conv(in_ch, planes, 1, stride, bias=False),
                BatchNorm(planes)])

    def forward(self, x, dtype):
        with span("ha2g.model.se_block"):
            y = self.bn1(F.relu(self.conv1(x, dtype)), dtype)
            y = self.se(self.bn2(self.conv2(y, dtype), dtype), dtype)
            res = x
            if self.downsample is not None:
                res = self.downsample[1](self.downsample[0](x, dtype), dtype)
            return F.relu(y + res)


def _tap_rows(n_mels: int, n_stages_down: int, shuffle: int, k: int) -> int:
    """Frequency rows left after a tap's pixel shuffle and VALID conv."""
    h = n_mels
    for _ in range(n_stages_down):
        h = (h - 1) // 2 + 1
    return h * shuffle - (k - 1)


class ResNetSE(nn.Module):
    """(B, n_mels, T_spec) log-mel + (B,) speaker ids ->
    (weight (B, 3, L), feat_low, feat_mid, feat_high, blend (L, B, T, 32))."""

    def __init__(self, n_speakers: int, pose_level: int = 3, n_out: int = 32,
                 layers=(3, 4, 6, 3), filters=(32, 64, 128, 256),
                 n_mels: int = 128):
        super().__init__()
        if n_speakers <= 0:
            raise ValueError("the hierarchy audio encoder needs n_speakers > 0")
        self.pose_level = pose_level
        self.conv1 = _he_conv(1, filters[0], 3, 1, 1)
        self.bn1 = BatchNorm(filters[0])
        in_ch = filters[0]
        for s, (planes, blocks) in enumerate(zip(filters, layers)):
            stride = 1 if s == 0 else 2
            stage = [SEBasicBlock(in_ch, planes, stride)]
            stage += [SEBasicBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{s + 1}", nn.ModuleList(stage))
            in_ch = planes
        taps = (("low", filters[1], 1, 64, 2, 1),
                ("mid", filters[2], 2, 32, 3, 2),
                ("high", filters[3], 4, 16, 3, 3))
        for name, ch, shuffle, conv_ch, k, downs in taps:
            setattr(self, f"conv_{name}",
                    Conv2d(ch // (shuffle * shuffle), conv_ch, k))
            setattr(self, f"bn_{name}", BatchNorm(conv_ch))
            rows = _tap_rows(n_mels, downs, shuffle, k)
            setattr(self, f"fc_{name}", Linear(conv_ch * rows, n_out))
        self.speaker_embedding = nn.ModuleList([nn.Embedding(n_speakers, 16),
                                                Linear(16, 16)])
        self.fc1 = Linear(16, 32)
        self.fc2 = Linear(32, 3 * pose_level)

    def _tap(self, name: str, feat, shuffle: int, dtype):
        if shuffle > 1:
            feat = F.pixel_shuffle(feat, shuffle)
        conv, bn, fc = (getattr(self, f"{p}_{name}") for p in ("conv", "bn", "fc"))
        feat = bn(F.relu(conv(feat, dtype)), dtype)      # (B, C, H, W)
        B, C, H, W = feat.shape
        feat = feat.permute(0, 3, 1, 2).reshape(B, W, C * H)
        return fc(feat, dtype)                           # (B, W, 32)

    def forward(self, spec, vid_indices, dtype: torch.dtype = torch.float32):
        with span("ha2g.model.audio_encoder"):
            x = spec[:, None]
            x = self.bn1(F.relu(self.conv1(x, dtype)), dtype)
            feats = []
            for s in range(4):
                for block in getattr(self, f"layer{s + 1}"):
                    x = block(x, dtype)
                feats.append(x)
            feat_low = self._tap("low", feats[1], 1, dtype)
            feat_mid = self._tap("mid", feats[2], 2, dtype)
            feat_high = self._tap("high", feats[3], 4, dtype)

            z = self.speaker_embedding[1](
                self.speaker_embedding[0](vid_indices), dtype)
            h = F.elu(self.fc1(F.elu(z), dtype))
            w = self.fc2(h, dtype).reshape(-1, 3, self.pose_level)
            weight = torch.softmax(w, dim=1)             # over the 3 scales
            stacked = torch.stack([feat_low, feat_mid, feat_high], dim=1)
            blend = torch.einsum("bsl,bstf->lbtf", weight, stacked)
            return weight, feat_low, feat_mid, feat_high, blend
