"""Speech2Gesture baseline (Ginosar et al. CVPR'19, reference
speech2gesture.py; the port of ha2g_tpu/models/speech2gesture.py), with
the reference's parameter names: a 2D conv stack over the spectrogram,
a bilinear resize to the pose frame rate, a 1D conv U-Net, and an LS-GAN
patch discriminator on pose differences.

Convolutions pad as TensorFlow's "SAME" does (the reference's Conv1d_tf /
Conv2d_tf, speech2gesture.py:9-103): along each axis of length n with
kernel k and stride s, pad_total = max((ceil(n / s) - 1) * s + k - n, 0),
floor(pad_total / 2) of it on the left, the rest on the right, which is
asymmetric for the stride-2 convs (``nn.Conv*(padding="same")`` refuses a
stride above 1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.common import (BatchNorm, Conv1d, Conv2d, Linear,
                                      leaky_relu)


def tf_same_pad(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Zero-pad the trailing len(kernel) axes of x as TF "SAME" does."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv1d(Conv1d):
    """Conv1d on (B, C, T) with TF "SAME" padding (VALID with same=False)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 same: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride)
        self.same = same

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if self.same:
            x = tf_same_pad(x, self.kernel_size, self.stride)
        return super().forward(x, dtype)


class SameConv2d(Conv2d):
    """Conv2d on (B, C, H, W) with TF "SAME" padding (VALID with
    same=False)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 same: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride)
        self.same = same

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if self.same:
            x = tf_same_pad(x, self.kernel_size, self.stride)
        return super().forward(x, dtype)


class ConvNormRelu(nn.Sequential):
    """conv (SAME) -> batch norm -> LeakyReLU(0.2), k 3 / s 1 or
    (downsample) k 4 / s 2 unless given (speech2gesture.py:106-128); the
    reference's Sequential indices 0 (conv), 1 (norm), 2."""

    def __init__(self, in_ch: int, out_ch: int, is_2d: bool = False,
                 downsample: bool = False, k: int | None = None,
                 s: int | None = None, same: bool = True):
        k = k if k is not None else (4 if downsample else 3)
        s = s if s is not None else (2 if downsample else 1)
        conv = (SameConv2d if is_2d else SameConv1d)(in_ch, out_ch, k, s,
                                                     same)
        super().__init__(conv, BatchNorm(out_ch), nn.LeakyReLU(0.2))

    def forward(self, x, dtype: torch.dtype = torch.float32):
        return leaky_relu(self[1](self[0](x, dtype), dtype), 0.2)


class UnetUp(nn.Module):
    """x1 repeated x2 along time, cut to x2's length, plus x2, then a
    ConvNormRelu (speech2gesture.py:131-141)."""

    def __init__(self, ch: int = 256):
        super().__init__()
        self.conv = ConvNormRelu(ch, ch)

    def forward(self, x1, x2, dtype: torch.dtype = torch.float32):
        x1 = torch.repeat_interleave(x1, 2, dim=2)[:, :, :x2.shape[2]]
        return self.conv(x1 + x2, dtype)


class AudioEncoder(nn.Module):
    """Spectrogram (B, 128, S) -> (B, 256, n_frames): eight 2D
    ConvNormRelus (the last VALID), a bilinear resize of (H, W) to
    (n_frames, 1) (torch's Upsample, align_corners False, no antialias),
    and a 1D U-Net (speech2gesture.py:144-197)."""

    def __init__(self, n_frames: int):
        super().__init__()
        self.n_frames = n_frames
        self.first_net = nn.ModuleList([
            ConvNormRelu(1, 64, True), ConvNormRelu(64, 64, True, True),
            ConvNormRelu(64, 128, True), ConvNormRelu(128, 128, True, True),
            ConvNormRelu(128, 256, True), ConvNormRelu(256, 256, True, True),
            ConvNormRelu(256, 256, True),
            ConvNormRelu(256, 256, True, same=False)])
        self.down1 = nn.ModuleList([ConvNormRelu(256, 256),
                                    ConvNormRelu(256, 256)])
        for i in range(2, 7):
            setattr(self, f"down{i}", ConvNormRelu(256, 256, downsample=True))
        for i in range(1, 6):
            setattr(self, f"up{i}", UnetUp(256))

    def forward(self, spec, dtype: torch.dtype = torch.float32):
        x = spec[:, None]                                  # (B, 1, 128, S)
        for layer in self.first_net:
            x = layer(x, dtype)
        x = F.interpolate(x, size=(self.n_frames, 1), mode="bilinear",
                          align_corners=False)[..., 0]     # (B, 256, T)
        skips = [self.down1[1](self.down1[0](x, dtype), dtype)]
        for i in range(2, 7):
            skips.append(getattr(self, f"down{i}")(skips[-1], dtype))
        x = skips.pop()
        for i in range(1, 6):
            x = getattr(self, f"up{i}")(x, skips.pop(), dtype)
        return x


class Generator(nn.Module):
    """(B, 128, S) spectrogram + (B, n_pre, pose_dim) seed poses ->
    (B, n_poses, pose_dim) (speech2gesture.py:200-231)."""

    def __init__(self, n_poses: int, pose_dim: int, n_pre_poses: int):
        super().__init__()
        self.n_poses = n_poses
        self.audio_encoder = AudioEncoder(n_poses)
        self.pre_pose_encoder = nn.ModuleList([
            Linear(n_pre_poses * pose_dim, 32), BatchNorm(32), nn.ReLU(),
            Linear(32, 16)])
        self.decoder = nn.ModuleList([ConvNormRelu(256 + 16, 256)] + [
            ConvNormRelu(256, 256) for _ in range(3)])
        self.final_out = Conv1d(256, pose_dim, 1)

    def forward(self, in_spec, pre_poses, dtype: torch.dtype = torch.float32):
        audio = self.audio_encoder(in_spec, dtype)         # (B, 256, T)
        pe = self.pre_pose_encoder
        pre = pe[0](pre_poses.reshape(pre_poses.shape[0], -1), dtype)
        pre = pe[3](torch.relu(pe[1](pre, dtype)), dtype)  # (B, 16)
        x = torch.cat([audio, pre[:, :, None].expand(-1, -1, self.n_poses)
                       .to(audio.dtype)], dim=1)
        for layer in self.decoder:
            x = layer(x, dtype)
        return self.final_out(x, dtype).transpose(1, 2)


class Discriminator(nn.Module):
    """LS-GAN patch discriminator on the differences of its input
    sequence (speech2gesture.py:234-250): (B, T, pose_dim) ->
    (B, T', 1)."""

    def __init__(self, pose_dim: int):
        super().__init__()
        self.net = nn.ModuleList([
            SameConv1d(pose_dim, 64, 4, 2), nn.LeakyReLU(0.2),
            ConvNormRelu(64, 128, downsample=True),
            ConvNormRelu(128, 256, k=4, s=1), SameConv1d(256, 1, 4, 1)])

    def forward(self, poses, dtype: torch.dtype = torch.float32):
        net = self.net
        x = (poses[:, 1:] - poses[:, :-1]).transpose(1, 2)
        x = leaky_relu(net[0](x, dtype), 0.2)
        x = net[3](net[2](x, dtype), dtype)
        return net[4](x, dtype).transpose(1, 2)
