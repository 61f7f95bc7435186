"""Trimodal-context GAN baseline (Yoon et al. 2020; reference
multimodal_context_net.py, the port of
ha2g_tpu/models/multimodal_context.py), with the reference's parameter
names: a raw-waveform conv encoder, the shared TCN text encoder, a
speaker-z conditioned bi-GRU pose generator.  Its discriminator is the
hierarchy's ``ConvDiscriminator`` with slope 1.0.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.common import BatchNorm, Conv1d, leaky_relu
from ha2g_torch.models.hierarchy import HierarchicalPoseGenerator


class WavEncoder(nn.Module):
    """Raw 16 kHz waveform (B, n) -> (B, 34, 32) frame features: four
    strided convs (strides 5, 6, 6, 6; the first pads 1600), three batch
    norms and LeakyReLU(0.3) (multimodal_context_net.py:9-28).
    ``feat_extractor`` keeps the reference's Sequential indices."""

    def __init__(self):
        super().__init__()
        self.feat_extractor = nn.ModuleList([
            Conv1d(1, 16, 15, stride=5, padding=1600), BatchNorm(16),
            nn.LeakyReLU(0.3),
            Conv1d(16, 32, 15, stride=6), BatchNorm(32), nn.LeakyReLU(0.3),
            Conv1d(32, 64, 15, stride=6), BatchNorm(64), nn.LeakyReLU(0.3),
            Conv1d(64, 32, 15, stride=6)])

    def forward(self, wav, dtype: torch.dtype = torch.float32):
        fe = self.feat_extractor
        x = wav[:, None]                                   # (B, 1, n)
        for i in (0, 3, 6):
            x = leaky_relu(fe[i + 1](fe[i](x, dtype), dtype), 0.3)
        return fe[9](x, dtype).transpose(1, 2)             # (B, T, 32)


class PoseGenerator(HierarchicalPoseGenerator):
    """The hierarchy level cell's dataflow with its own waveform encoder:
    [pre_seq (pose_dim+1), audio 32, text 32, speaker z 16] -> bi-GRU,
    directions summed -> Linear(H/2) -> leaky_relu(1.0) -> Linear(pose_dim)
    (multimodal_context_net.py:64-160; the reference's LeakyReLU(True)
    binds slope 1.0, the identity, kept explicit as in the JAX package)."""

    slope = 1.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.audio_encoder = WavEncoder()

    def forward(self, pre_seq, in_text, in_audio, vid_indices,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        """pre_seq (B, T, pose_dim+1), in_text (B, T) tokens, in_audio
        (B, n_samples) float waveform, vid_indices (B,) -> (out, z, mu,
        logvar)."""
        audio_feat = None
        if self.input_context in ("both", "audio"):
            audio_feat = self.audio_encoder(in_audio, dtype)
        return super().forward(pre_seq, in_text, audio_feat, vid_indices,
                               dtype, generator)
