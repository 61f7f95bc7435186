"""Hierarchical pose inferer: audio encoder wrapper, one level's generator
cell and the conv discriminator (reference hierarchy_net.py:10-242), with
the reference's parameter names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.common import (BatchNorm, Conv1d, Linear, leaky_relu,
                                      reparameterize)
from ha2g_torch.models.resnet_se import ResNetSE
from ha2g_torch.models.tcn import TextEncoderTCN
from ha2g_torch.ops.gru import GRU
from ha2g_torch.parallel.mesh import draw_rows
from ha2g_torch.utils.spans import span

Z_SIZE = 16
FEAT_SIZE = 32


class HierarchicalWavEncoder(nn.Module):
    """(B, 128, T_spec) log-mel + (B,) speaker ids ->
    (weight, feat_low, feat_mid, feat_high, blend (L, B, T, 32))."""

    def __init__(self, pose_level: int, n_speakers: int):
        super().__init__()
        self.feat_extractor = ResNetSE(n_speakers, pose_level=pose_level,
                                       n_out=FEAT_SIZE)

    def forward(self, spec, vid_indices, dtype: torch.dtype = torch.float32):
        return self.feat_extractor(spec, vid_indices, dtype)


class HierarchicalPoseGenerator(nn.Module):
    """One hierarchy level's decoder cell.

    Input per frame: [pre_seq (level_dim+1), audio feat 32, text feat 32,
    speaker z 16] (by ``input_context`` / ``z_type``) -> 4-layer bi-GRU,
    directions summed -> Linear(H/2) -> leaky_relu(0.01) -> Linear(level_dim).

    The speaker-z layers (the JAX package's ``SpeakerZ``) sit directly on
    the cell as ``speaker_embedding`` / ``speaker_mu`` / ``speaker_logvar``,
    as in the reference's state dicts; see ``speaker_z``.  ``slope`` is the
    output LeakyReLU's (hierarchy_net.py:91).
    """

    slope = 0.01

    def __init__(self, pose_dim: int, n_words: int, n_speakers: int,
                 word_embed_dim: int = 300, hidden_size: int = 300,
                 n_layers: int = 4, dropout: float = 0.3,
                 emb_dropout: float = 0.1, z_type: str = "speaker",
                 input_context: str = "both", freeze_wordembed: bool = False):
        super().__init__()
        if z_type not in ("speaker", "random", "none"):
            raise ValueError(f"unknown z_type {z_type!r}")
        if input_context not in ("both", "audio", "text", "none"):
            raise ValueError(f"unknown input_context {input_context!r}")
        self.pose_dim = pose_dim
        self.hidden_size = hidden_size
        self.z_type = z_type
        self.input_context = input_context
        self.text_encoder = TextEncoderTCN(
            n_words, embed_dim=word_embed_dim, hidden_size=hidden_size,
            n_layers=n_layers, dropout=dropout, emb_dropout=emb_dropout,
            freeze=freeze_wordembed)
        if z_type == "speaker":
            self.speaker_embedding = nn.ModuleList(
                [nn.Embedding(n_speakers, Z_SIZE), Linear(Z_SIZE, Z_SIZE)])
            self.speaker_mu = Linear(Z_SIZE, Z_SIZE)
            self.speaker_logvar = Linear(Z_SIZE, Z_SIZE)
        in_size = pose_dim + 1
        in_size += FEAT_SIZE * {"both": 2, "audio": 1, "text": 1,
                                "none": 0}[input_context]
        in_size += Z_SIZE if z_type != "none" else 0
        self.gru = GRU(in_size, hidden_size, n_layers, dropout=dropout)
        self.out = nn.ModuleList([Linear(hidden_size, hidden_size // 2),
                                  nn.LeakyReLU(self.slope),
                                  Linear(hidden_size // 2, pose_dim)])

    def speaker_z(self, vid_indices, batch: int, dtype,
                  generator: torch.Generator):
        """-> (z, mu, logvar) (hierarchy_net.py:76-82, 114-123); 'random'
        draws N(0, I) and 'none' returns Nones."""
        if self.z_type == "none":
            return None, None, None
        if generator is None:
            raise ValueError(f"z_type {self.z_type!r} needs a torch.Generator "
                             "for its noise")
        if self.z_type == "random":
            z = draw_rows((batch, Z_SIZE), lambda shape: torch.randn(
                shape, generator=generator, device=generator.device))
            return z.to(vid_indices.device), None, None
        emb = self.speaker_embedding[1](
            self.speaker_embedding[0](vid_indices), dtype)
        mu = self.speaker_mu(emb, dtype)
        logvar = self.speaker_logvar(emb, dtype)
        return reparameterize(mu, logvar, generator), mu, logvar

    def forward(self, pre_seq, in_text, audio_feat_seq, vid_indices,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        """pre_seq (B, T, pose_dim+1), in_text (B, T) tokens, audio_feat_seq
        (B, T, 32), vid_indices (B,) -> (out (B, T, pose_dim), z, mu, logvar).
        ``generator`` supplies the speaker-z noise and the dropout masks."""
        with span("ha2g.model.level", self.pose_dim):
            B, T, _ = pre_seq.shape
            text_feat = self.text_encoder(in_text, dtype, generator)
            z, mu, logvar = self.speaker_z(vid_indices, B, dtype, generator)
            parts = [pre_seq]
            if self.input_context in ("both", "audio"):
                parts.append(audio_feat_seq)
            if self.input_context in ("both", "text"):
                parts.append(text_feat)
            if z is not None:
                parts.append(z[:, None, :].expand(B, T, z.shape[-1]))
            in_data = torch.cat([p.to(dtype) for p in parts], dim=2)
            out, _ = self.gru(in_data, dtype, generator)
            H = self.hidden_size
            out = out[..., :H] + out[..., H:]
            out = leaky_relu(self.out[0](out, dtype), self.slope)
            return self.out[2](out, dtype), z, mu, logvar


class ConvDiscriminator(nn.Module):
    """Conv stack -> 4-layer bi-GRU(64) -> per-step Linear(1) ->
    Linear(T-6, 1) -> sigmoid (hierarchy_net.py:197-242; the reference
    hard-codes Linear(28, 1) for 34 frames).  ``pre_conv`` keeps the
    reference's Sequential indices: convs at 0, 3, 6, batch norms at 1, 4,
    LeakyReLU(``slope``) at 2, 5.  (B, T, pose_dim) -> (B, 1)."""

    def __init__(self, input_size: int, n_poses: int, hidden_size: int = 64,
                 slope: float = 0.01, dropout: float = 0.3):
        super().__init__()
        self.hidden_size = hidden_size
        self.slope = slope
        self.pre_conv = nn.ModuleList([
            Conv1d(input_size, 16, 3), BatchNorm(16), nn.LeakyReLU(slope),
            Conv1d(16, 8, 3), BatchNorm(8), nn.LeakyReLU(slope),
            Conv1d(8, 8, 3)])
        self.gru = GRU(8, hidden_size, 4, dropout=dropout)
        self.out = Linear(hidden_size, 1)
        self.out2 = Linear(n_poses - 6, 1)

    def forward(self, poses, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        with span("ha2g.model.discriminator"):
            pc = self.pre_conv
            x = poses.transpose(1, 2)                    # (B, C, T)
            x = leaky_relu(pc[1](pc[0](x, dtype), dtype), self.slope)
            x = leaky_relu(pc[4](pc[3](x, dtype), dtype), self.slope)
            x = pc[6](x, dtype).transpose(1, 2)          # (B, T-6, 8)
            out, _ = self.gru(x, dtype, generator)
            H = self.hidden_size
            out = out[..., :H] + out[..., H:]
            out = self.out(out, dtype)[..., 0]           # (B, T-6)
            return torch.sigmoid(self.out2(out, dtype))
