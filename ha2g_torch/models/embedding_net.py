"""The joint text/audio/pose embedding network and the TED Gesture FGD
embedder (the port of ha2g_tpu/models/embedding_net.py, reference
scripts/model/embedding_net.py).

* ``PoseEncoderConv``: a conv pose encoder of a 34-frame direction-vector
  window to a 32-d latent with ``fc_mu`` / ``fc_logvar`` heads (the
  feature is mu unless the encoding is variational);
* ``PoseDecoderConv``: a Linear pre-net and transposed convolutions back
  to the window; ``PoseDecoderGRU``: the pre-pose feature and the latent
  repeated over the window into a 4-layer bi-GRU(300) (kernel B1) and an
  MLP; ``PoseDecoderFC`` (API parity, no shipped config uses it);
* ``ContextEncoder``: the TCN text encoder and the raw-waveform encoder
  into a unidirectional GRU(256, 2 layers) and a variational head that
  always reparameterises from the caller's generator;
* ``EmbeddingNet``: mode ``"pose"`` is the conv autoencoder, the frozen FGD
  feature extractor of TED Gesture (the gesture_autoencoder config);
  otherwise (joint_embedding) the context encoder, the pose encoder and the
  GRU decoder, decoding from the speech latent (``"speech"``), the pose
  latent (``"pose"``) or one of the two by a coin per batch (``"random"``).

Modules and their indices follow the reference's ``nn.Sequential``
layouts, so the state dicts have its keys (``pose_encoder.net.0.0.weight``,
``decoder.pre_pose_net.1.running_var``, ``context_encoder.gru.weight_ih_l0``
...), the layout of ``ha2g_tpu/export_torch.py``.  ``LeakyReLU(True)`` in
the reference is a slope of 1.0, the identity, and is kept as such.
Convolutions take (B, C, T); the conv features are flattened channel-major
(``b c t -> b (c t)``), as the reference's ``view``.  Every forward takes
the compute dtype (batch norm normalises in float32) and the generator of
the dropout masks and the reparameterisation noise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.common import (BatchNorm, Conv1d, ConvTranspose1d,
                                      Linear, leaky_relu, reparameterize)
from ha2g_torch.models.multimodal_context import WavEncoder
from ha2g_torch.models.tcn import TextEncoderTCN
from ha2g_torch.ops.gru import GRU

# the decoder's pre-net widths by window length (embedding_net.py:180-186)
PRE_WIDTHS = {34: (64, 136), 64: (128, 256)}
MODES = ("pose", "speech", "random")


class LeakyReLU(nn.Module):
    """A parameter-free slot of the reference's Sequential; slope 1.0 is
    the identity of ``LeakyReLU(True)``."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x, dtype=None):
        return leaky_relu(x, self.slope)


class ReLU(nn.Module):
    """A parameter-free ReLU slot of the reference's Sequential."""

    def forward(self, x, dtype=None):
        return F.relu(x)


def _run(seq: nn.Sequential, x, dtype: torch.dtype):
    """A Sequential of the layers above, each called with the dtype."""
    for m in seq:
        x = _run(m, x, dtype) if isinstance(m, nn.Sequential) else m(x, dtype)
    return x


def conv_norm_relu(in_ch: int, out_ch: int, downsample: bool = False):
    """Reference ConvNormRelu: conv k=3 s=1 (or k=4 s=2), batch norm,
    LeakyReLU(0.2)."""
    k, s = (4, 2) if downsample else (3, 1)
    return nn.Sequential(Conv1d(in_ch, out_ch, k, stride=s),
                         BatchNorm(out_ch), LeakyReLU(0.2))


def _encoded_frames(n_frames: int) -> int:
    t = n_frames - 4              # two k=3 convs
    t = (t - 4) // 2 + 1          # the k=4 s=2 conv
    return t - 2                  # the last k=3 conv


def _pre_pose_net(in_size: int) -> nn.Sequential:
    """The decoders' pre-pose MLP: Linear(32), batch norm, ReLU,
    Linear(32)."""
    return nn.Sequential(Linear(in_size, 32), BatchNorm(32), ReLU(),
                         Linear(32, 32))


class PoseEncoderConv(nn.Module):
    """(B, T, pose_dim) -> latent (B, latent_dim).  With ``heads`` (the
    EmbeddingNet encoder) the latent goes on through ``fc_mu`` /
    ``fc_logvar``; without (the MotionAE encoder) the last Linear's output
    is the feature."""

    def __init__(self, pose_dim: int, latent_dim: int = 32,
                 n_frames: int = 34, heads: bool = True):
        super().__init__()
        self.net = nn.Sequential(
            conv_norm_relu(pose_dim, 32), conv_norm_relu(32, 64),
            conv_norm_relu(64, 64, downsample=True), Conv1d(64, 32, 3))
        self.out_net = nn.Sequential(
            Linear(32 * _encoded_frames(n_frames), 256), BatchNorm(256),
            LeakyReLU(1.0), Linear(256, 128), BatchNorm(128), LeakyReLU(1.0),
            Linear(128, latent_dim))
        self.heads = heads
        if heads:
            self.fc_mu = Linear(latent_dim, latent_dim)
            self.fc_logvar = Linear(latent_dim, latent_dim)

    def forward(self, poses, dtype: torch.dtype = torch.float32,
                variational: bool = False,
                generator: torch.Generator | None = None):
        """-> (feature, mu, logvar); mu and logvar are None without heads.
        The feature is mu, or a draw around it when ``variational``."""
        x = _run(self.net, poses.transpose(1, 2), dtype).flatten(1)
        x = _run(self.out_net, x, dtype)
        if not self.heads:
            return x, None, None
        mu, logvar = self.fc_mu(x, dtype), self.fc_logvar(x, dtype)
        z = reparameterize(mu, logvar, generator) if variational else mu
        return z, mu, logvar


class PoseDecoderConv(nn.Module):
    """latent (B, latent_dim) -> (B, n_frames, pose_dim): a Linear pre-net
    to 4 channels of n_frames - 4, two transposed convs (+2 frames each),
    two convs (-2 each)."""

    def __init__(self, pose_dim: int, n_frames: int = 34,
                 latent_dim: int = 32):
        super().__init__()
        if n_frames not in PRE_WIDTHS:
            raise ValueError(f"the reference decoder supports "
                             f"{sorted(PRE_WIDTHS)} frames, not {n_frames}")
        w_hidden, w_out = PRE_WIDTHS[n_frames]
        self.pre_net = nn.Sequential(
            Linear(latent_dim, w_hidden), BatchNorm(w_hidden),
            LeakyReLU(1.0), Linear(w_hidden, w_out))
        self.net = nn.Sequential(
            ConvTranspose1d(4, 32, 3), BatchNorm(32), LeakyReLU(0.2),
            ConvTranspose1d(32, 32, 3), BatchNorm(32), LeakyReLU(0.2),
            Conv1d(32, 32, 3), Conv1d(32, pose_dim, 3))

    def forward(self, feat, dtype: torch.dtype = torch.float32):
        x = _run(self.pre_net, feat, dtype)
        x = x.view(x.shape[0], 4, -1)
        return _run(self.net, x, dtype).transpose(1, 2)


class PoseDecoderGRU(nn.Module):
    """latent (B, 32) and pre-poses (B, n_pre, pose_dim) -> (B, n_frames,
    pose_dim): [pre-pose feature, latent] repeated over the window, a
    4-layer bi-GRU(300) with dropout 0.3 (kernel B1), the directions
    summed, Linear(150), LeakyReLU(True), Linear(pose_dim)
    (embedding_net.py:130-162)."""

    def __init__(self, pose_dim: int, n_frames: int, n_pre_poses: int = 4,
                 hidden_size: int = 300, latent_dim: int = 32):
        super().__init__()
        self.n_frames, self.hidden_size = n_frames, hidden_size
        self.pre_pose_net = _pre_pose_net(n_pre_poses * pose_dim)
        self.gru = GRU(32 + latent_dim, hidden_size, 4, dropout=0.3)
        self.out = nn.Sequential(Linear(hidden_size, hidden_size // 2),
                                 LeakyReLU(1.0),
                                 Linear(hidden_size // 2, pose_dim))

    def forward(self, latent_code, pre_poses,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        pre = _run(self.pre_pose_net, pre_poses.flatten(1), dtype)
        feat = torch.cat([pre.to(dtype), latent_code.to(dtype)], dim=1)
        feat = feat[:, None].expand(-1, self.n_frames, -1)
        out, _ = self.gru(feat, dtype, generator)
        H = self.hidden_size
        return _run(self.out, out[..., :H] + out[..., H:], dtype)


class PoseDecoderFC(nn.Module):
    """A pure-FC pose decoder (embedding_net.py:85-127), kept for API
    parity: the latent (and, with ``use_pre_poses``, the pre-pose feature)
    through Linear / batch norm / ReLU blocks of 128, 128, 256 and 512 to
    (B, gen_length, pose_dim)."""

    def __init__(self, pose_dim: int, gen_length: int,
                 use_pre_poses: bool = False, n_pre_poses: int = 4,
                 latent_dim: int = 32):
        super().__init__()
        self.pose_dim, self.gen_length = pose_dim, gen_length
        self.use_pre_poses = use_pre_poses
        in_size = latent_dim
        if use_pre_poses:
            self.pre_pose_net = _pre_pose_net(n_pre_poses * pose_dim)
            in_size += 32
        layers = []
        for width in (128, 128, 256, 512):
            layers += [Linear(in_size, width), BatchNorm(width), ReLU()]
            in_size = width
        self.net = nn.Sequential(*layers,
                                 Linear(in_size, gen_length * pose_dim))

    def forward(self, latent_code, pre_poses=None,
                dtype: torch.dtype = torch.float32):
        feat = latent_code.to(dtype)
        if self.use_pre_poses:
            pre = _run(self.pre_pose_net, pre_poses.flatten(1), dtype)
            feat = torch.cat([pre.to(dtype), feat], dim=1)
        out = _run(self.net, feat, dtype)
        return out.reshape(-1, self.gen_length, self.pose_dim)


class ContextEncoder(nn.Module):
    """Word tokens (B, T) and a raw waveform (B, n) -> a 32-d variational
    context latent (z, mu, logvar) (embedding_net.py:220-259).  The TCN
    keeps its default dropout (0.3, and 0.1 on the embedding), as in the
    JAX package."""

    def __init__(self, n_words: int, word_embed_dim: int = 300,
                 hidden_size: int = 300, n_layers: int = 4):
        super().__init__()
        self.text_encoder = TextEncoderTCN(n_words, word_embed_dim,
                                           hidden_size, n_layers)
        self.audio_encoder = WavEncoder()
        self.gru = GRU(64, 256, 2, bidirectional=False)
        self.out = nn.Sequential(Linear(256, 128), BatchNorm(128), ReLU(),
                                 Linear(128, 32))
        self.fc_mu = Linear(32, 32)
        self.fc_logvar = Linear(32, 32)

    def forward(self, in_text, in_audio, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        text_feat = self.text_encoder(in_text, dtype, generator)
        audio_feat = self.audio_encoder(in_audio, dtype)
        x = torch.cat([audio_feat.to(dtype), text_feat.to(dtype)], dim=2)
        out, _ = self.gru(x, dtype, generator)
        h = _run(self.out, out[:, -1], dtype)
        mu, logvar = self.fc_mu(h, dtype), self.fc_logvar(h, dtype)
        return reparameterize(mu, logvar, generator), mu, logvar


class EmbeddingNet(nn.Module):
    """``mode="pose"``: the conv autoencoder, the frozen FGD feature
    extractor of TED Gesture (the gesture_autoencoder config).  Otherwise
    (joint_embedding): the context encoder, the pose encoder and the GRU
    decoder, the decode source chosen per call (embedding_net.py:
    262-308)."""

    def __init__(self, pose_dim: int, n_frames: int, mode: str = "pose",
                 n_words: int = 0, word_embed_dim: int = 300,
                 n_pre_poses: int = 4):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"EmbeddingNet mode {mode!r} is not one of "
                             f"{MODES}")
        self.pose_dim, self.n_frames, self.mode = pose_dim, n_frames, mode
        if mode != "pose":
            self.context_encoder = ContextEncoder(n_words, word_embed_dim)
        self.pose_encoder = PoseEncoderConv(pose_dim, 32, n_frames)
        self.decoder = PoseDecoderConv(pose_dim, n_frames, 32) \
            if mode == "pose" else \
            PoseDecoderGRU(pose_dim, n_frames, n_pre_poses)

    def forward(self, in_text, in_audio, pre_poses, poses,
                input_mode: str | None = None,
                variational_encoding: bool = False,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        """-> (context_feat, context_mu, context_logvar, poses_feat,
        pose_mu, pose_logvar, out_poses), None where a part did not run.
        ``input_mode`` (the net's mode by default) picks the latent the
        decoder reads; ``"random"`` draws one coin from ``generator`` per
        call (True: the context latent), kept in ``self.last_coin`` (a
        0-d bool tensor on the device)."""
        mode = input_mode or self.mode
        context = (None, None, None)
        if self.mode != "pose" and in_text is not None \
                and in_audio is not None:
            context = self.context_encoder(in_text, in_audio, dtype,
                                           generator)
        pose = (None, None, None)
        if poses is not None:
            poses = poses.reshape(poses.shape[0], poses.shape[1], -1)
            pose = self.pose_encoder(poses, dtype, variational_encoding,
                                     generator)
        if mode == "random":
            coin = torch.rand((), generator=generator,
                              device=generator.device) < 0.5
            self.last_coin = coin.to(context[0].device)
            latent = torch.where(self.last_coin, context[0].to(dtype),
                                 pose[0].to(dtype))
        else:
            latent = context[0] if mode == "speech" else pose[0]
        if self.mode == "pose":
            out = self.decoder(latent, dtype)
        else:
            out = self.decoder(latent, pre_poses, dtype, generator)
        return (*context, *pose, out.float())

    @torch.no_grad()
    def embed(self, poses):
        """Pose mode: -> (feature, reconstruction), as the evaluator reads
        them."""
        out = self(None, None, None, poses)
        return out[3], out[6]
