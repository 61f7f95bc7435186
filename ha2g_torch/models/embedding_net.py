"""The TED Gesture FGD embedder: ``EmbeddingNet`` in its pose mode (the
port of ha2g_tpu/models/embedding_net.py, reference
scripts/model/embedding_net.py).

A conv pose encoder maps a 34-frame direction-vector window to a 32-d
feature (``fc_mu``; the evaluator reads it as the feature), and a conv
decoder with transposed convolutions reconstructs the window.  Modules and
their indices follow the reference's ``nn.Sequential`` layout, so the state
dict has its keys (``pose_encoder.net.0.0.weight``, ``decoder.pre_net.1
.running_var``, ...) and ``convert.embedding_net_pose_state`` fills it from
the JAX package's parameters.

Only the pose mode is ported; the context encoder and the GRU decoder of
the joint-embedding baseline are not.  Batch norm runs in eval mode with
its running statistics (eps 1e-5, as flax's here).  ``LeakyReLU(True)`` in
the reference is a slope of 1.0, the identity, and is kept as such.
Convolutions take (B, C, T); the conv features are flattened channel-major
(``b c t -> b (c t)``), as the reference's ``view``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.common import BatchNorm, Conv1d, Linear, leaky_relu

# the decoder's pre-net widths by window length (embedding_net.py:180-186)
PRE_WIDTHS = {34: (64, 136), 64: (128, 256)}


class LeakyReLU(nn.Module):
    """A parameter-free slot of the reference's Sequential; slope 1.0 is
    the identity of ``LeakyReLU(True)``."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return leaky_relu(x, self.slope)


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


class PoseEncoderConv(nn.Module):
    """(B, T, pose_dim) -> latent (B, latent_dim).  With ``heads`` (the
    EmbeddingNet encoder) the latent goes on through ``fc_mu`` /
    ``fc_logvar`` and the feature is mu; without (the MotionAE encoder) the
    last Linear's output is the feature."""

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

    def forward(self, poses):
        """-> (feature, mu, logvar); mu and logvar are None without heads.
        The encoding is not variational: the feature is mu."""
        x = self.net(poses.transpose(1, 2)).flatten(1)
        x = self.out_net(x)
        if not self.heads:
            return x, None, None
        mu = self.fc_mu(x)
        return mu, mu, self.fc_logvar(x)


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
            nn.ConvTranspose1d(4, 32, 3), BatchNorm(32), LeakyReLU(0.2),
            nn.ConvTranspose1d(32, 32, 3), BatchNorm(32), LeakyReLU(0.2),
            Conv1d(32, 32, 3), Conv1d(32, pose_dim, 3))

    def forward(self, feat):
        x = self.pre_net(feat)
        x = x.view(x.shape[0], 4, -1)
        return self.net(x).transpose(1, 2)


class EmbeddingNet(nn.Module):
    """``mode="pose"``: the conv autoencoder, the frozen FGD feature
    extractor of TED Gesture (the gesture_autoencoder config)."""

    def __init__(self, pose_dim: int, n_frames: int, mode: str = "pose"):
        super().__init__()
        if mode != "pose":
            raise NotImplementedError(
                f"EmbeddingNet mode {mode!r}: only the pose mode is ported; "
                "the joint-embedding parts wait for ROADMAP A.5")
        self.pose_dim, self.n_frames = pose_dim, n_frames
        self.pose_encoder = PoseEncoderConv(pose_dim, 32, n_frames)
        self.decoder = PoseDecoderConv(pose_dim, n_frames, 32)

    def forward(self, poses):
        """(B, T, pose_dim) -> (feature, mu, logvar, reconstruction)."""
        poses = poses.reshape(poses.shape[0], poses.shape[1], -1)
        feat, mu, logvar = self.pose_encoder(poses)
        return feat, mu, logvar, self.decoder(feat)

    @torch.no_grad()
    def embed(self, poses):
        """-> (feature, reconstruction), as the evaluator reads them."""
        feat, _, _, recon = self(poses)
        return feat, recon
