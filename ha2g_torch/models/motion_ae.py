"""The TED Expressive FGD embedder: a plain conv motion autoencoder (the
port of ha2g_tpu/models/motion_ae.py, reference scripts/model/motion_ae.py).

Its encoder is the pose encoder of ``embedding_net`` without the mu /
logvar heads, to a 128-d latent, and its decoder the same conv decoder;
both are hard-wired to 34-frame windows, as the reference's.  The state
dict has the reference's keys (``encoder.*``, ``decoder.*``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.embedding_net import PoseDecoderConv, PoseEncoderConv

N_FRAMES = 34


class MotionAE(nn.Module):
    def __init__(self, pose_dim: int, latent_dim: int = 128):
        super().__init__()
        self.pose_dim, self.latent_dim = pose_dim, latent_dim
        self.encoder = PoseEncoderConv(pose_dim, latent_dim, N_FRAMES,
                                       heads=False)
        self.decoder = PoseDecoderConv(pose_dim, N_FRAMES, latent_dim)

    def forward(self, poses, dtype: torch.dtype = torch.float32):
        """(B, 34, pose_dim) -> (reconstruction, latent), float32."""
        poses = poses.reshape(poses.shape[0], poses.shape[1], -1)
        z = self.encoder(poses, dtype)[0]
        return self.decoder(z, dtype).float(), z.float()

    @torch.no_grad()
    def embed(self, poses):
        """-> (feature, reconstruction), as the evaluator reads them."""
        recon, z = self(poses)
        return z, recon
