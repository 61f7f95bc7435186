"""PyTorch/CUDA port of HA2G co-speech gesture generation for NVIDIA Hopper.

A second package beside the JAX reference (``ha2g_tpu``); it imports
torch, numpy and einops and nothing of the JAX package.  The serving path
of the hierarchy model runs end to end: log-mel front-end -> SE-ResNet
audio encoder -> per-level generator cells (TCN text encoder, speaker z,
bidirectional GRU whose recurrence is the hand-written CUDA kernel in
``csrc/gru_recurrence.cu``) -> level cascade -> sliding-window synthesis.
Training runs the GAN step (``train/hierarchy.py``, the contrastive loss
on the kernels of ``csrc/contrastive.cu``) under the epoch ``Trainer``
(``train/loop.py``: FGD evaluation, checkpoints, resume), driven by
``python -m ha2g_torch.cli train|eval|synthesize``; under ``torchrun`` on
several processes, data-parallel or FSDP-sharded, as one global batch
(``parallel/mesh.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""
