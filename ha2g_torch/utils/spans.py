"""Named host ranges on the profiler's clock.

``span(name, args)`` opens ``torch.profiler.record_function(name, args)``
while a torch profiler is recording (``torch.profiler.profile``, the
Trainer's ``profile_dir`` hook, or any caller's own), so each range lands
in the same Kineto trace as the device's kernels and nests under the range
open around it.  With no profiler recording it is one flag read and a
shared no-op context: nothing is entered and nothing is switched on by an
option.

Names are fixed, ``ha2g.<layer>.<part>``, with any index (window, level,
layer) in ``args``, so a trace aggregates them by name:

* synthesis loop (``synthesis.py``): ``ha2g.synth.plan`` (``prepare_fused``),
  ``ha2g.synth.upload`` (a chunk's pinned staging and upload),
  ``ha2g.synth.mel`` (the log-mel front-end and its window stack),
  ``ha2g.synth.window`` (one window: cascade, cross-fade, cat; args the
  window), ``ha2g.synth.replay`` (inside a window, the replay of its
  cascade's CUDA graph; args the window), ``ha2g.synth.pull`` (the download, the closing synchronise and
  the host concatenation);
* diffusion synthesis (``synthesis.py::DiffusionSynthesizer``):
  ``ha2g.diffuse.window`` (one window of ``generate``: condition, chain,
  cross-fade; args the window), ``ha2g.diffuse.condition`` (the audio
  encoder and the condition's build), ``ha2g.diffuse.chain`` (the window's
  denoising steps; args the step count), ``ha2g.diffuse.replay`` (inside a
  chain, the replay of its CUDA graph; args the steps it covers);
* model: ``ha2g.model.audio_encoder`` (``ResNetSE``) and
  ``ha2g.model.se_block`` (each ``SEBasicBlock``), ``ha2g.model.level``
  (``HierarchicalPoseGenerator``; args its pose width),
  ``ha2g.model.text_encoder`` (``TextEncoderTCN``),
  ``ha2g.model.gru_layer`` (one layer of ``GRU``; args the layer),
  ``ha2g.model.discriminator`` (``ConvDiscriminator``),
  ``ha2g.model.denoiser`` (one pass of the diffusion denoiser,
  ``models/diffusion.py``);
* train step (``train/hierarchy.py``): ``ha2g.train.audio``,
  ``ha2g.train.d_phase``, ``ha2g.train.g_forward``,
  ``ha2g.train.contrastive``, ``ha2g.train.diversity``,
  ``ha2g.train.g_update``;
* trainer (``train/loop.py``): ``train_step#<global iteration>`` around a
  step (the name ``Trainer(profile_dir=)`` documents),
  ``ha2g.trainer.loader_wait`` around each ``next()`` on the train loader,
  ``ha2g.trainer.read`` around the read of the metric sums.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from torch.autograd import profiler

_OFF = contextlib.nullcontext()


def span(name: Optional[str], args=None):
    """A ``record_function`` range named ``name`` (``args`` as its string)
    while a profiler records; else, or with no ``name``, a no-op
    context."""
    if name is None or not profiler._is_profiler_enabled:
        return _OFF
    return profiler.record_function(name, None if args is None else str(args))
