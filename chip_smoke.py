#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ha2g_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit, versions, TF32 off, and the
   build of every kernel from csrc/ (one nvcc a source, all at once,
   sm_90a);
2. kernels: each kernel against its plain PyTorch version on the card:
   B1 (the GRU recurrence, thread-block-cluster kernels) forward at the
   serving and train shapes, ragged hidden slices and row groups, fp32
   and bf16; B1's backward kernel against its plain loop; B1's autograd
   (kernel forward + kernel backward) against autograd through the plain
   version at the train shapes; B2-B4 (the flash contrastive loss) on
   random rows at the train step's N = 96 * 34 and TED-Gesture's 256 * 34,
   and at a ragged N, D = 32 and 128; on aligned rows against their plain
   versions in float64 (tolerances that an fp32 product meets and a TF32
   one does not); finite on rows with exact duplicates; the denoiser's
   fused residual add and layer norm at the diffusion cell's (4352, 512)
   bf16, 4349 rows, the broadcast positional table and float32;
3. serving: synthesis requests through make_synthesizer(...).generate and
   generate_fused on the full-width 6-level TED Expressive hierarchy
   (hidden 300, 4-layer bi-GRU, full SE-ResNet, bf16 compute, random
   weights from a seed): output shape, finiteness and the B1 launch counts
   of every request; then the card's fp32 result against the same port on
   the CPU (plain versions) for a short clip, and the CPU's FLOP count
   (``utils/roofline.count_flops``) of one window; then the diffusion
   cell's serving path, ``generate`` on a full-width bf16 DiffGesture
   over 64 clips of 3 windows with a card generator, its second call
   replaying each window's graph: 17 fused add and layer norm launches a
   step and no other kernel of the port;
4. training: HierarchySystem.train_step of the same hierarchy with
   configs_expressive/hierarchy.yaml (batch 96, bf16, every loss weight),
   one warm-up step and four GAN steps on random batches, then of the
   full-width 3-level TED Gesture hierarchy with configs/hierarchy.yaml
   (batch 256: B2-B4 at N = 8704), one warm-up and two GAN steps: every
   loss term finite, the launch counts of B1 (forward, backward calls and
   backward kernel) and B2-B4 of every step against the dataflow's, step
   times and peak memory; one GAN step of each under torch.profiler, with
   B2-B4's share of its device time, and the FLOPs of a GAN step; then an
   fp32 step of a narrow hierarchy on the card against the same port on
   the CPU, every loss and gradient, and the two FLOP counts equal;
5. times on the card: end-to-end ms per request and, under
   torch.profiler, where its device time goes and the device's idle
   share; each kernel (CUDA events, median), its bound, its plain
   version, and the library call that computes the same function where
   there is one; B1 forward at B = 1, 8, 16, 96 and 256 with its
   clusters' occupancy and waves; B1's backward kernel and whole backward
   call; B2-B4's device time a launch (profiler) and the epilogue's
   instructions a pair in their SASS; the fused add and layer norm a
   launch (profiler; and in a CUDA graph over operands that L2 cannot
   hold) beside its plain version's add and layer norm and the library
   layer norm alone;
6. the training driver: the pinned-memory train loader on the card
   against the host gather; then ``python -m ha2g_torch.cli`` in process
   at full width (configs_expressive/hierarchy.yaml, batch 96, bf16) on
   stored synthetic clips with a seeded random MotionAE FGD embedder:
   ``train`` for 2 epochs (GAN steps in the second), ``train --resume``
   for a third, ``eval --bc``, ``synthesize`` (host and fused loop), with
   the launch counts of every kernel against the dataflow, every
   validation row finite, the checkpoints loaded strictly and the resume
   point restored exactly; the trainer's numbers (a GAN epoch against the
   bare train step, its idle share, one evaluate by part, host->device
   bytes, peak memory, checkpoint size and save / load time); and an fp32
   evaluation of a narrow hierarchy on the card against the CPU;
7. bf16 training against fp32 from identical weights over 12 steps (6
   warm-up, 6 GAN) with the budgets of tests/test_precision.py at its
   narrow TED Gesture setup (asserted), and the same at full TED
   Expressive width (printed), each ending in FGD through one frozen fp32
   embedder;
8. serving a checkpoint (configs_expressive/hierarchy.yaml, bf16, seed-0
   weights): a port checkpoint through ``export-checkpoint`` to a
   reference .bin and ``import-checkpoint`` back, every tensor equal;
   ``GestureService`` (20 s clips, buckets 1 / 4 / 8 / 16): warm-up, one
   request against the direct ``generate_fused`` call, 8 and 16
   concurrent requests against the rows of direct calls on the same
   padded batches (bit for bit), the HTTP API in every encoding, a
   profile of one request; a live stream of 100 ms feeds (latency
   percentiles), the fp32 stream against ``generate`` (1e-3) and the
   bf16 one (printed), 8 streams through the stream batcher; ``cli
   serve`` as a process, ``from-text --wav`` and ``synthesize
   --fade_out``.  B1's launches of every step equal 24 x windows x calls;
9. the GAN baselines at full width in bf16
   (configs_expressive/multimodal_context.yaml and
   configs/speech2gesture.yaml, batch 128): a warm-up and three GAN steps
   of each with the launch counts of B1 (forward, backward calls and
   backward kernel) step by step against the dataflow and B2-B4 at 0,
   step times, peak memory and a profiled GAN step; an fp32 step of each
   at a narrow width on the card against the CPU; a 20 s clip at B = 1
   and 8 through ``generate``; a checkpoint through ``export-checkpoint``
   / ``import-checkpoint`` (every tensor equal); a warm ``GestureService``
   and its HTTP API (one request each, bit for bit the direct call on the
   same padded batch); the fp32 speech2gesture stream against
   ``generate`` (1e-3) and the multimodal stream refused;
10. the text and embedding baselines at full width in bf16
   (configs_expressive/seq2seq.yaml, configs_expressive/joint_embed.yaml,
   configs/gesture_autoencoder.yaml, configs_expressive/
   gesture_autoencoder.yaml): the masked seq2seq encoder on B1 (ragged
   lengths in [2, 32], H = 200, at the service's batches 1, 4 and 8, the
   train batch 128 and the evaluate's batch) against its plain version,
   forward and gradients; a warm-up and three train steps of each with
   B1's launches step by step against the dataflow (seq2seq 2 forward and
   2 backward, joint_embedding 4 and 4, the embedders 0), step times, peak
   memory and a profiled step; an fp32 step of each on the card against
   the CPU; seq2seq and joint_embedding: 20 s clips at B = 1 and 8 through
   ``generate``, a checkpoint through ``export-checkpoint`` /
   ``import-checkpoint``, a warm ``GestureService`` and its HTTP API (bit
   for bit the direct call), their streams refused; each embedder trained
   by ``cli train`` and its checkpoint_best named as ``eval_net_path`` of
   another family's ``Trainer.evaluate``, which gives a finite FGD, B1
   then held against its plain version at that evaluate's batch;
11. multi-device training and sharded synthesis (ranks spawned with
   torch.multiprocessing, groups made here): (a) one rank on an NCCL
   group, the data-parallel path of the full-width bf16 Expressive GAN step
   (configs_expressive/hierarchy.yaml) against the plain step on the same
   batch, losses, gradients, post-Adam parameters and statistics bit for
   bit; (b) two ranks on the one card over gloo (NCCL refuses two ranks on
   one device), the same step at 48 rows a rank: B1 84 forward and 36
   backward launches a rank, B2-B4 2 each on the gathered N = 3264; (c)
   the same under FSDP on a 1 x 2 mesh, each rank's resident parameter and
   Adam bytes against DP's; both held against the same step in one
   process on the whole batch (loss terms and batch-norm statistics, to
   bounds that a control with each rank's own batch-norm statistics
   breaks); the narrow fp32 step of both meshes against
   one process on the card (tests/test_parallel.py's bounds), and FSDP
   against DP; (d) ``run_fused(devices=[cuda:0, cuda:0])`` at B = 8
   against one call, fp32, 2e-4.  B1 at the per-rank shape (34, 48, 300)
   is held against its plain version in phase 2 and timed in phase 5;
12. the host data path: a source lmdb in the reference's bytes (6 videos
   x 4 clips x 20 s of TED Expressive, audio_raw at 16 kHz and a float16
   log-mel, ~38 MB) and a cache lmdb of the same clips' windows (~168 MB)
   written by the port's lmdb writer and pyarrow-0.14 codec, read back
   bit for bit (read and decode MB/s); ``cli import-lmdb`` in both
   formats and ``cli import-embeddings`` from a fastText .bin (dim 300,
   bucket 2000, n-grams 3-6) and a .vec (seconds, MB/s); ``cli train`` of
   the full-width bf16 Expressive hierarchy for an epoch on the imported
   clips with the .bin (warm-up steps) and on the imported samples with
   the .vec (GAN steps), every kernel's launches against the dataflow,
   step ms, samples/s, peak memory, then B1, its backward and B2-B4
   against their plain versions at the path's shapes; ``cli
   compare-trajectory`` of the run against ted_expressive_new (the
   report's structure); ``cli train`` of the gesture autoencoder on a
   synthetic Human3.6M npz (no launch); ``cli doctor`` (exit 0, the
   card's name, its tiny step's launches);
13. the last modules: ``cli build-dataset --qa-report`` over a work
   directory of tool artifacts for 4 synthetic TED Expressive videos of
   66 s at 25 fps (wav, OpenPose frames with the skeletons, scenes, an
   auto-subtitle .vtt; one video faces away and is rejected): its clips
   per split, seconds and report; the built clips windowed by the native
   C++ engine and by numpy (equal counts, targets within 2e-5); the
   shipped Expressive config (bf16, batch 96) trained on them for a
   warm-up and two GAN epochs through ``Trainer(tensorboard=True,
   profile_dir=...)`` and ``fit(render_every=1)`` with a seeded random
   MotionAE evaluator: every kernel's launches against the dataflow, the
   profiler's Chrome trace holding B1's kernel at every launch made while
   it recorded iterations 3-5, each render a GIF read back by a stdlib
   reader, the tensorboard writer or its warning, ``get_features_for_viz``
   (n, 2) twice; ``cli synthesize --render`` from the checkpoint (B1 at
   24 launches a window); B1, its backward and B2-B4 against their plain
   versions at the phase's shapes;
14. the JAX benchmark's synthesis batch (bench.py:131-138): 256 clips of
   20 s of mu-law noise (81.9 MB up, 10 windows, 77,824 pose frames a
   call) through one ``prepare_fused`` and ``run_fused`` at chunk 0 and
   128, each with a float32 and a float16 pull, on phase 3's full-width
   bf16 hierarchy: ms a call (host clock, ending in the host array; the
   headline chunk 128 / float16 10 times, the others 3), pose frames/s,
   peak device memory, B1's launches (240 / 480 a call, checked); each
   float16 pull within float16 rounding of its float32 pull; a profile of
   the headline call (device busy, idle share, the ms its copies ran
   beside kernels); its MFU and the phase-4 GAN steps' (``count_flops``,
   ``mfu_line``); one window's FLOPs on the card equal to phase 3's CPU
   count; chunks of 3 at B = 8 in fp32 (z at mu) within 1e-4 of one call.
   B1 at (34, 256, 300) is held against its plain version in phase 2 and
   timed in phase 5.

The second-to-last line is one JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or outside a
checkout, it exits 1 and prints no result.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# B1 kernel vs its plain version on the same card and inputs.  fp32: the
# two sum h.w_hh in different orders (an FMA chain per thread vs cuBLAS),
# ~1e-6 per step, compounded over 34 steps.  bf16: the carry is rounded to
# bf16 every step; where the two fp32 sums straddle a rounding boundary the
# carries differ by one bf16 ulp (2^-8 near 1), which echoes through later
# steps; allow 4 ulps.
B1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 4 * 2 ** -8}
# the whole fp32 slice on the card vs on the CPU: summation order of the
# cuDNN convolutions (TF32 off) and cuBLAS products against the CPU's,
# through 21 conv layers and 6 levels x 4 GRU layers
SLICE_ATOL = 1e-3
# B1's autograd against autograd through its plain version: relative L2
# error of each gradient.  fp32: summation order of the products.  bf16:
# the plain version's graph rounds every step's gradient to bf16 (2^-8
# relative) where the backward kernel keeps fp32, over 34 steps, on top of
# one-ulp carry flips in the forward.
B1_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# B1's backward kernel against its plain loop on the same inputs, in both
# storage types: the loop is fp32 throughout, the kernel's product bf16
# hi + lo (~2^-16 relative) or 3xTF32, so only that and the summation
# order differ; a product on bf16(d_gh) alone (2^-8) fails it
B1_BWD_REL = 1e-4
# B2-B4 against their plain versions (random unit rows): sums of N terms
# in another order; logz and diag relative to themselves, dA and dB
# relative to the largest entry of the plain result
B234_LOGZ_RTOL, B234_GRAD_REL = 1e-5, 1e-4
# B2-B4 on aligned rows b = normalize(a + sigma n / sqrt(D)), D = 32,
# against their plain versions run in float64, keyed by sigma: rows pulled
# together as a trained contrastive loss sees them (s_ii ~ 0.96 / 0.995),
# where the loss is ill-conditioned (a diag logit moves by ds / dist^3).
# Set to tell a product in fp32 from one in TF32.  logz and diag, relative
# entry by entry: 2x the error of the FFMA fp32 kernels this check was
# first run on (4.9e-6 at 0.3, 4.6e-5 at 0.1, H100) and of cuBLAS's fp32
# product; a single TF32 product is more than 100x off at 0.1 (emulated in
# tests/test_torch_contrastive.py).  dA and dB relative to their largest
# entry: 2x the FFMA kernels' 9.9e-6 / 6.6e-5.
B234_ALIGNED_RTOL = {0.3: 1e-5, 0.1: 1e-4}
B234_ALIGNED_GRAD_REL = {0.3: 2e-5, 0.1: 1.5e-4}
# the narrow fp32 train step on the card against the port on the CPU:
# summation order of cuDNN (TF32 off) and cuBLAS against the CPU's.  Loss
# terms relative.  Gradients, relative L2 per leaf: the audio encoder's
# train-mode batch norms amplify fp32 rounding in the backward (on the
# CPU, fp32 against float64 differs by up to 2e-3 there), so 2e-2 there
# and 1e-3 elsewhere; a leaf whose gradient differs by under 1e-5 in L2
# (a conv bias before a batch norm: zero true gradient) is noise on both.
TRAIN_METRIC_RTOL, TRAIN_GRAD_REL, TRAIN_AUDIO_GRAD_REL = 1e-4, 1e-3, 2e-2
TRAIN_GRAD_FLOOR = 1e-5

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_PEAK_FLOPS = 495e12   # the tensor cores' dense TF32 rate
# the train runs: configuration file and the gan_on of each step (a
# warm-up step, then GAN steps); TED Gesture's batch 256 gives B2-B4 their
# largest shipped N = 256 * 34 = 8704
TRAIN_RUNS = (("configs_expressive/hierarchy.yaml",
               (False, True, True, True, True)),
              ("configs/hierarchy.yaml", (False, True, True)))

N_WORDS, N_SPEAKERS = 64, 8
CLIP_SECONDS = 20.0
SR = 16000


def _line(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _event_ms(fn, inner: int, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the per-call time of ``inner`` calls,
    measured with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of a call that ends in a device->host copy."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# B1: the fused bidirectional GRU recurrence
# ---------------------------------------------------------------------------

def _b1_inputs(T, B, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    k = 1.0 / H ** 0.5
    xp = torch.randn((T, 2, B, 3 * H), generator=g) * 0.5
    h0 = torch.randn((2, B, H), generator=g) * 0.5
    w_hh = (torch.rand((2, H, 3 * H), generator=g) * 2 - 1) * k
    b_hh = (torch.rand((2, 3 * H), generator=g) * 2 - 1) * k
    return [t.to("cuda", dtype).contiguous() for t in (xp, h0, w_hh, b_hh)]


# B1 shapes held against the plain version (the last: the Expressive
# step's rows a rank on two data-parallel ranks): the serving shapes (B = 4 is
# the service's second bucket; the seq2seq encoder's H = 200 over word
# sequences of width 32 at the service's batches 1, 4 and 8) and the train
# shapes (the baselines' batch 128: the multimodal generator's and the
# joint embedding's decoder's H = 300, the multimodal discriminator's
# H = 64 on 28 steps, the seq2seq encoder's H = 200, and sequences as
# short as 2 and 17 steps),
# one and several row groups (97: a ragged last group), hidden sizes whose
# last cluster slice is ragged (300 = 7 * 38 + 34, 200, 45, 48); and the
# benchmark batch's 256 clips unchunked (phase 14; 32 clusters, 3 waves)
B1_SHAPES = ((34, 1, 300), (34, 4, 300), (34, 8, 300), (34, 16, 300),
             (34, 96, 300), (34, 97, 300), (7, 3, 48), (11, 5, 200),
             (6, 16, 45), (34, 128, 300), (28, 128, 64), (32, 1, 200),
             (32, 4, 200), (32, 8, 200), (32, 128, 200), (17, 128, 200),
             (2, 128, 200), (34, 48, 300), (34, 256, 300))
# the backward also at the Gesture step's batch 256 and at 113 and 200,
# whose last 32-row cluster in bf16 is ragged (17 and 8 rows)
B1_BWD_SHAPES = ((34, 96, 300), (34, 97, 300), (11, 5, 200), (34, 128, 300),
                 (28, 128, 64), (32, 128, 200), (17, 128, 200),
                 (2, 128, 200), (34, 48, 300), (34, 256, 300),
                 (34, 113, 300), (34, 200, 300))
# B1's autograd against autograd through its plain version: the train
# shapes of the hierarchy (generator and discriminator, batch 96; the
# Gesture step's 256) and of the baselines (batch 128)
B1_GRAD_SHAPES = ((34, 96, 300), (34, 96, 64), (34, 128, 300), (28, 128, 64),
                  (32, 128, 200), (17, 128, 200), (2, 128, 200),
                  (34, 256, 300))


def _b1_check(shapes=B1_SHAPES):
    from ha2g_torch.ops.gru_kernel import gru_recurrence, gru_recurrence_plain
    errs = {}
    for T, B, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = _b1_inputs(T, B, H, dtype)
            got = gru_recurrence(*args)
            want = gru_recurrence_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got.float()).all()) and \
                err <= B1_ATOL[dtype]
            _line("b1-check", T=T, B=B, H=H, dtype=str(dtype)[6:],
                  max_abs_err=f"{err:.3e}", tol=f"{B1_ATOL[dtype]:.3e}",
                  ok=ok)
            if not ok:
                raise AssertionError(f"B1 kernel disagrees with its plain "
                                     f"version at T={T} B={B} H={H} {dtype}")
            errs[(T, B, H, dtype)] = err
    return errs


def _b1_bwd_inputs(T, B, H, dtype, seed):
    """The backward loop's inputs: xp, hh, h_prev, w_hh, d_outs."""
    from ha2g_torch.ops.gru_kernel import gru_recurrence
    xp, h0, w_hh, b_hh = _b1_inputs(T, B, H, dtype, seed=seed)
    outs = gru_recurrence(xp, h0, w_hh, b_hh)
    h_prev = torch.cat([h0[None], outs[:-1]]).float()
    hh = (torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh.float())
          + b_hh.float()[None, :, None]).contiguous()
    d_outs = torch.randn(outs.shape, generator=torch.Generator()
                         .manual_seed(seed + 1)).to("cuda", dtype)
    return xp, hh, h_prev, w_hh, d_outs


def _b1_bwd_check(shapes=B1_BWD_SHAPES):
    """B1's backward kernel against its plain loop on the same inputs,
    relative L2 error of d_gx, d_gh and d_h0 (``B1_BWD_REL``)."""
    from ha2g_torch.ops.gru_kernel import (gru_backward_loop,
                                           gru_backward_loop_plain)
    errs = {}
    for T, B, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = _b1_bwd_inputs(T, B, H, dtype, seed=B + H)
            got = gru_backward_loop(*args)
            want = gru_backward_loop_plain(*args)
            torch.cuda.synchronize()
            rel = [_rel(g, w) for g, w in zip(got, want)]
            ok = (all(bool(torch.isfinite(g).all()) for g in got)
                  and max(rel) <= B1_BWD_REL)
            _line("b1-bwd-check", T=T, B=B, H=H, dtype=str(dtype)[6:],
                  rel_err_dgx_dgh_dh0="/".join(f"{e:.2e}" for e in rel),
                  tol=f"{B1_BWD_REL:.0e}", ok=ok)
            if not ok:
                raise AssertionError(f"B1 backward kernel disagrees with its "
                                     f"plain loop at T={T} B={B} H={H} "
                                     f"{dtype}")
            errs[(T, B, H, dtype)] = max((g - w).abs().max().item()
                                         for g, w in zip(got, want))
    return errs


def _bound(n_bytes, flops, dtype):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _b1_times(T, B, H, dtype):
    from ha2g_torch.ops.gru_kernel import (cluster_plan, gru_recurrence,
                                           gru_recurrence_plain,
                                           max_active_clusters)
    args = _b1_inputs(T, B, H, dtype, seed=1)
    ms = _event_ms(lambda: gru_recurrence(*args), inner=20)
    plain_ms = _event_ms(lambda: gru_recurrence_plain(*args), inner=3)
    # the library yardstick: cuDNN's bidirectional GRU layer at the same
    # shape (it also does the input projection the kernel is handed)
    lib = torch.nn.GRU(2 * H, H, 1, bidirectional=True).to("cuda", dtype)
    lib.flatten_parameters()
    x = torch.randn((T, B, 2 * H), device="cuda", dtype=dtype)
    with torch.inference_mode():
        library_ms = _event_ms(lambda: lib(x), inner=20)
    elem = torch.finfo(dtype).bits // 8
    n_bytes = sum(a.numel() for a in args) * elem + T * 2 * B * H * elem
    flops = 2 * T * 2 * B * H * 3 * H + 12 * T * 2 * B * H
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    clusters = cluster_plan(H, B, dtype)["clusters"]
    active = max_active_clusters(B, H, dtype)
    waves = -(-clusters // active)
    _line("b1-time", T=T, B=B, H=H, dtype=str(dtype)[6:], ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
          bytes=n_bytes, flops=flops, clusters=clusters,
          max_active_clusters=active, waves=waves)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "waves": waves}


def _rel(got, want) -> float:
    """Relative L2 error of got against want (float64)."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _b1_grad_check():
    """B1's autograd (kernel forward, kernel backward) against autograd
    through its plain version, at the train step's shapes."""
    from ha2g_torch.ops.gru_kernel import (gru_recurrence_fn,
                                           gru_recurrence_plain)
    worst = {}
    for T, B, H in B1_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _b1_inputs(T, B, H, dtype, seed=H)
            ct = torch.randn((T, 2, B, H), device="cuda", dtype=dtype)
            grads = []
            for fn in (gru_recurrence_fn, gru_recurrence_plain):
                leaves = [a.detach().clone().requires_grad_() for a in args]
                (fn(*leaves).float() * ct.float()).sum().backward()
                grads.append([t.grad for t in leaves])
            torch.cuda.synchronize()
            errs = [_rel(g, w) for g, w in zip(*grads)]
            ok = all(np.isfinite(errs)) and max(errs) <= B1_GRAD_REL[dtype]
            _line("b1-grad-check", T=T, B=B, H=H, dtype=str(dtype)[6:],
                  rel_err_xp_h0_whh_bhh="/".join(f"{e:.2e}" for e in errs),
                  tol=f"{B1_GRAD_REL[dtype]:.0e}", ok=ok)
            if not ok:
                raise AssertionError(f"B1 gradient disagrees with autograd "
                                     f"through its plain version, T={T} "
                                     f"B={B} H={H} {dtype}")
            worst[(T, B, H, dtype)] = max(errs)
    return worst


def _b1_backward_times(dtype, T=34, B=96, H=300):
    """B1's backward at a train shape: the kernel (the serial loop), its
    plain loop, and the whole backward call (hoisted hh, kernel, d_w_hh,
    d_b_hh), each with its bound; the library yardstick is cuDNN's
    bidirectional GRU layer, forward + backward minus forward.  The
    kernel's bound takes its product at the rate it runs: two bf16
    products (d_gh split into hi + lo) at the bf16 peak in bf16 storage,
    three TF32 products (3xTF32) at the TF32 peak in fp32, and the gate
    math at the fp32 rate; ``kernel_bound_fp32_rate_ms`` is the same work
    all at the fp32 rate, the bound of the earlier FFMA kernel, kept for
    continuity.  The call's bound takes the fp32 rate (its hoisted
    products are fp32).  waves: the kernel's clusters over those the card
    holds at once.
    """
    from ha2g_torch.ops.gru_kernel import (cluster_plan, gru_backward_loop,
                                           gru_backward_loop_plain,
                                           gru_recurrence,
                                           gru_recurrence_backward,
                                           max_active_clusters)
    loop_args = _b1_bwd_inputs(T, B, H, dtype, seed=2)
    ms = _event_ms(lambda: gru_backward_loop(*loop_args), inner=20)
    plain_ms = _event_ms(lambda: gru_backward_loop_plain(*loop_args), inner=3)
    args = _b1_inputs(T, B, H, dtype, seed=2)
    outs = gru_recurrence(*args)
    d_outs = loop_args[-1]
    call_ms = _event_ms(lambda: gru_recurrence_backward(*args, outs, d_outs),
                        inner=10)
    lib = torch.nn.GRU(2 * H, H, 1, bidirectional=True).to("cuda", dtype)
    lib.flatten_parameters()
    x = torch.randn((T, B, 2 * H), device="cuda", dtype=dtype,
                    requires_grad=True)
    ct = torch.randn((T, B, 2 * H), device="cuda", dtype=dtype)

    def fwd_bwd():
        lib(x)[0].backward(ct)

    fwd_ms = _event_ms(lambda: lib(x), inner=10)
    library_ms = _event_ms(fwd_bwd, inner=10) - fwd_ms
    e = torch.finfo(dtype).bits // 8
    n_step, g = T * 2 * B * H, T * 2 * B * 3 * H
    product = 2 * n_step * 3 * H
    # kernel: xp, w_hh, d_outs (storage type), hh, h_prev (fp32) in;
    # d_gx, d_gh, d_h0 (fp32) out; ~40 elementwise operations a unit
    k_bytes = (g + 2 * H * 3 * H + n_step) * e + (g + n_step) * 4 \
        + (2 * g + 2 * B * H) * 4
    k_fp32, k_fp32_by = _bound(k_bytes, product + 40 * n_step, torch.float32)
    terms, peak = ((2, PEAK_FLOPS[torch.bfloat16]) if dtype == torch.bfloat16
                   else (3, TF32_PEAK_FLOPS))
    t_ops = (terms * product / peak
             + 40 * n_step / PEAK_FLOPS[torch.float32]) * 1e3
    t_bytes = k_bytes / H100_BYTES_PER_S * 1e3
    k_bound = max(t_bytes, t_ops)
    k_by = "bytes" if t_bytes >= t_ops else "operations"
    # call: xp, h0, w_hh, b_hh, outs, d_outs in; d_xp, d_h0, d_w_hh, d_b_hh
    # out, all in the storage type
    c_bytes = (2 * g + 2 * (2 * B * H + 2 * H * 3 * H + 2 * 3 * H)
               + 2 * n_step) * e
    c_bound, c_by = _bound(c_bytes, 3 * product + 40 * n_step,
                           torch.float32)
    clusters = cluster_plan(H, B, dtype)["clusters_backward"]
    active = max_active_clusters(B, H, dtype, backward=True)
    waves = -(-clusters // active)
    _line("b1-backward-time", T=T, B=B, H=H, dtype=str(dtype)[6:],
          kernel_ms=f"{ms:.4f}", plain_loop_ms=f"{plain_ms:.4f}",
          kernel_bound_ms=f"{k_bound:.6f}", kernel_bound_by=k_by,
          kernel_bound_fp32_rate_ms=f"{k_fp32:.6f}",
          kernel_bound_fp32_rate_by=k_fp32_by,
          call_ms=f"{call_ms:.4f}", call_bound_ms=f"{c_bound:.6f}",
          call_bound_by=c_by, library_ms=f"{library_ms:.4f}",
          library="cuDNN GRU fwd+bwd - fwd", clusters=clusters,
          max_active_clusters=active, waves=waves)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": k_bound,
            "bound_by": k_by, "call_ms": call_ms, "call_bound_ms": c_bound,
            "library_ms": library_ms, "waves": waves}


def _backward_spills(logs) -> int:
    """ptxas's spill bytes (stores + loads) summed over the instantiations
    of B1's backward kernel in the build logs; raises if any spills."""
    import re
    fn, seen, spilled = None, 0, 0
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn and "gru_backward_kernel" in fn:
                seen += 1
                spilled += int(m.group(1)) + int(m.group(2))
    _line("b1-bwd-ptxas", instantiations=seen, spill_bytes=spilled)
    if spilled:
        raise AssertionError(f"B1's backward kernel spills {spilled} bytes")
    return spilled


# ---------------------------------------------------------------------------
# B2-B4: the flash contrastive loss
# ---------------------------------------------------------------------------

def _b234_inputs(N, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.nn.functional.normalize(torch.randn((N, D), generator=g),
                                          dim=1) for _ in range(2))
    return a.cuda().contiguous(), b.cuda().contiguous()


def _aligned_rows(N, D, sigma, seed=0):
    """Unit rows a and b = normalize(a + sigma n / sqrt(D)): pairs pulled
    together as a trained contrastive loss sees them (s_ii near 1)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.nn.functional.normalize(torch.randn((N, D), generator=g), dim=1)
    n = torch.randn((N, D), generator=g)
    b = torch.nn.functional.normalize(a + sigma * n / D ** 0.5, dim=1)
    return a.cuda().contiguous(), b.cuda().contiguous()


def _b234_kernels(a, b, g):
    from ha2g_torch.ops import contrastive as C
    logz, diag = C.contrastive_fwd(a, b)
    da = C.contrastive_bwd_da(a, b, logz, g)
    db = C.contrastive_bwd_db(a, b, logz, g)
    torch.cuda.synchronize()
    return logz, diag, da, db


def _rel_max(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def _rel_each(got, want) -> float:
    """Largest |got - want| / |want|, entry by entry."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / want.abs()).max().item()


def _b234_check(random_shapes=((3264, 32), (8704, 32), (1000, 32),
                                (1000, 128)), aligned=(3264, 1000),
                duplicates=True):
    """B2-B4 against their plain versions: random unit rows (fp32 plain
    version), aligned rows (float64 plain version) and rows with exact
    duplicates (finite)."""
    from ha2g_torch.ops import contrastive as C
    errs = {}
    for N, D in random_shapes:
        a, b = _b234_inputs(N, D, seed=N + D)
        g = torch.full((1,), 0.7 / N, device="cuda")
        logz, diag, da, db = _b234_kernels(a, b, g)
        p_logz, p_diag = C.contrastive_fwd_plain(a, b)
        p_da = C.contrastive_bwd_da_plain(a, b, logz, g[0])
        p_db = C.contrastive_bwd_db_plain(a, b, logz, g[0])
        e_fwd = max(_rel_each(logz, p_logz), _rel_each(diag, p_diag))
        e_da, e_db = _rel_max(da, p_da), _rel_max(db, p_db)
        ok = (all(torch.isfinite(t).all().item() for t in (logz, diag, da, db))
              and e_fwd <= B234_LOGZ_RTOL and max(e_da, e_db) <= B234_GRAD_REL)
        _line("b234-check", rows="random", N=N, D=D, ragged=N % 64 != 0,
              b2_rel_err=f"{e_fwd:.2e}", b3_rel_err=f"{e_da:.2e}",
              b4_rel_err=f"{e_db:.2e}",
              tol=f"{B234_LOGZ_RTOL:.0e}/{B234_GRAD_REL:.0e}", ok=ok)
        if not ok:
            raise AssertionError(f"B2-B4 disagree with their plain versions "
                                 f"at N={N} D={D}")
        errs[(N, D)] = {
            "b2": max((logz - p_logz).abs().max().item(),
                      (diag - p_diag).abs().max().item()),
            "b3": (da - p_da).abs().max().item(),
            "b4": (db - p_db).abs().max().item()}
    # aligned rows against float64: tells an fp32 product from a TF32 one
    for N in aligned:
        for sigma in (0.3, 0.1):
            a, b = _aligned_rows(N, 32, sigma, seed=N)
            g = torch.full((1,), 0.7 / N, device="cuda")
            got = _b234_kernels(a, b, g)
            a64, b64 = a.double(), b.double()
            w_logz, w_diag = C.contrastive_fwd_plain(a64, b64)
            want = (w_logz, w_diag,
                    C.contrastive_bwd_da_plain(a64, b64, w_logz, g[0].double()),
                    C.contrastive_bwd_db_plain(a64, b64, w_logz, g[0].double()))
            p_logz, p_diag = C.contrastive_fwd_plain(a, b)
            e_logz, e_diag = (_rel_each(got[i], want[i]) for i in (0, 1))
            e = [max(e_logz, e_diag), _rel_max(got[2], want[2]),
                 _rel_max(got[3], want[3])]
            e_plain = max(_rel_each(p_logz, w_logz), _rel_each(p_diag, w_diag))
            tol = (B234_ALIGNED_RTOL[sigma], B234_ALIGNED_GRAD_REL[sigma])
            ok = (all(torch.isfinite(t).all().item() for t in got)
                  and e[0] <= tol[0] and max(e[1:]) <= tol[1])
            s_ii = (a * b).sum(1)
            _line("b234-check", rows=f"aligned_sigma_{sigma}", N=N, D=32,
                  mean_s_ii=f"{s_ii.mean().item():.4f}",
                  max_diag_logit=f"{w_diag.max().item():.1f}",
                  b2_logz_rel_err=f"{e_logz:.2e}",
                  b2_diag_rel_err=f"{e_diag:.2e}", b3_rel_err=f"{e[1]:.2e}",
                  b4_rel_err=f"{e[2]:.2e}",
                  plain_fp32_b2_rel_err=f"{e_plain:.2e}",
                  tol=f"{tol[0]:.0e}/{tol[1]:.0e}", ok=ok)
            if not ok:
                raise AssertionError(f"B2-B4 disagree with float64 on aligned "
                                     f"rows, sigma={sigma} N={N}")
            errs[(N, sigma)] = e
    if not duplicates:
        return errs
    # exact duplicates: diagonal logits at ~1e6, where B3 or B4 rounding s
    # otherwise than B2 overflows exp(logit - logz)
    a, b = _b234_inputs(3264, 32, seed=11)
    b[:5] = a[:5]
    got = _b234_kernels(a, b, torch.full((1,), 0.7 / 3264, device="cuda"))
    ok = all(torch.isfinite(t).all().item() for t in got)
    _line("b234-check", rows="duplicates_5", N=3264, D=32,
          max_diag_logit=f"{got[1].max().item():.1f}", finite=ok, ok=ok)
    if not ok:
        raise AssertionError("B2-B4 are not finite on duplicate rows")
    return errs


def _kernel_device_ms(fn, pattern, n=20):
    """Median device time of one launch of the kernel whose name holds
    ``pattern``, over ``n`` calls of fn under torch.profiler.  (A kernel
    shorter than its wrapper's host work cannot be timed with CUDA events
    around back-to-back calls: the card would wait on the host.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and pattern in e.name]
    # the profiler may miss the first launches of its window
    # (PROFILE_PAD_S)
    if len(times) < n // 2:
        raise AssertionError(f"profiled {len(times)} launches of {pattern} "
                             f"of {n}")
    return statistics.median(times)


def _b234_times(N, D=32):
    """Device ms of one launch of B2, B3, B4 (profiler), the wrapper
    call's ms back to back (CUDA events) and their plain versions' ms,
    with each one's bound: bytes = one read of every input and one write
    of every output; operations ~ (2D + 12) per pair (i, j) for B2 (the
    product, clamps, sqrt, reciprocal, exp) and ~ (4D + 16) for B3 and B4
    (the product again, ds, and ds times the other operand)."""
    from ha2g_torch.ops import contrastive as C
    a, b = _b234_inputs(N, D, seed=5)
    logz, _ = C.contrastive_fwd(a, b)
    g = torch.full((1,), 1.0 / N, device="cuda")
    runs = {
        "b2": (lambda: C.contrastive_fwd(a, b),
               lambda: C.contrastive_fwd_plain(a, b),
               (2 * N * D + 2 * N) * 4, (2 * D + 12) * N * N),
        "b3": (lambda: C.contrastive_bwd_da(a, b, logz, g),
               lambda: C.contrastive_bwd_da_plain(a, b, logz, g[0]),
               (3 * N * D + N + 1) * 4, (4 * D + 16) * N * N),
        "b4": (lambda: C.contrastive_bwd_db(a, b, logz, g),
               lambda: C.contrastive_bwd_db_plain(a, b, logz, g[0]),
               (3 * N * D + N + 1) * 4, (4 * D + 16) * N * N),
    }
    out = {}
    for k, (fn, plain, n_bytes, flops) in runs.items():
        ms = _kernel_device_ms(fn, KERNEL_PATTERNS[k])
        call_ms = _event_ms(fn, inner=10)
        plain_ms = _event_ms(plain, inner=2)
        bound_ms, bound_by = _bound(n_bytes, flops, torch.float32)
        _line(f"{k}-time", N=N, D=D, ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, bytes=n_bytes, flops=flops,
              library_ms="none",
              library_note="no single PyTorch call computes this loss",
              splits=C.splits(("b2", "b3", "b4").index(k), N, D,
                              a.device.index))
        out[k] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    return out


# ---------------------------------------------------------------------------
# The denoiser's fused residual add and layer norm
# ---------------------------------------------------------------------------

# one denoiser pass of the diffusion cell: 2 x 64 rows x 34 frames of 512
ADD_NORM_SHAPE = (128, 34, 512)
ADD_NORM_SETS = 8      # distinct operand sets: 8 x 17.8 MB > the 50 MB L2


def _add_norm_inputs(shape, broadcast, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(shape, generator=g)
    d = torch.randn(shape[-2:] if broadcast else shape, generator=g)
    weight = 1.0 + 0.2 * torch.randn(shape[-1], generator=g)
    bias = 0.1 * torch.randn(shape[-1], generator=g)
    return [t.to("cuda", dtype) for t in (h, d, weight, bias)]


def _add_norm_check():
    """The fused kernel against its plain version at the cell's shape, at
    a row count that no block of four rows divides, with the positional
    table broadcast, and in float32: the sum bit for bit, y within the
    larger of one ulp of its type and 16 float32 ulps at its largest
    magnitude (tests/test_torch_cuda.py::_add_norm_tol).  Returns {case:
    y's largest error in that tolerance}."""
    from ha2g_torch.ops.add_norm import add_layer_norm, add_layer_norm_plain
    cases = {"cell": (ADD_NORM_SHAPE, False, torch.bfloat16),
             "odd_rows": ((4349, 512), False, torch.bfloat16),
             "pos": (ADD_NORM_SHAPE, True, torch.bfloat16),
             "fp32": (ADD_NORM_SHAPE, False, torch.float32)}
    out = {}
    for name, (shape, broadcast, dtype) in cases.items():
        args = _add_norm_inputs(shape, broadcast, dtype, seed=len(out))
        with torch.inference_mode():
            s, y = add_layer_norm(*args, 1e-5)
            want_s, want_y = add_layer_norm_plain(*args, 1e-5)
        torch.cuda.synchronize()
        tol = max(torch.finfo(dtype).eps,
                  16 * torch.finfo(torch.float32).eps) * 2.0 ** np.floor(
            np.log2(float(want_y.abs().max())))
        err = float((y.float() - want_y.float()).abs().max()) / tol
        _line("add-norm-check", case=name, shape=list(shape), dtype=dtype,
              sum_equal=torch.equal(s, want_s), y_err_of_tol=f"{err:.3f}")
        if not torch.equal(s, want_s) or err > 1.0:
            raise AssertionError(f"add_layer_norm {name}: sum equal "
                                 f"{torch.equal(s, want_s)}, y off by "
                                 f"{err} of its tolerance")
        out[name] = err
    return out


def _graph_ms(fns, reps=10) -> float:
    """Median device ms of one of ``fns`` (called in turn, 12 rounds) as a
    CUDA graph replays them, the way the diffusion chain runs: no host
    launch between kernels (CUDA events around each replay).  The kernels'
    launch counts grow by the graph's launches at each replay, as the
    synthesizers' graphs count."""
    from ha2g_torch import kernels
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    rounds = 12
    with kernels.captured_launches() as tally, torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    for _ in range(3):
        graph.replay()
        kernels.add_launches(tally)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        kernels.add_launches(tally)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / (rounds * len(fns)))
    return statistics.median(times)


def _diffuse_counts():
    """The serving path of the diffusion cell: ``make_synthesizer(...)
    .generate`` on a full-width bf16 DiffGesture (8 blocks of 512, 500
    steps) over 64 clips of 4.5 s (3 windows), a generator on the card.  A
    first call captures each window's chain as a CUDA graph (after an
    op-by-op warm-up); the second call, counted alone, replays it at every
    window: one fused add and layer norm a norm of the pass (two a block
    and the final one) a step, no other kernel of the port.  Returns that call's launch counts."""
    from ha2g_torch.config import Config
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.loop import build_system

    cfg = Config(model="pose_diffusion", dataset="ted_expressive",
                 pose_dim=126, n_poses=34, n_pre_poses=4,
                 compute_dtype="bfloat16")
    system = build_system(cfg, 4, 1, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    rng = np.random.default_rng(0)
    clips, windows = 64, 3
    audio = (rng.normal(size=(clips, int(4.5 * 16000))) * 0.1).astype(
        np.float32)
    call = lambda seed: synth.generate(
        audio, [[]] * clips, Vocab("words"), np.zeros(clips, np.int64),
        generator=torch.Generator("cuda").manual_seed(seed))
    call(1)
    before, steps = _read_counts(), dict(synth.step_counts)
    t0 = time.perf_counter()
    out = call(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in _read_counts().items()}
    replayed = synth.step_counts["replayed"] - steps["replayed"]
    want = {**dict.fromkeys(counts, 0),
            "add_norm": (2 * cfg.block_depth + 1) * cfg.diffusion_steps
            * windows}
    ok = (counts == want and np.isfinite(out).all()
          and replayed == cfg.diffusion_steps * windows
          and synth.step_counts["eager"] == steps["eager"])
    _line("diffuse-serving", clips=clips, windows=windows,
          shape=list(out.shape), seconds=f"{seconds:.3f}",
          replayed_steps=replayed,
          add_norm=f"{counts['add_norm']}/{want['add_norm']}", ok=ok)
    if not ok:
        raise AssertionError(f"diffusion serving path: counts {counts} "
                             f"against {want}, {replayed} steps replayed")
    return counts


def _add_norm_times():
    """At the cell's shape in bf16: the fused kernel's device ms a launch
    (profiler, operands in L2 as back-to-back calls leave them); ms a
    launch in a CUDA graph over ``ADD_NORM_SETS`` operand sets, which
    L2 cannot hold (``cold``), and over one set (``warm``); the same for
    the plain version (PyTorch's bf16 add, then ``F.layer_norm``) and for
    the library call alone (``F.layer_norm`` on the sum); the bound: h and
    d read, h' and y written once at 3.35 TB/s."""
    import torch.nn.functional as F

    from ha2g_torch.ops.add_norm import add_layer_norm, add_layer_norm_plain
    sets = [_add_norm_inputs(ADD_NORM_SHAPE, False, torch.bfloat16, seed=i)
            for i in range(ADD_NORM_SETS)]
    D = ADD_NORM_SHAPE[-1]
    with torch.inference_mode():
        sums = [h + d for h, d, _, _ in sets]

        def fused(a):
            return lambda: add_layer_norm(*a, 1e-5)

        def plain(a):
            return lambda: add_layer_norm_plain(*a, 1e-5)

        def library(a, s):
            return lambda: F.layer_norm(s, (D,), a[2], a[3], 1e-5)

        ms = _kernel_device_ms(fused(sets[0]), "add_layer_norm")
        out = {"ms": ms}
        for name, make in (("fused", lambda i: fused(sets[i])),
                           ("plain", lambda i: plain(sets[i])),
                           ("library", lambda i: library(sets[i], sums[i]))):
            out[f"{name}_cold_ms"] = _graph_ms(
                [make(i) for i in range(ADD_NORM_SETS)])
            out[f"{name}_warm_ms"] = _graph_ms([make(0)])
    n_bytes = 4 * sets[0][0].numel() * 2 + 2 * D * 2
    out["bound_ms"], out["bound_by"] = _bound(n_bytes, 0, torch.bfloat16)
    _line("add-norm-time", shape=list(ADD_NORM_SHAPE), dtype="bfloat16",
          bytes=n_bytes, **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                            for k, v in out.items()})
    return out


# SASS opcodes of the epilogue's arithmetic: fp32 ALU and MUFU (sqrt, rcp,
# exp); the product is HMMA
EPILOGUE_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FRND",
                "MUFU")


def _sass_reckoning(n_values=(3264, 8704)):
    """The epilogue's instructions a pair, counted in the SASS of the
    built contrastive library (cuobjdump -sass).  Every pair's logit takes
    one MUFU.RSQ (its sqrt), and the compiler may keep more than one copy
    of the tile's code (the ragged edge), so a kernel's instructions over
    its MUFU.RSQ count are its instructions a pair: the fp32 / MUFU ones
    and all of them (these include the product's adds, staging and
    indexing).  Each gives a time bound: pairs x count / 32 lanes at 4 warp
    instructions a clock an SM, 132 SMs, the card's largest SM clock.
    Returns {kernel: fp32 / MUFU instructions a pair}."""
    import re
    import shutil
    from ha2g_torch import kernels
    from ha2g_torch.ops import contrastive as C
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(kernels.library_path(
            C.SOURCE))], capture_output=True, text=True, check=True).stdout
        clock_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
    except (OSError, subprocess.CalledProcessError, ValueError) as err:
        _line("b234-sass", epilogue="not measured", reason=repr(err)[:80])
        return {}
    rate = 132 * 4 * clock_mhz * 1e6   # warp instructions a second
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        label = next((lab for key, lab in (
            ("contrastive_fwd_kernel", "b2"),
            ("contrastive_bwd_kernelILb0E", "b3"),
            ("contrastive_bwd_kernelILb1E", "b4")) if key in
            part.split("\n", 1)[0]), None)
        if label is None:
            continue
        ops = {}
        for ln in part.splitlines():
            tokens = ln.split("*/", 1)[-1].split() if ";" in ln else []
            if tokens and tokens[0].startswith("@"):   # a predicate
                tokens = tokens[1:]
            if tokens:
                op = tokens[0].split(".")[0]
                ops[op] = ops.get(op, 0) + 1
        rsq = part.count("MUFU.RSQ")
        fp32 = sum(ops.get(o, 0) for o in EPILOGUE_OPS) / rsq
        every = sum(ops.values()) / rsq
        bounds = {f"instr_bound_ms_N{n}_fp32_all":
                  f"{n * n * fp32 / 32 / rate * 1e3:.4f}/"
                  f"{n * n * every / 32 / rate * 1e3:.4f}" for n in n_values}
        _line("b234-sass", kernel=label, instructions=sum(ops.values()),
              hmma=ops.get("HMMA", 0), mufu_rsq=rsq,
              fp32_per_pair=f"{fp32:.1f}", all_per_pair=f"{every:.1f}",
              sm_clock_mhz=clock_mhz, **bounds)
        out[label] = fp32
    return out


# kernel name patterns in the profiler's device events
KERNEL_PATTERNS = {"b1": "gru_recurrence_kernel",
                   "b1_bwd": "gru_backward_kernel",
                   "b2": "contrastive_fwd_kernel",
                   "b3": "contrastive_bwd_kernel<false>",
                   "b4": "contrastive_bwd_kernel<true>"}


def _profile(name, fn, e2e_ms, kernels=("b1",), want=None, tries=3):
    """One call under torch.profiler: the device time of every kernel in
    it, the port's kernels among them, and the device's idle share of the
    call's unprofiled median wall time.  Returns {kernel: (launches, device
    ms)} for ``kernels`` and the device-busy ms, or None if the profiler saw
    no device events.

    With ``want`` ({kernel: launches the dataflow gives}), a profile whose
    launches differ from it is printed and the call profiled again, up to
    ``tries`` profiles in all; it raises if every one differs.  Each new
    profile pads the call with ten times the host time of the last, since
    the tracer drops device records from the window's start
    (``PROFILE_PAD_S``).  A launch the dataflow counts that never reaches
    the card is missing from every profile."""
    pad = PROFILE_PAD_S
    for attempt in range(1, tries + 1):
        window = {}
        per_name = _device_kernels(fn, window, pad)
        if not per_name:
            _line("profile", request=name, device_busy_ms="not measured",
                  reason="the profiler recorded no device events")
            return
        seen = {k: tuple(sum(v[i] for key, v in per_name.items()
                             if KERNEL_PATTERNS[k] in key) for i in (1, 0))
                for k in kernels}
        if want is None or all(seen[k][0] == want[k] for k in kernels):
            break
        _line("profile-short", request=name, attempt=attempt, pad_s=pad,
              **{f"{k}_kernels": f"{seen[k][0]}/{want[k]}" for k in kernels},
              **window)
        pad *= 10
    else:
        raise AssertionError(f"every one of {tries} profiles of {name} "
                             f"shows other launches than the dataflow's "
                             f"{want}: the last {seen}")
    busy = sum(ms for ms, _ in per_name.values())
    fields = {}
    for k in kernels:
        fields[f"{k}_device_ms"] = f"{seen[k][1]:.2f}"
        fields[f"{k}_kernels"] = seen[k][0]
    _line("profile", request=name, e2e_ms=f"{e2e_ms:.2f}",
          device_busy_ms=f"{busy:.2f}",
          idle_share=f"{1 - busy / e2e_ms:.3f}",
          device_ops=sum(n for _, n in per_name.values()), pad_s=pad,
          **fields)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    for k, (ms, n) in top:
        _line("profile-top", request=name, ms=f"{ms:.2f}", count=n,
              kernel=k[:90].replace(" ", "_"))
    return seen, busy


# host time at each end of a profiled call, inside the profiler's window.
# On an H100 the tracer drops the records of kernels launched in the
# window's first milliseconds, more of them the older the process:
# twenty kernels launched back to back at a window's start, with no pad,
# were all kept early in a process and none after a few minutes, while
# this pad kept all of them.  Late in a whole run of this script (~400 s)
# the seq2seq step's first B1 launch, a few ms into its call, went missing
# from three profiles in a row even with this pad; a fresh process never
# missed it.  So a short profile is taken again with a wider pad.
PROFILE_PAD_S = 0.05


def _device_kernels(fn, window=None, pad=PROFILE_PAD_S, spans=None):
    """One call of fn under torch.profiler, padded with ``pad`` seconds of
    host time at each end -> {kernel name: (device ms, launches)}.  A dict
    passed as ``window`` gets the first start and last end, in the
    profiler's microseconds, of its host and device events; a list passed
    as ``spans`` gets (name, start, end) of every device event counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    per_name, ends = {}, {"host": [], "device": []}
    for e in prof.events():
        # user annotations (e.g. the optimiser's step range) span kernels
        # that are counted on their own
        on_card = e.device_type == DeviceType.CUDA
        ends["device" if on_card else "host"].append(
            (e.time_range.start, e.time_range.end))
        if on_card and not e.is_user_annotation:
            ms, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
            if spans is not None:
                spans.append((e.name, e.time_range.start, e.time_range.end))
    if window is not None:
        for side, found in ends.items():
            if found:
                window[f"{side}_us"] = (f"{min(a for a, _ in found):.0f}-"
                                        f"{max(b for _, b in found):.0f}")
    return per_name


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _config(compute_dtype):
    from ha2g_torch.config import Config
    return Config(model="hierarchy", dataset="ted_expressive", pose_dim=126,
                  n_poses=34, n_pre_poses=4, hidden_size=300, n_layers=4,
                  z_type="speaker", input_context="both",
                  compute_dtype=compute_dtype)


def _requests(B, seconds, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(B, int(seconds * SR))) * 0.1).astype(np.float32)
    audio *= np.logspace(0, -2, B, dtype=np.float32)[:, None]
    words = [[(f"w{rng.integers(0, 40)}", float(t), float(t + 0.3))
              for t in np.arange(0.3, seconds - 0.5, 0.45)]
             for _ in range(B)]
    vids = rng.integers(0, N_SPEAKERS, (B,))
    return audio, words, vids


def _vocab():
    from ha2g_torch.data.vocab import Vocab
    lang = Vocab("words")
    for i in range(N_WORDS - lang.n_words):
        lang.index_word(f"w{i}")
    return lang


# one window: a clip shorter than a window's 34 / 15 s
WINDOW_SECONDS = 2.0


def _slice():
    from ha2g_torch.ops.gru_kernel import gru_recurrence
    from ha2g_torch.synthesis import _window_layout, make_synthesizer
    from ha2g_torch.train.hierarchy import HierarchySystem
    from ha2g_torch.utils.roofline import count_flops

    cfg = _config("bfloat16")
    spec = cfg.skeleton
    per_window = spec.n_levels * cfg.n_layers
    t0 = time.perf_counter()
    system = HierarchySystem(cfg, N_WORDS, N_SPEAKERS,
                             generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict(), low_latency=True)
    _line("slice-build", seconds=f"{time.perf_counter() - t0:.1f}",
          params=sum(p.numel() for p in system.parameters()))
    lang = _vocab()
    _, _, W = _window_layout(cfg, CLIP_SECONDS)
    frames = cfg.n_poses + (W - 1) * (cfg.n_poses - cfg.n_pre_poses)

    def mulaw_encode(x):
        y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log1p(255.0)
        return ((y + 1.0) / 2.0 * 255.0 + 0.5).astype(np.uint8)

    a1, w1, v1 = _requests(1, CLIP_SECONDS, 1)
    a8, w8, v8 = _requests(8, CLIP_SECONDS, 8)
    runs = [
        ("generate", "float32", 1, lambda: synth.generate(a1, w1, lang, v1)),
        ("generate", "float32", 8, lambda: synth.generate(a8, w8, lang, v8)),
        ("generate", "int16", 1, lambda: synth.generate(
            (a1 * 32767).astype(np.int16), w1, lang, v1)),
        ("generate", "mulaw", 1, lambda: synth.generate(
            mulaw_encode(np.clip(a1, -1, 1)), w1, lang, v1)),
        ("generate_fused", "float32", 8,
         lambda: synth.generate_fused(a8, w8, lang, v8)),
    ]
    gru_recurrence.launches = 0
    total = 0
    outputs = {}
    for path, fmt, B, fn in runs:
        before = gru_recurrence.launches
        out = fn()
        n = gru_recurrence.launches - before
        total += n
        ok = (out.shape == (B, frames, spec.pose_dim)
              and bool(np.isfinite(out).all()) and n == W * per_window)
        _line("slice", path=path, input=fmt, B=B, windows=W,
              shape=tuple(out.shape), finite=bool(np.isfinite(out).all()),
              b1_launches=n, expected=W * per_window, ok=ok)
        if not ok:
            raise AssertionError(f"{path} {fmt} B={B} failed its checks")
        outputs[(path, fmt, B)] = out
    main_path_launches = gru_recurrence.launches
    if main_path_launches != total:
        raise AssertionError("B1 launches outside the counted requests")
    # bf16 fused vs host loop: informative only (the audio encoder runs at
    # another batch, so bf16 rounding differs); the fp32 check below holds
    err = np.abs(outputs[("generate_fused", "float32", 8)]
                 - outputs[("generate", "float32", 8)]).max()
    _line("slice-fused-vs-host-bf16", B=8, max_abs_err=f"{err:.3e}")

    # the card's fp32 result (host and fused loop) against the same port on
    # the CPU, with the same weights, inputs and speaker-z noise
    cfg32 = _config("float32")
    cpu = HierarchySystem(cfg32, N_WORDS, N_SPEAKERS, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    gpu = HierarchySystem(cfg32, N_WORDS, N_SPEAKERS,
                          generator=torch.Generator().manual_seed(9))
    state = cpu.state_dict()
    a, w, v = _requests(1, 4.0, 3)
    noise = lambda: torch.Generator().manual_seed(11)
    synth_cpu = make_synthesizer(cpu, state)
    want = synth_cpu.generate(a, w, lang, v, noise())
    # the FLOPs of one full-width window on the CPU (plain versions); phase
    # 14 counts the same call on the card
    window_flops = count_flops(synth_cpu.generate_fused,
                               *_requests(1, WINDOW_SECONDS, 4)[:2], lang,
                               np.array([1]), noise())
    _line("slice-window-flops-cpu", seconds=WINDOW_SECONDS,
          flops=f"{window_flops:.0f}")
    synth32 = make_synthesizer(gpu, state)
    for path in ("generate", "generate_fused"):
        got = getattr(synth32, path)(a, w, lang, v, noise())
        err = float(np.abs(got - want).max())
        ok = got.shape == want.shape and err <= SLICE_ATOL
        _line("slice-fp32-card-vs-cpu", path=path, shape=tuple(got.shape),
              max_abs_err=f"{err:.3e}", tol=f"{SLICE_ATOL:.0e}", ok=ok)
        if not ok:
            raise AssertionError(f"fp32 {path} on the card disagrees with "
                                 "the CPU")
    del cpu, gpu, synth32, synth_cpu

    e2e = {}
    for name, (_, _, B, fn) in (("generate_B1", runs[0]),
                                ("generate_B8", runs[1]),
                                ("generate_int16_B1", runs[2]),
                                ("generate_fused_B8", runs[4])):
        e2e[name] = (B, _host_ms(fn))
        _line("e2e", request=name, clip_seconds=CLIP_SECONDS, windows=W,
              ms_median_of_10=f"{e2e[name][1]:.2f}")
    for name, i in (("generate_B1", 0), ("generate_B8", 1),
                    ("generate_fused_B8", 4)):
        _profile(name, runs[i][3], e2e[name][1])
    return main_path_launches, W * per_window, e2e, window_flops


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _train_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    T = cfg.n_poses
    return {"text": rng.integers(0, N_WORDS, (B, T)),
            "spec": rng.normal(size=(B, 128, 70)).astype(np.float32),
            "target": (rng.normal(size=(B, T, cfg.skeleton.pose_dim)) * 0.2)
            .astype(np.float32),
            "vids": rng.integers(0, N_SPEAKERS, (B,))}


def _counters():
    """The launch counts of every kernel of the train step and of the
    denoiser's fused add and layer norm, and the calls of B1's backward."""
    from ha2g_torch.ops import add_norm as A
    from ha2g_torch.ops import contrastive as C
    from ha2g_torch.ops import gru_kernel as G
    return {"b1": G.gru_recurrence, "b1_backward": G.gru_recurrence_backward,
            "b1_bwd": G.gru_backward_loop, "b2": C.contrastive_fwd,
            "b3": C.contrastive_bwd_da, "b4": C.contrastive_bwd_db,
            "add_norm": A.add_layer_norm}


def _set_counts(values):
    for k, fn in _counters().items():
        setattr(fn, "calls" if k == "b1_backward" else "launches", values[k])


def _reset_counts():
    _set_counts(dict.fromkeys(_counters(), 0))


@contextlib.contextmanager
def _uncounted():
    """Launches inside (a kernel held against its plain version on a
    counted path) are left out of the counts."""
    saved = _read_counts()
    try:
        yield
    finally:
        _set_counts(saved)


def _read_counts():
    return {k: getattr(fn, "calls" if k == "b1_backward" else "launches")
            for k, fn in _counters().items()}


def _expected_counts(cfg, gan_on):
    """Per step: B1 forward once a GRU layer a cascade (the G cascade, the
    diversity cascade, the D phase's fake cascade) and once a D layer a D
    call (D(out) always; D(real), D(fake) in the D phase); its backward
    for the G cascade, D(out) with the GAN term, and both D-phase calls;
    B2 once and B3, B4 once each for the +/- contrastive terms; the
    hierarchy runs no denoiser, so no fused add and layer norm."""
    cascade = cfg.skeleton.n_levels * cfg.n_layers
    d_layers = 4
    if gan_on:
        fwd = 3 * cascade + 3 * d_layers
        bwd = cascade + 3 * d_layers
    else:
        fwd = 2 * cascade + d_layers
        bwd = cascade
    return {"b1": fwd, "b1_backward": bwd, "b1_bwd": bwd, "b2": 2, "b3": 2,
            "b4": 2, "add_norm": 0}


def _train(config, steps):
    """Train steps of a full-width hierarchy with its own configuration
    file (``config``, relative to the checkout; ``steps`` the gan_on of
    each): launch counts, finite losses, times, memory and a profile of one
    GAN step with B2-B4's share of its device time.  Returns the kernels'
    launch counts over the steps, the median GAN step's ms and the FLOPs
    of a GAN step (``count_flops``)."""
    from ha2g_torch.config import Config
    from ha2g_torch.train.hierarchy import HierarchySystem
    from ha2g_torch.utils.roofline import count_flops

    cfg = Config.from_yaml(ROOT / config)
    B = cfg.batch_size
    t0 = time.perf_counter()
    system = HierarchySystem(cfg, N_WORDS, N_SPEAKERS,
                             generator=torch.Generator().manual_seed(0))
    _line("train-build", config=config,
          seconds=f"{time.perf_counter() - t0:.1f}",
          params=sum(p.numel() for p in system.parameters()), batch=B,
          contrastive_N=B * cfg.n_poses, compute_dtype=cfg.compute_dtype,
          levels=cfg.skeleton.n_levels, hidden=cfg.hidden_size,
          gru_layers=cfg.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [_train_batch(cfg, B, 100 + i) for i in range(len(steps))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    _reset_counts()
    for i, (gan_on, batch) in enumerate(zip(steps, batches)):
        before = _read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = system.train_step(batch, gan_on, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = {k: v - before[k] for k, v in _read_counts().items()}
        want = _expected_counts(cfg, gan_on)
        values = {k: float(v) for k, v in metrics.items()}
        finite = all(np.isfinite(v) for v in values.values())
        ok = finite and counts == want
        _line("train-step", config=config, step=i, gan_on=gan_on,
              ms=f"{ms:.1f}", finite=finite,
              **{k: f"{v:.4f}" for k, v in values.items()})
        _line("train-launches", config=config, step=i,
              **{k: f"{counts[k]}/{want[k]}" for k in want}, ok=ok)
        if not ok:
            raise AssertionError(f"{config} train step {i} (gan_on="
                                 f"{gan_on}) failed its checks")
        step_ms.append(ms)
    main_path = _read_counts()
    if main_path != {k: sum(_expected_counts(cfg, g)[k] for g in steps)
                     for k in main_path}:
        raise AssertionError("kernel launches outside the counted steps")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gan_ms = statistics.median(step_ms[2:])
    _line("train-e2e", config=config, warmup_step_ms=f"{step_ms[0]:.1f}",
          gan_step_ms_median=f"{gan_ms:.1f}", gan_steps=len(step_ms) - 2,
          samples_per_s=f"{B / gan_ms * 1e3:.1f}",
          peak_memory_gib=f"{peak:.2f}")
    kernels = ("b1", "b1_bwd", "b2", "b3", "b4")
    profiled = _profile(f"train_gan_step:{config}", lambda: system.train_step(
        _train_batch(cfg, B, 200), True, gen), gan_ms, kernels=kernels,
        want=_expected_counts(cfg, True))
    if profiled is not None:
        seen, busy = profiled
        b234_ms = sum(seen[k][1] for k in ("b2", "b3", "b4"))
        _line("train-b234-share", config=config, N=B * cfg.n_poses,
              **{f"{k}_device_ms": f"{seen[k][1]:.3f}"
                 for k in ("b2", "b3", "b4")},
              b234_device_ms=f"{b234_ms:.3f}", device_busy_ms=f"{busy:.2f}",
              share=f"{b234_ms / busy:.4f}")
    # the FLOPs of one GAN step, for its MFU (phase 14 prints the line)
    flops = count_flops(system.train_step, _train_batch(cfg, B, 201), True,
                        gen)
    _line("train-flops", config=config, gan_step_flops=f"{flops:.0f}")
    del system
    torch.cuda.empty_cache()
    return main_path, gan_ms, flops


def _train_card_vs_cpu():
    """The fp32 train step (GAN phase on) of a narrow 6-level hierarchy on
    the card against the same port on the CPU: the same weights, batch,
    speaker-z noise (a CPU generator of one seed on both sides) and speaker
    permutation, dropout 0; every loss term and every gradient."""
    from ha2g_torch.config import Config
    from ha2g_torch.train.hierarchy import HierarchySystem
    from ha2g_torch.utils.roofline import count_flops

    cfg = Config.from_yaml(ROOT / "configs_expressive" / "hierarchy.yaml",
                           compute_dtype="float32", hidden_size=64,
                           n_layers=2, dropout_prob=0.0)
    systems = []
    for device in ("cpu", "cuda"):
        s = HierarchySystem(cfg, N_WORDS, N_SPEAKERS, device=device,
                            generator=torch.Generator().manual_seed(3))
        s.text.emb_dropout = 0.0
        for g in s.gens:
            g.text_encoder.emb_dropout = 0.0
        s.dis.gru.dropout = 0.0
        systems.append(s)
    cpu, gpu = systems
    gpu.load_state_dict(cpu.state_dict())
    batch = _train_batch(cfg, 8, 7)
    rand_vids = torch.from_numpy(np.roll(batch["vids"], 1))
    # each step under count_flops: the CPU (plain versions) and the card
    # (kernels, the backward on the autograd engine's thread) count alike
    got, flops = [], []
    for s in (cpu, gpu):
        got.append({})
        flops.append(count_flops(lambda: got[-1].update(s.train_step(
            batch, True, torch.Generator().manual_seed(4),
            rand_vids=rand_vids))))
    worst_metric = max(abs(float(got[1][k]) / float(got[0][k]) - 1)
                       for k in got[0])
    worst = {"audio": 0.0, "other": 0.0}
    gpu_params = dict(gpu.named_parameters())
    for key, p in cpu.named_parameters():
        want, have = p.grad, gpu_params[key].grad
        if want is None or have is None:
            if (want is None) != (have is None):
                raise AssertionError(f"{key}: gradient on one side only")
            continue
        if (have.cpu().double() - want.double()).norm() <= TRAIN_GRAD_FLOOR:
            continue
        group = "audio" if key.startswith("audio.") else "other"
        worst[group] = max(worst[group], _rel(have.cpu(), want))
    ok = (got[0].keys() == got[1].keys() and flops[0] == flops[1]
          and worst_metric <= TRAIN_METRIC_RTOL
          and worst["audio"] <= TRAIN_AUDIO_GRAD_REL
          and worst["other"] <= TRAIN_GRAD_REL)
    _line("train-fp32-card-vs-cpu", levels=cfg.skeleton.n_levels, hidden=64,
          gru_layers=2, batch=8, metrics=len(got[0]),
          metric_rel_err=f"{worst_metric:.2e}",
          grad_rel_err_audio=f"{worst['audio']:.2e}",
          grad_rel_err_other=f"{worst['other']:.2e}",
          tol=f"{TRAIN_METRIC_RTOL:.0e}/{TRAIN_AUDIO_GRAD_REL:.0e}/"
              f"{TRAIN_GRAD_REL:.0e}", flops_cpu=f"{flops[0]:.0f}",
          flops_card=f"{flops[1]:.0f}", ok=ok)
    if not ok:
        raise AssertionError("the fp32 train step on the card disagrees with "
                             "the CPU")



# ---------------------------------------------------------------------------
# the training driver: the loader, the command line, the trainer
# ---------------------------------------------------------------------------

def _loader_check():
    """The train loader on the card (pinned buffers, copies that overlap
    the device's work) against the host gather of the same seed, over two
    epochs, with a consumer that keeps the card busy between batches (a
    buffer reused before its copy has finished would show as a batch that
    differs)."""
    from ha2g_torch.data.dataset import WindowedSamples
    from ha2g_torch.data.loader import BatchLoader
    rng = np.random.default_rng(0)
    n, B = 1000, 96
    z = np.zeros
    samples = WindowedSamples(
        text=rng.integers(0, 64, (n, 34)).astype(np.int32),
        word_seq=z((n, 2), np.int32), word_lengths=z(n, np.int32),
        pose=z((n, 34, 3), np.float32),
        target=rng.normal(size=(n, 34, 126)).astype(np.float32),
        audio=z((n, 2), np.float32),
        spec=rng.normal(size=(n, 128, 70)).astype(np.float32),
        vids=np.arange(n, dtype=np.int32))
    keys = ("text", "spec", "target", "vids")
    host = BatchLoader(samples, B, keys=keys, seed=3)
    card = BatchLoader(samples, B, keys=keys, seed=3, device="cuda")
    busy = torch.randn((4096, 4096), device="cuda")
    mismatches = batches = 0
    for _ in range(2):
        # each batch's copy is queued behind the previous batch's work
        got_all = []
        for got in card:
            got_all.append(got)
            for _ in range(4):
                busy = busy @ busy.T / 4096.0
        torch.cuda.synchronize()
        for want, got in zip(host, got_all, strict=True):
            batches += 1
            mismatches += sum(not np.array_equal(got[k].cpu().numpy(),
                                                 want[k]) for k in keys)
    ok = mismatches == 0 and batches == 2 * len(host)
    _line("loader-check", batches=batches, batch=B,
          bytes_per_batch=card.batch_bytes(), mismatched_fields=mismatches,
          ok=ok)
    if not ok:
        raise AssertionError("the pinned loader gave batches that differ "
                             "from the host gather")


CLI_CONFIG = "configs_expressive/hierarchy.yaml"
# 8 s synthetic clips: 462 train windows (4 batches of 96) and 223 val
# windows (2 batches) through the windowing filter
CLI_CLIPS = {"train": (64, 0), "val": (32, 1)}
VAL_KEYS = ("loss", "joint_mae", "accel", "frechet", "feat_dist",
            "diversity")


def _cli_data(work: Path):
    """Stored clips and a seeded random MotionAE embedder for the
    command-line run; -> the train argv of the first run."""
    from ha2g_torch.checkpoint import save_embedder
    from ha2g_torch.config import Config
    from ha2g_torch.data.storage import save_clips
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.models.common import init_parameters_
    from ha2g_torch.models.motion_ae import MotionAE
    from ha2g_torch.skeleton import TED_EXPRESSIVE
    for split, (n, seed) in CLI_CLIPS.items():
        save_clips(work / split, synthetic_clips(
            TED_EXPRESSIVE, n_clips=n, n_speakers=8, seed=seed))
    net = MotionAE(126, 128)
    init_parameters_(net, torch.Generator().manual_seed(0))
    save_embedder(work / "embedder", net, Config(
        model="gesture_autoencoder", dataset="ted_expressive", pose_dim=126,
        n_poses=34, latent_dim=128))
    return ["train", "--config", str(ROOT / CLI_CONFIG),
            "--train_data_path", str(work / "train"),
            "--test_data_path", str(work / "val"),
            "--model_save_path", str(work / "out"),
            "--eval_net_path", str(work / "embedder"),
            "--random_seed", "0", "--loss_warmup", "0"]


def _cli_call(argv, want):
    """One ``cli.main`` call on the card; its kernel launches must equal
    ``want``.  -> its standard output."""
    import contextlib
    import io
    from ha2g_torch import cli
    before = _read_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = {k: v - before[k] for k, v in _read_counts().items()}
    ok = rc == 0 and counts == want
    _line("cli-call", command=argv[0], seconds=f"{seconds:.1f}", rc=rc,
          **{k: f"{counts[k]}/{want[k]}" for k in want}, ok=ok)
    if not ok:
        raise AssertionError(f"cli {argv[0]} failed its checks (rc {rc})")
    return buf.getvalue()


def _add(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _live_state(trainer):
    """A copy of what a trainer holds: every parameter and buffer, both
    Adam optimisers' state, the step count."""
    import copy
    system = trainer.system
    return copy.deepcopy({"model": system.state_dict(),
                          "g_opt": system.g_opt.state_dict(),
                          "d_opt": system.d_opt.state_dict(),
                          "step": trainer.step})


def _state_equal(have, want) -> int:
    """Every parameter, buffer and Adam state tensor of ``have`` equal to
    ``want``'s (both ``_live_state``s); -> the number of tensors compared."""
    n = 0
    if have["model"].keys() != want["model"].keys():
        raise AssertionError("the module's state keys differ")
    for k, v in want["model"].items():
        if not torch.equal(have["model"][k], v):
            raise AssertionError(f"{k} differs")
        n += 1
    for name in ("g_opt", "d_opt"):
        h, w = have[name], want[name]
        if h["param_groups"] != w["param_groups"] or \
                h["state"].keys() != w["state"].keys():
            raise AssertionError(f"{name} groups differ")
        for i, st in w["state"].items():
            if h["state"][i].keys() != st.keys():
                raise AssertionError(f"{name} state {i} keys differ")
            for k, v in st.items():
                if not torch.equal(h["state"][i][k], v):
                    raise AssertionError(f"{name} state {i}.{k} differs")
                n += 1
    return n


def _cli(work: Path):
    """python -m ha2g_torch.cli on the card at full width (TED Expressive,
    6 levels, hidden 300, 4-layer bi-GRU, batch 96, bf16): train 2 epochs
    (GAN on in the second), resume for a third, eval --bc, synthesize host
    and fused loop.  Checks every validation row, the checkpoints, the
    exact resume, the synthesis output and the launch counts of every
    kernel against the dataflow.  -> (the path's launch counts, the first
    train call's argv)."""
    import shutil
    from ha2g_torch import checkpoint as ckpt
    from ha2g_torch import cli
    from ha2g_torch.config import parse_cli
    from ha2g_torch.synthesis import _window_layout
    from ha2g_torch.train.loop import Trainer

    t0 = time.perf_counter()
    argv = _cli_data(work)
    cfg, lang, speaker, train_s, val_s = cli._prepare(parse_cli(argv[1:]))
    B = cfg.batch_size
    n_train, n_val = len(train_s) // B, len(val_s) // B
    _line("cli-data", train_windows=len(train_s), val_windows=len(val_s),
          train_batches=n_train, val_batches=n_val, words=lang.n_words,
          seconds=f"{time.perf_counter() - t0:.1f}")
    if n_train < 4 or n_val < 2:
        raise AssertionError("the clip sets are too small for the phase")
    zero = dict.fromkeys(_expected_counts(cfg, True), 0)
    per_eval = {**zero, "b1": n_val * cfg.skeleton.n_levels * cfg.n_layers}
    epoch = {g: {k: n_train * v for k, v in _expected_counts(cfg, g).items()}
             for g in (False, True)}
    _, _, W = _window_layout(cfg, 8.0)
    per_synth = {**zero, "b1": W * cfg.skeleton.n_levels * cfg.n_layers}
    out = work / "out"

    # the training run's own state when it writes checkpoint_final, for
    # the resume check (saving takes no launch)
    live = {}
    save = Trainer.save

    def save_and_keep(self, path, extra):
        if Path(path).name == "checkpoint_final":
            live.update(_live_state(self))
        save(self, path, extra)

    _reset_counts()
    Trainer.save = save_and_keep
    try:
        _cli_call(argv + ["--epochs", "2"], _add(
            per_eval, per_eval, per_eval, epoch[False], epoch[True]))
    finally:
        Trainer.save = save
    # resume from a copy: the resumed run writes checkpoint_final anew
    resume_point = work / "resume_point"
    shutil.copytree(out / "checkpoint_final", resume_point)
    _cli_call(argv + ["--epochs", "3", "--resume", str(resume_point)],
              _add(per_eval, per_eval, epoch[True]))
    printed = _cli_call(["eval", str(out / "checkpoint_best"), "--clips",
                         str(work / "val"), "--bc"], per_eval)
    synth = []
    for extra in ((), ("--fused",)):
        path = work / f"synth{len(extra)}.npz"
        _cli_call(["synthesize", str(out / "checkpoint_best"), "--n", "2",
                   "--out", str(path), *extra], per_synth)
        synth.append(np.load(path)["dir_vec"])
    counts = _read_counts()

    # every evaluation's metrics
    import ast
    rows = [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]
    evaluated = ast.literal_eval(printed.strip().splitlines()[-1])
    for r in rows:
        _line("cli-val", epoch=r["epoch"],
              **{k: f"{r[k]:.5f}" for k in VAL_KEYS})
    _line("cli-eval", **{k: f"{v:.5f}" for k, v in evaluated.items()})
    rows_ok = ([r["epoch"] for r in rows] == [0, 1, 2, 2, 3] and all(
        all(np.isfinite(r.get(k, np.nan)) for k in VAL_KEYS) for r in rows)
        and all(np.isfinite(evaluated.get(k, np.nan))
                for k in VAL_KEYS + ("BC",)))
    # the checkpoints load strictly; a fresh trainer resumed from the
    # resume point holds what the training run held when it saved
    trainer = Trainer(cfg, train_s, val_s, lang, speaker)
    start = trainer.resume(resume_point)
    n_equal = _state_equal(_live_state(trainer), live)
    ckpt.load_state(out / "checkpoint_best", trainer.system)
    ckpt.load_state(out / "checkpoint_final", trainer.system)
    step = ckpt.read_state(out / "checkpoint_final")["step"]
    frames = cfg.n_poses + (W - 1) * (cfg.n_poses - cfg.n_pre_poses)
    synth_ok = all(s.shape == (2, frames, 126) and np.isfinite(s).all()
                   for s in synth)
    ok = (rows_ok and synth_ok and n_equal > 0 and start == 2
          and trainer.step == live["step"] == 2 * n_train
          and step == live["step"] + n_train)
    _line("cli-checks", history_rows=len(rows), rows_finite=rows_ok,
          resume_epoch=start, resume_tensors_equal=n_equal,
          steps_after_resume=step,
          synth_shape=tuple(synth[0].shape), synth_finite=synth_ok,
          seconds=f"{time.perf_counter() - t0:.1f}", ok=ok)
    if not ok:
        raise AssertionError("the command-line run failed its checks")
    del trainer, live
    torch.cuda.empty_cache()
    return counts, argv


def _trainer_times(argv, bare_gan_ms, work: Path):
    """The trainer's numbers on the card at the command line's config: GAN
    epochs of ``train_epoch`` against a bare loop of ``train_step`` over
    the same batches already on the card, and against ``train_epoch``
    with a plain loader whose numpy batches ``train_step`` copies to the
    card synchronously (in turns: bare, trainer, plain, plain, trainer,
    bare, twice; phase 4's median GAN step beside them), the trainer
    epoch's idle share under torch.profiler, peak memory, host->device
    bytes a batch, one evaluate split into its parts (with and without
    BC), and a checkpoint's size, save and load time."""
    from ha2g_torch import checkpoint as ckpt
    from ha2g_torch import cli
    from ha2g_torch.config import parse_cli
    from ha2g_torch.data.loader import BatchLoader
    from ha2g_torch.train.loop import Trainer

    cfg, lang, speaker, train_s, val_s = cli._prepare(parse_cli(argv[1:]))
    trainer = Trainer(cfg, train_s, val_s, lang, speaker,
                      cli.make_evaluator(cfg, torch.device("cuda")))
    n = len(trainer.train_loader)
    trainer.train_epoch(0)
    trainer.train_epoch(1)      # the GAN step's first launches
    on_card = list(trainer.train_loader)

    def bare():
        for b in on_card:
            trainer.system.train_step(b, True, trainer.generator)

    pinned = trainer.train_loader
    plain = BatchLoader(train_s, cfg.batch_size, keys=pinned.keys)

    def plain_epoch():
        trainer.train_loader = plain
        try:
            trainer.train_epoch(1)
        finally:
            trainer.train_loader = pinned

    runs = {"bare": bare, "trainer": lambda: trainer.train_epoch(1),
            "plain": plain_epoch}
    wall = {k: [] for k in runs}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ("bare", "trainer", "plain", "plain", "trainer", "bare") * 2:
        t = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        wall[name].append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step = {k: statistics.mean(v) / n for k, v in wall.items()}
    _line("trainer-epoch", config=CLI_CONFIG, batches=n, gan_on=True,
          trainer_epoch_ms="/".join(f"{v:.1f}" for v in wall["trainer"]),
          bare_loop_ms="/".join(f"{v:.1f}" for v in wall["bare"]),
          plain_loader_epoch_ms="/".join(f"{v:.1f}" for v in wall["plain"]),
          trainer_step_ms=f"{step['trainer']:.1f}",
          bare_step_ms=f"{step['bare']:.1f}",
          plain_loader_step_ms=f"{step['plain']:.1f}",
          pinned_gain_ms_per_step=f"{step['plain'] - step['trainer']:.1f}",
          overhead_ms_per_step=f"{step['trainer'] - step['bare']:.1f}",
          samples_per_s=f"{cfg.batch_size / step['trainer'] * 1e3:.1f}",
          bare_samples_per_s=f"{cfg.batch_size / step['bare'] * 1e3:.1f}",
          phase4_gan_step_ms=f"{bare_gan_ms:.1f}",
          peak_memory_gib=f"{peak:.2f}",
          h2d_bytes_per_batch=trainer.train_loader.batch_bytes())
    kernels = ("b1", "b1_bwd", "b2", "b3", "b4")
    _profile(f"trainer_epoch:{CLI_CONFIG}", lambda: trainer.train_epoch(1),
             statistics.mean(wall["trainer"]), kernels,
             want={k: n * v for k, v in _expected_counts(cfg, True).items()})
    trainer.evaluate(1)
    for bc in (False, True):
        trainer.bc_enabled = bc
        t = time.perf_counter()
        val = trainer.evaluate(1)
        ms = (time.perf_counter() - t) * 1e3
        _line("trainer-evaluate", batch=cfg.batch_size,
              batches=len(trainer.val_loader), bc=bc, ms=f"{ms:.1f}",
              **{f"{k}_ms": f"{v * 1e3:.1f}"
                 for k, v in trainer.eval_times.items()},
              finite=all(np.isfinite(v) for v in val.values()))
    path = work / "timed_checkpoint"
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.save(path, {"epoch": 1})
    save_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    ckpt.load_state(path, trainer.system)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    size = sum(f.stat().st_size for f in path.iterdir())
    _line("trainer-checkpoint", bytes=size,
          state_pt_bytes=(path / "state.pt").stat().st_size,
          save_ms=f"{save_ms:.1f}", load_ms=f"{load_ms:.1f}")
    del trainer, on_card
    torch.cuda.empty_cache()


# Trainer.evaluate of one fp32 state on the card against the CPU: the same
# network in another summation order (cuDNN with TF32 off and cuBLAS
# against the CPU's) through the SE-ResNet and the cascade; loss, MAJE and
# accel relative 1e-4.  frechet and feat_dist go through the embedder and
# a sqrtm of covariance products: 1e-3 relative.
EVAL_RTOL = {"loss": 1e-4, "joint_mae": 1e-4, "accel": 1e-4,
             "frechet": 1e-3, "feat_dist": 1e-3}


def _eval_card_vs_cpu(work: Path):
    from ha2g_torch import cli
    from ha2g_torch.config import parse_cli
    from ha2g_torch.train.loop import Trainer
    argv = ["--config", str(ROOT / CLI_CONFIG),
            "--train_data_path", str(work / "val"),
            "--test_data_path", str(work / "val"),
            "--eval_net_path", str(work / "embedder"),
            "--compute_dtype", "float32", "--hidden_size", "64",
            "--n_layers", "2", "--random_seed", "0"]
    cfg, lang, speaker, _, val_s = cli._prepare(parse_cli(argv))
    got = {}
    trainers = {}
    for device in ("cpu", "cuda"):
        d = torch.device(device)
        trainers[device] = Trainer(cfg, val_s, val_s, lang, speaker,
                                   cli.make_evaluator(cfg, d), device=d)
    trainers["cuda"].system.load_state_dict(
        trainers["cpu"].system.state_dict())
    for device, trainer in trainers.items():
        got[device] = trainer.evaluate(0)
    err = {k: abs(got["cuda"][k] / got["cpu"][k] - 1) for k in EVAL_RTOL}
    ok = all(err[k] <= EVAL_RTOL[k] for k in EVAL_RTOL)
    _line("eval-fp32-card-vs-cpu", levels=cfg.skeleton.n_levels, hidden=64,
          gru_layers=2, batch=cfg.batch_size,
          batches=len(trainers["cpu"].val_loader),
          **{f"{k}_rel_err": f"{e:.2e}" for k, e in err.items()},
          **{f"{k}_card": f"{got['cuda'][k]:.6f}" for k in EVAL_RTOL},
          tol="/".join(f"{v:.0e}" for v in EVAL_RTOL.values()), ok=ok)
    if not ok:
        raise AssertionError("fp32 evaluation on the card disagrees with the "
                             "CPU")


# ---------------------------------------------------------------------------
# bf16 training against fp32 (the budgets of tests/test_precision.py)
# ---------------------------------------------------------------------------

DRIFT_STEPS, DRIFT_WARMUP = 12, 6
# per-step relative drift budget min(base * (i + 1), cap): the core terms,
# and phy / DIV_REG (acos near its clamp edges; a ratio of near-cancelling
# L1 differences)
DRIFT_CORE = (2e-2, 0.35)
DRIFT_BUDGET = {"phy": (8e-2, 0.8), "DIV_REG": (8e-2, 0.8)}
# The test's end-of-run bound, max(25%, 5e-2) absolute, on FGD and the
# feature distance cannot fail here: through a seeded random embedder
# both are far under 5e-2 (FGD ~3e-5, feature distance ~0.03 at hidden
# 16).  The feature distance is also held to 2% relative: bf16 and fp32
# were 0.2% apart on the H100 at both widths.
FEAT_RTOL = 2e-2


def _drift(cfg, n_words, n_speakers, embedder, latent_dim, check: bool):
    """fp32 and bf16 from identical weights over the same 12 batches and
    generator seeds (6 warm-up, 6 GAN steps); the worst relative drift of
    every loss term, and FGD / feature distance of both populations through
    one frozen fp32 embedder."""
    from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator
    from ha2g_torch.models.common import init_parameters_
    from ha2g_torch.train.hierarchy import HierarchySystem
    B, T = cfg.batch_size, cfg.n_poses

    def stream_batch(seed):
        rng = np.random.default_rng(seed)
        return {"text": rng.integers(0, n_words, (B, T)),
                "spec": rng.normal(size=(B, 128, 70)).astype(np.float32),
                "target": (rng.normal(size=(B, T, cfg.skeleton.pose_dim))
                           .astype(np.float32) * 0.2),
                "vids": rng.integers(0, n_speakers, (B,))}

    systems = {dt: HierarchySystem(cfg.replace(compute_dtype=dt), n_words,
                                   n_speakers, generator=torch.Generator()
                                   .manual_seed(0))
               for dt in ("float32", "bfloat16")}
    systems["bfloat16"].load_state_dict(systems["float32"].state_dict())
    worst, failed = {}, []
    for i in range(DRIFT_STEPS):
        gan_on = i >= DRIFT_WARMUP
        batch = stream_batch(100 + i)
        out = {dt: {k: float(v) for k, v in s.train_step(
            batch, gan_on, torch.Generator("cuda").manual_seed(42 + i))
            .items()} for dt, s in systems.items()}
        for k, want in out["float32"].items():
            got = out["bfloat16"][k]
            err = abs(got - want) / max(abs(want), 1e-3)
            base, cap = DRIFT_BUDGET.get(k, DRIFT_CORE)
            worst[k] = max(worst.get(k, 0.0), err)
            if not np.isfinite(got) or err > min(base * (i + 1), cap):
                failed.append((i, k, err))
    init_parameters_(embedder, torch.Generator().manual_seed(77))
    evaluator = EmbeddingSpaceEvaluator(cfg.skeleton.pose_dim, T,
                                        embedder.state_dict(),
                                        latent_dim=latent_dim)
    scores = {}
    for dt, s in systems.items():
        evaluator.reset()
        for j in range(4):
            b = stream_batch(900 + j)
            o, _ = s.eval_step(b, torch.Generator().manual_seed(500 + j))
            evaluator.push_samples(o, b["target"])
        scores[dt] = evaluator.get_scores()
    (fd_f, feat_f), (fd_b, feat_b) = scores["float32"], scores["bfloat16"]
    feat_rel = abs(feat_b / feat_f - 1)
    fgd_ok = (abs(fd_b - fd_f) <= max(0.25 * abs(fd_f), 5e-2)
              and abs(feat_b - feat_f) <= max(0.25 * abs(feat_f), 5e-2)
              and feat_rel <= FEAT_RTOL)
    ok = not failed and fgd_ok
    _line("bf16-drift", dataset=cfg.dataset, levels=cfg.skeleton.n_levels,
          hidden=cfg.hidden_size, gru_layers=cfg.n_layers, batch=B,
          steps=DRIFT_STEPS, gan_steps=DRIFT_STEPS - DRIFT_WARMUP,
          asserted=check, **{f"worst_{k}": f"{v:.2e}"
                             for k, v in sorted(worst.items())},
          over_budget=len(failed), fgd_f32=f"{fd_f:.4e}",
          fgd_bf16=f"{fd_b:.4e}", feat_f32=f"{feat_f:.6f}",
          feat_bf16=f"{feat_b:.6f}", feat_rel=f"{feat_rel:.2e}",
          feat_rtol=FEAT_RTOL, ok=ok)
    for i, k, err in failed[:8]:
        _line("bf16-drift-over", step=i, key=k, drift=f"{err:.2e}")
    if check and not ok:
        raise AssertionError("bf16 training drifts from fp32 beyond the "
                             "budgets of tests/test_precision.py")
    del systems
    torch.cuda.empty_cache()


def _bf16_drift():
    from ha2g_torch.config import Config
    from ha2g_torch.models.embedding_net import EmbeddingNet
    from ha2g_torch.models.motion_ae import MotionAE
    # tests/test_precision.py::test_bf16_trajectory_tracks_fp32's setup
    small = Config(model="hierarchy", hidden_size=16, n_layers=2,
                   batch_size=8, z_type="speaker", loss_gan_weight=5.0,
                   loss_kld_weight=0.1, loss_reg_weight=0.05,
                   loss_physical_weight=0.01)
    _drift(small, 12, 3, EmbeddingNet(27, 34), 32, check=True)
    full = Config.from_yaml(ROOT / CLI_CONFIG)
    _drift(full, N_WORDS, N_SPEAKERS, MotionAE(126, 128), 128, check=False)


# ---------------------------------------------------------------------------
# phase 8: serving a checkpoint
# ---------------------------------------------------------------------------

SERVE_CLIP_SECONDS = 20.0
SERVE_MAX_BATCH = 16
# turns of (service, HTTP, direct call) for one request's latency
SERVE_TURNS = 20
# the fp32 stream (length known, an early peak) against generate: the
# bound the fp32 serving path meets between the card and the CPU
STREAM_ATOL = 1e-3


def _b1_launches() -> int:
    from ha2g_torch.ops.gru_kernel import gru_recurrence
    return gru_recurrence.launches


def _expect_b1(step: str, before: int, want: int) -> int:
    """B1's launches since ``before`` must be ``want``; -> them."""
    got = _b1_launches() - before
    if got != want:
        raise AssertionError(f"{step}: {got} B1 launches, the dataflow "
                             f"gives {want}")
    return got


def _serve_clip(seconds, seed, click=False):
    """A clip of noise and its words; ``click`` puts the loudest frame in
    the first window (a stream's running dB reference is then the whole
    clip's from window 0 on)."""
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=int(seconds * SR)) * 0.05).astype(np.float32)
    if click:
        audio[8000:8640] += np.sin(np.arange(640) * 0.7).astype(np.float32)
    words = [(f"w{rng.integers(0, 40)}", float(t), float(t + 0.3))
             for t in np.arange(0.3, seconds - 0.5, 0.45)]
    return audio, words


def _http(url, obj=None, timeout=300):
    """GET (obj None) or POST JSON; -> (status, decoded body)."""
    import urllib.error
    import urllib.request
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode(errors="replace")}


def _serve_checkpoints(work: Path):
    """Seed-0 weights of the full-width TED Expressive hierarchy saved as a
    port checkpoint (bf16 and fp32 configs), then ``export-checkpoint`` to
    a reference .bin and ``import-checkpoint`` back: every tensor equal,
    ref_routing_compat on.  -> (bf16 dir, fp32 dir, lang)."""
    from ha2g_torch import checkpoint as ckpt
    from ha2g_torch import cli
    from ha2g_torch.config import Config
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.train.hierarchy import HierarchySystem

    cfg = Config.from_yaml(ROOT / CLI_CONFIG)
    lang = _vocab()
    speaker = Vocab("vid", insert_default_tokens=False)
    for i in range(N_SPEAKERS - speaker.n_words):
        speaker.index_word(f"s{i}")
    system = HierarchySystem(cfg, lang.n_words, speaker.n_words,
                             generator=torch.Generator().manual_seed(0))
    seconds = {}
    t = time.perf_counter()
    ckpt.save_checkpoint(work / "ckpt", system, cfg, lang, speaker)
    seconds["save"] = time.perf_counter() - t
    ckpt.save_checkpoint(work / "ckpt32", system,
                         cfg.replace(compute_dtype="float32"), lang, speaker)
    for name, argv in (("export", ["export-checkpoint", str(work / "ckpt"),
                                   str(work / "ref.bin")]),
                       ("import", ["import-checkpoint", str(work / "ref.bin"),
                                   str(work / "imported")])):
        t = time.perf_counter()
        _cli_call(argv, dict.fromkeys(_read_counts(), 0))
        seconds[name] = time.perf_counter() - t
    want = ckpt.read_state(work / "ckpt")["model"]
    got = ckpt.read_state(work / "imported")["model"]
    equal = want.keys() == got.keys() and all(
        torch.equal(got[k], v) for k, v in want.items())
    compat = ckpt.load_config(work / "imported")[0].ref_routing_compat
    ok = equal and compat
    _line("ckpt-bridge", tensors=len(want), equal=equal,
          ref_routing_compat=compat,
          bin_bytes=(work / "ref.bin").stat().st_size,
          **{f"{k}_s": f"{v:.2f}" for k, v in seconds.items()}, ok=ok)
    if not ok:
        raise AssertionError("the checkpoint bridge failed its checks")
    del system
    return work / "ckpt", work / "ckpt32", lang


def _serve_service(ckpt_dir, lang, paths):
    """GestureService: warm-up; one 20 s request through the service, over
    HTTP and as a direct call, in turns; 8 and 16 concurrent requests
    against the rows of direct calls on the same padded batches; the HTTP
    API in every encoding; a profile of one request."""
    import base64
    import threading
    from ha2g_torch.ops.mel import mulaw_encode_np
    from ha2g_torch.serve import GestureService, make_http_server
    from ha2g_torch.synthesis import _window_layout

    _, _, W = _window_layout(_config("bfloat16"), SERVE_CLIP_SECONDS)
    per_call = W * 24
    out = {}
    before = _b1_launches()
    t = time.perf_counter()
    svc = GestureService(str(ckpt_dir), max_clip_seconds=SERVE_CLIP_SECONDS,
                         max_batch=SERVE_MAX_BATCH)
    out["warmup_s"] = time.perf_counter() - t
    _, _, w_stream = _window_layout(svc.cfg, 4.0)
    paths["serving:service"] += _expect_b1(
        "serve-warmup", before,
        svc.stats["batches"] * per_call + w_stream * 24)
    _line("serve-warmup", seconds=f"{out['warmup_s']:.1f}",
          buckets=svc.buckets, batches=svc.stats["batches"],
          requests=svc.stats["requests"], stream_windows=w_stream)
    synth = svc.synth
    httpd = make_http_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        # one request: the service, HTTP and the direct call in turns
        audio, words = _serve_clip(SERVE_CLIP_SECONDS, 1)
        vids = np.asarray([3])
        n_frames = int(round(SERVE_CLIP_SECONDS * svc.fps))
        body = {"audio": base64.b64encode(audio.astype("<f4").tobytes())
                .decode(), "words": [list(w) for w in words], "vid": 3}

        def http_call():
            code, resp = _http(f"{url}/synthesize", body)
            if code != 200:
                raise AssertionError(f"POST /synthesize: {code} {resp}")
            return np.frombuffer(base64.b64decode(resp["dir_vec"]), "<f4") \
                .reshape(resp["shape"])

        calls = {"service": lambda: svc.synthesize(audio, words, vid=3),
                 "http": http_call,
                 "direct": lambda: synth.generate_fused(
                     audio[None], [words], lang, vids)[0][:n_frames]}
        results = {k: fn() for k, fn in calls.items()}
        err = max(float(np.abs(results[k] - results["direct"]).max())
                  for k in ("service", "http"))
        times = {k: [] for k in calls}
        b0, n0 = _b1_launches(), svc.stats["batches"]
        for rep in range(SERVE_TURNS):
            for k in (calls if rep % 2 == 0 else reversed(list(calls))):
                t = time.perf_counter()
                calls[k]()
                times[k].append((time.perf_counter() - t) * 1e3)
        batches = svc.stats["batches"] - n0
        _expect_b1("serve-request", b0, (batches + SERVE_TURNS) * per_call)
        paths["serving:service"] += batches * per_call
        med = {k: statistics.median(v) for k, v in times.items()}
        # each turn's own difference: the host's drift between turns
        # cancels out of it
        paired = {k: np.percentile(np.subtract(times[k], times["direct"]),
                                   [25, 50, 75]) for k in ("service", "http")}
        ok = results["service"].shape == (n_frames, 126) and err == 0.0 \
            and batches == 2 * SERVE_TURNS
        _line("serve-request", clip_seconds=SERVE_CLIP_SECONDS, windows=W,
              turns=SERVE_TURNS, service_ms=f"{med['service']:.2f}",
              http_ms=f"{med['http']:.2f}",
              direct_generate_fused_ms=f"{med['direct']:.2f}",
              service_ms_range=f"{min(times['service']):.2f}-"
              f"{max(times['service']):.2f}",
              direct_ms_range=f"{min(times['direct']):.2f}-"
              f"{max(times['direct']):.2f}",
              **{f"{k}_minus_direct_ms_q1_median_q3":
                 "/".join(f"{x:.2f}" for x in v) for k, v in paired.items()},
              max_abs_err_vs_direct=f"{err:.3e}", ok=ok)
        if not ok:
            raise AssertionError("a service request differs from the "
                                 "direct call")
        out.update(service_ms=med["service"], direct_ms=med["direct"],
                   http_ms=med["http"])

        # concurrent requests; record each batch to rebuild it directly
        groups = []
        run = svc._run

        def recording_run(group, fused):
            groups.append(list(group))
            run(group, fused)

        svc._run = recording_run
        for n in (8, 16):
            clips = [_serve_clip(SERVE_CLIP_SECONDS - 0.5 * (i % 4), 10 + i)
                     for i in range(n)]
            answers = [None] * n
            groups.clear()
            b0, n0 = _b1_launches(), svc.stats["batches"]

            def call(i):
                a, w = clips[i]
                answers[i] = svc.synthesize(a, w, vid=i % N_SPEAKERS)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            wall = time.perf_counter() - t
            batches = svc.stats["batches"] - n0
            paths["serving:service"] += _expect_b1(
                f"serve-concurrent n={n}", b0, batches * per_call)
            err = 0.0
            for group in groups:
                a, w, v = svc.padded_batch(group)
                want = synth.generate_fused(a, w, lang, v)
                for i, r in enumerate(group):
                    err = max(err, float(np.abs(
                        r.result - want[i, :len(r.result)]).max()))
            ok = batches < n and err == 0.0 and all(
                r is not None and np.isfinite(r).all() for r in answers)
            frames = sum(len(r) for r in answers if r is not None)
            _line("serve-concurrent", requests=n, batches=batches,
                  batch_sizes=[len(g) for g in groups],
                  wall_ms=f"{wall * 1e3:.2f}", frames=frames,
                  frames_per_s=f"{frames / wall:.1f}",
                  max_abs_err_vs_direct_rows=f"{err:.3e}", ok=ok)
            if not ok:
                raise AssertionError(f"{n} concurrent requests failed "
                                     "their checks")
        svc._run = run

        # the HTTP API in every encoding and return type
        b0, n0 = _b1_launches(), svc.stats["batches"]
        codes = {}
        raws = {"pcm_f32": audio.astype("<f4").tobytes(),
                "pcm_i16": (audio * 32767).astype("<i2").tobytes(),
                "pcm_mulaw": mulaw_encode_np(audio).tobytes()}
        for enc, raw in raws.items():
            for rd in ("f32", "f16"):
                code, resp = _http(f"{url}/synthesize", {
                    **body, "audio": base64.b64encode(raw).decode(),
                    "encoding": enc, "return_dtype": rd})
                codes[f"{enc}/{rd}"] = code
                if code != 200 or resp["shape"] != [n_frames, 126]:
                    raise AssertionError(f"POST /synthesize {enc} {rd}: "
                                         f"{code} {resp.get('error')}")
        for path in ("/healthz", "/stats"):
            codes[path], resp = _http(url + path)
        paths["serving:service"] += _expect_b1(
            "serve-http", b0, (svc.stats["batches"] - n0) * per_call)
        ok = all(c == 200 for c in codes.values()) and resp["errors"] == 0
        _line("serve-http", codes=codes, errors=resp["errors"], ok=ok)
        if not ok:
            raise AssertionError("the HTTP API failed its checks")

        b0 = _b1_launches()
        _profile("service:B=1", calls["service"], med["service"])
        paths["serving:service"] += _expect_b1("serve-profile", b0, per_call)
        if svc.stats["errors"]:
            raise AssertionError(f"{svc.stats['errors']} service errors")
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    return out


def _serve_streams(ckpt_dir, ckpt32_dir, lang, paths):
    """Live streams: a 20 s clip in 100 ms feeds; the fp32 stream against
    generate (1e-3) and the bf16 one (printed); 8 concurrent streams
    through the stream batcher."""
    import threading
    from ha2g_torch.serve import GestureService
    from ha2g_torch.synthesis import _window_layout

    out = {}
    svc = GestureService(str(ckpt_dir), max_clip_seconds=SERVE_CLIP_SECONDS,
                         max_batch=SERVE_MAX_BATCH, warm=False)
    try:
        cfg = svc.cfg
        _, _, W = _window_layout(cfg, SERVE_CLIP_SECONDS)
        frames = cfg.n_poses + (W - 1) * (cfg.n_poses - cfg.n_pre_poses)
        audio, words = _serve_clip(SERVE_CLIP_SECONDS, 2)
        sid = svc.open_stream(vid=1)
        svc.stream_feed(sid, words=words)
        chunk = int(0.1 * SR)
        lat, emitted = [], 0
        b0 = _b1_launches()
        for i in range(0, len(audio), chunk):
            t = time.perf_counter()
            emitted += len(svc.stream_feed(sid, audio[i:i + chunk]))
            lat.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        emitted += len(svc.stream_finish(sid))
        finish_ms = (time.perf_counter() - t) * 1e3
        paths["serving:stream"] += _expect_b1("stream-feed", b0, W * 24)
        p50, p95 = np.percentile(lat, [50, 95])
        ok = emitted == frames and \
            len(lat) == round(SERVE_CLIP_SECONDS * 10)
        _line("stream-feed", feeds=len(lat), chunk_ms=100, windows=W,
              feed_ms_p50=f"{p50:.2f}", feed_ms_p95=f"{p95:.2f}",
              feed_ms_max=f"{max(lat):.2f}", finish_ms=f"{finish_ms:.2f}",
              frames_emitted=emitted, batch_frames=frames, ok=ok)
        if not ok:
            raise AssertionError("the stream emitted the wrong frames")
        out.update(feed_p50=p50, feed_p95=p95)
    finally:
        svc.close()

    # the stream (length known, early peak) against generate
    audio, words = _serve_clip(SERVE_CLIP_SECONDS, 3, click=True)
    for name, path in (("float32", ckpt32_dir), ("bfloat16", ckpt_dir)):
        svc = GestureService(str(path), max_clip_seconds=SERVE_CLIP_SECONDS,
                             max_batch=SERVE_MAX_BATCH, warm=False)
        try:
            want = svc.synth.generate(audio[None], [words], lang,
                                      np.asarray([2]))[0]
            b0 = _b1_launches()
            sid = svc.open_stream(vid=2, total_seconds=SERVE_CLIP_SECONDS)
            got = [svc.stream_feed(sid, words=words)]
            for i in range(0, len(audio), SR):
                got.append(svc.stream_feed(sid, audio[i:i + SR]))
            got.append(svc.stream_finish(sid))
            paths["serving:stream"] += _expect_b1(f"stream-vs-batch {name}",
                                                  b0, W * 24)
            got = np.concatenate(got)
            err = float(np.abs(got - want).max())
            ok = got.shape == want.shape and (name == "bfloat16"
                                              or err <= STREAM_ATOL)
            _line("stream-vs-batch", dtype=name, shape=tuple(got.shape),
                  max_abs_err=f"{err:.3e}",
                  tol=f"{STREAM_ATOL:.0e}" if name == "float32"
                  else "printed", ok=ok)
            if not ok:
                raise AssertionError(f"the {name} stream differs from "
                                     "generate")
            out[f"stream_err_{name}"] = err
        finally:
            svc.close()

    # 8 concurrent streams through the stream batcher
    svc = GestureService(str(ckpt_dir), max_clip_seconds=SERVE_CLIP_SECONDS,
                         max_batch=SERVE_MAX_BATCH, warm=False,
                         stream_batching=True)
    try:
        clips = [_serve_clip(10.0, 30 + i) for i in range(8)]
        results = [None] * 8
        b0 = _b1_launches()

        def run(i):
            a, w = clips[i]
            sid = svc.open_stream(vid=i % N_SPEAKERS)
            outs = [svc.stream_feed(sid, words=w)]
            for j in range(0, len(a), SR // 2):
                outs.append(svc.stream_feed(sid, a[j:j + SR // 2]))
            outs.append(svc.stream_finish(sid))
            results[i] = np.concatenate(outs)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        st = svc.stats
        paths["serving:stream_batched"] += _expect_b1(
            "stream-batching", b0, st["stream_batches"] * 24)
        _, _, w10 = _window_layout(svc.cfg, 10.0)
        ok = (st["stream_windows"] == 8 * w10
              and st["stream_batches"] < st["stream_windows"]
              and all(r is not None and np.isfinite(r).all()
                      for r in results) and st["errors"] == 0)
        _line("stream-batching", streams=8, windows=st["stream_windows"],
              batches=st["stream_batches"], wall_ms=f"{wall * 1e3:.2f}",
              ok=ok)
        if not ok:
            raise AssertionError("the stream batcher failed its checks")
    finally:
        svc.close()
    return out


def _serve_cli(ckpt_dir, work: Path, paths):
    """``cli serve`` as a process answering one POST; ``from-text --wav``
    and ``synthesize --fade_out`` in process."""
    import base64
    import socket
    import wave
    from ha2g_torch.synthesis import _window_layout

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ha2g_torch.cli", "serve", str(ckpt_dir),
         "--port", str(port), "--max_batch", "4"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        code = None
        while time.perf_counter() - t < 300 and proc.poll() is None:
            try:
                code, _ = _http(f"{url}/healthz", timeout=5)
                break
            except OSError:
                time.sleep(1.0)
        ready_s = time.perf_counter() - t
        audio, words = _serve_clip(4.0, 5)
        post, resp = _http(f"{url}/synthesize", {
            "audio": base64.b64encode(audio.astype("<f4").tobytes()).decode(),
            "words": [list(w) for w in words]}) if code == 200 else (None, {})
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    ok = code == 200 and post == 200 and resp.get("shape") == [60, 126]
    _line("cli-serve", healthz=code, post=post, shape=resp.get("shape"),
          ready_s=f"{ready_s:.1f}", exit=proc.returncode, ok=ok)
    if not ok:
        print(log[-4000:], flush=True)
        raise AssertionError("cli serve failed its checks")

    pcm = (np.random.default_rng(6).normal(size=int(6 * SR)) * 3000) \
        .astype("<i2")
    wav = work / "speech.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    cfg = _config("bfloat16")
    zero = dict.fromkeys(_read_counts(), 0)
    before = _read_counts()
    _, _, W = _window_layout(cfg, 6.0)
    _cli_call(["from-text", str(ckpt_dir), "--text",
               "so this is how we talk with our hands", "--wav", str(wav),
               "--out", str(work / "text.npz")], {**zero, "b1": W * 24})
    text = np.load(work / "text.npz")["dir_vec"]
    _, _, W8 = _window_layout(cfg, 8.0)
    _cli_call(["synthesize", str(ckpt_dir), "--n", "2", "--fade_out",
               "--out", str(work / "faded.npz")], {**zero, "b1": W8 * 24})
    faded = np.load(work / "faded.npz")["dir_vec"]
    paths["serving:cli"] += _read_counts()["b1"] - before["b1"]
    frames = lambda w: cfg.n_poses + (w - 1) * (cfg.n_poses - cfg.n_pre_poses)
    ok = (text.shape == (1, frames(W) + 8, 126)
          and faded.shape == (2, frames(W8) + 8, 126)
          and np.isfinite(text).all() and np.isfinite(faded).all())
    _line("cli-from-text-fade-out", from_text=tuple(text.shape),
          synthesize_fade_out=tuple(faded.shape), ok=ok)
    if not ok:
        raise AssertionError("from-text / synthesize --fade_out failed")


def _serving(work: Path):
    """Phase 8; -> (launch counts of every kernel by path, numbers)."""
    _reset_counts()
    paths = dict.fromkeys(("serving:service", "serving:stream",
                           "serving:stream_batched", "serving:cli"), 0)
    t0 = time.perf_counter()
    ckpt_dir, ckpt32_dir, lang = _serve_checkpoints(work)
    numbers = _serve_service(ckpt_dir, lang, paths)
    numbers.update(_serve_streams(ckpt_dir, ckpt32_dir, lang, paths))
    _serve_cli(ckpt_dir, work, paths)
    counts = _read_counts()
    if any(counts[k] for k in ("b1_bwd", "b2", "b3", "b4")):
        raise AssertionError("training kernels launched while serving")
    _line("serving-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k.split(":")[1]: v for k, v in paths.items()})
    return paths, numbers


# ---------------------------------------------------------------------------
# phases 9 and 10: the baseline families
# ---------------------------------------------------------------------------

# phase 9, the GAN baselines: the shipped configs at full width (batch
# 128), bf16, and the gan_on of each step: a warm-up step and three GAN
# steps (speech2gesture's step has no warm-up: four alike)
BASELINE_RUNS = (("configs_expressive/multimodal_context.yaml",
                  (False, True, True, True)),
                 ("configs/speech2gesture.yaml", (True, True, True, True)))
# phase 10, the text and embedding baselines: the shipped configs at full
# width, bf16, a warm-up and three steps (no GAN phase)
TEXT_RUNS = tuple((config, (True,) * 4) for config in (
    "configs_expressive/seq2seq.yaml", "configs_expressive/joint_embed.yaml",
    "configs/gesture_autoencoder.yaml",
    "configs_expressive/gesture_autoencoder.yaml"))
BASELINE_AUDIO_LEN = 36267      # round(34 / 15 * 16000): a train window
WORD_SEQ = 32       # the word sequences' width (synthesizer and windows)
# the masked seq2seq encoder on the card: its batches (the service's 1, 4
# and 8, the train batch 128; the evaluate's batch is held where it runs)
# and its hidden size and layers
MASKED_ENCODER_BATCHES = (1, 4, 8, 128)
MASKED_ENCODER = (200, 2)
# the embedders' loop: (the embedder's config, the config of the run that
# names it as eval_net_path, its clips' skeleton)
EMBEDDER_LOOPS = (("configs/gesture_autoencoder.yaml",
                   "configs/seq2seq.yaml", "TED_GESTURE"),
                  ("configs_expressive/gesture_autoencoder.yaml",
                   "configs_expressive/joint_embed.yaml", "TED_EXPRESSIVE"))


def _baseline_cfg(config, **overrides):
    from ha2g_torch.config import Config
    return Config.from_yaml(ROOT / config, **{
        "compute_dtype": "bfloat16", "eval_net_path": "", **overrides})


def _family(cfg) -> str:
    """The model's path name; the embedders by their pose width."""
    if cfg.model == "gesture_autoencoder":
        return f"gesture_autoencoder:{cfg.pose_dim}"
    return cfg.model


def _word_seqs(rng, B):
    """(B, 32) SOS..EOS token rows zero-padded past their length (drawn in
    [2, 32], 32 and 2 among them) and the lengths."""
    lengths = rng.integers(2, WORD_SEQ + 1, B)
    lengths[:2] = (WORD_SEQ, 2)[:B]
    seq = np.zeros((B, WORD_SEQ), np.int64)
    for b, n in enumerate(lengths):
        seq[b, :n] = rng.integers(4, N_WORDS, n)
        seq[b, 0], seq[b, n - 1] = 1, 2
    return seq, lengths


def _baseline_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    T = cfg.n_poses
    batch = {"text": rng.integers(0, N_WORDS, (B, T)),
             "audio": (rng.normal(size=(B, BASELINE_AUDIO_LEN)) * 0.1)
             .astype(np.float32),
             "spec": rng.normal(size=(B, 128, 70)).astype(np.float32),
             "target": (rng.normal(size=(B, T, cfg.pose_dim)) * 0.2)
             .astype(np.float32),
             "vids": rng.integers(0, N_SPEAKERS, (B,))}
    batch["word_seq"], batch["word_lengths"] = _word_seqs(rng, B)
    return batch


def _window_b1(cfg) -> int:
    """B1 launches of one generator forward (a synthesis window, an eval
    batch): a bidirectional GRU layer each.  joint_embedding: its 4-layer
    decoder (its context GRU is unidirectional, plain ops);
    speech2gesture and the embedders run no GRU."""
    return {"multimodal_context": cfg.n_layers, "seq2seq": cfg.n_layers,
            "joint_embedding": 4}.get(cfg.model, 0)


def _baseline_expected(cfg, gan_on):
    """Per train step of a baseline: multimodal_context launches B1 once a
    GRU layer a generator call (the D phase's fake, the G forward, the
    diversity forward with speaker / random z and a positive weight) and
    once a D layer a D call (D(out) always, D(real) and D(fake) in the D
    phase), and its backward for the G forward, D(out) with the GAN term
    and both D-phase calls (the diversity forward's output and z are
    detached by the regulariser, so it takes no backward).  The others
    run one forward and its backward.  No contrastive loss in any."""
    zero = {"b1": 0, "b1_backward": 0, "b1_bwd": 0, "b2": 0, "b3": 0,
            "b4": 0, "add_norm": 0}
    if cfg.model != "multimodal_context":
        n = _window_b1(cfg)
        return {**zero, "b1": n, "b1_backward": n, "b1_bwd": n}
    L, d_layers = cfg.n_layers, 4
    d_phase = gan_on and cfg.loss_gan_weight > 0.0
    div = cfg.z_type in ("speaker", "random") and cfg.loss_reg_weight > 0.0
    fwd = L * (1 + d_phase + div) + d_layers * (1 + 2 * d_phase)
    bwd = L + d_layers * (gan_on + 2 * d_phase)
    return {**zero, "b1": fwd, "b1_backward": bwd, "b1_bwd": bwd}


def _baseline_step(system, cfg, generator):
    """-> step(batch, gan_on): the family's own train_step (gan_on reaches
    multimodal_context alone; the TED Expressive embedder steps at epoch
    0's learning rate)."""
    if cfg.model == "multimodal_context":
        return lambda b, gan_on, **kw: system.train_step(b, gan_on,
                                                         generator, **kw)
    if cfg.model == "gesture_autoencoder" and cfg.pose_dim == 126:
        return lambda b, gan_on: system.train_step(
            b, generator, lr=system.lr_for_epoch(0))
    return lambda b, gan_on: system.train_step(b, generator)


def _baseline_train(config, steps):
    """Train steps of a baseline at full width: launch counts step by
    step, finite losses, step times, peak memory, and a profile of one
    (GAN) step with its device busy ms, idle share and device operations.
    -> the kernels' launch counts over the steps."""
    from ha2g_torch.train.loop import build_system

    cfg = _baseline_cfg(config)
    family = _family(cfg)
    B = cfg.batch_size
    t0 = time.perf_counter()
    system = build_system(cfg, N_WORDS, N_SPEAKERS,
                          generator=torch.Generator().manual_seed(0))
    _line("baseline-build", config=config, model=family,
          system=type(system).__name__,
          seconds=f"{time.perf_counter() - t0:.1f}",
          params=sum(p.numel() for p in system.parameters()), batch=B,
          compute_dtype=cfg.compute_dtype, hidden=cfg.hidden_size,
          gru_layers=cfg.n_layers, batch_keys=",".join(system.batch_keys))
    step = _baseline_step(system, cfg, torch.Generator(device="cuda")
                          .manual_seed(1))
    batches = [_baseline_batch(cfg, B, 300 + i) for i in range(len(steps))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = []
    for i, (gan_on, batch) in enumerate(zip(steps, batches)):
        before = _read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(batch, gan_on)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = {k: v - before[k] for k, v in _read_counts().items()}
        want = _baseline_expected(cfg, gan_on)
        values = {k: float(v) for k, v in metrics.items()}
        finite = all(np.isfinite(v) for v in values.values())
        ok = finite and counts == want
        _line("baseline-step", model=family, step=i, gan_on=gan_on,
              ms=f"{ms:.1f}", finite=finite,
              **{k: f"{v:.4f}" for k, v in values.items()})
        _line("baseline-launches", model=family, step=i,
              **{k: f"{counts[k]}/{want[k]}" for k in want}, ok=ok)
        if not ok:
            raise AssertionError(f"{family} train step {i} (gan_on="
                                 f"{gan_on}) failed its checks")
        step_ms.append(ms)
    main_path = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gan_ms = statistics.median(step_ms[1:])
    _line("baseline-e2e", model=family, first_step_ms=f"{step_ms[0]:.1f}",
          step_ms_median=f"{gan_ms:.1f}", steps=len(step_ms) - 1,
          samples_per_s=f"{B / gan_ms * 1e3:.1f}",
          peak_memory_gib=f"{peak:.2f}")
    want = _baseline_expected(cfg, True)
    kernels = ("b1", "b1_bwd") if want["b1"] else ()
    _profile(f"baseline_gan_step:{family}",
             lambda: step(_baseline_batch(cfg, B, 400), True), gan_ms,
             kernels=kernels, want=want)
    del system
    torch.cuda.empty_cache()
    return main_path


def _zero_grad_leaf(family: str, key: str) -> bool:
    """A bias right before a train-mode batch norm: zero true gradient
    (the norm subtracts it), so either side's is rounding noise."""
    if family == "multimodal_context":
        return key in {f"gen.audio_encoder.feat_extractor.{i}.bias"
                       for i in (0, 3, 6)} | {"dis.pre_conv.0.bias",
                                              "dis.pre_conv.3.bias"}
    if family == "speech2gesture":
        return (key.endswith(".0.bias") and key != "dis.net.0.bias") or \
            key == "gen.pre_pose_encoder.0.bias"
    if family == "seq2seq":
        return key == "decoder.decoder.pre_linear.0.bias"
    enc = "encoder" if family == "gesture_autoencoder:126" \
        else "pose_encoder"
    leaves = {f"{enc}.net.{i}.0.bias" for i in range(3)} | {
        f"{enc}.out_net.0.bias", f"{enc}.out_net.3.bias"}
    if family == "joint_embedding":
        return key in leaves | {
            f"context_encoder.audio_encoder.feat_extractor.{i}.bias"
            for i in (0, 3, 6)} | {"context_encoder.out.0.bias",
                                   "decoder.pre_pose_net.0.bias"}
    return key in leaves | {"decoder.pre_net.0.bias", "decoder.net.0.bias",
                            "decoder.net.3.bias"}


# a zero-gradient leaf's noise against its layer's weight gradient
ZERO_GRAD_REL = 1e-3
# the batch-normed waveform encoders' leaves take the audio bound
AUDIO_PREFIXES = ("gen.audio_encoder.", "context_encoder.audio_encoder.")


def _baseline_card_vs_cpu(config):
    """The fp32 train step of a narrow baseline (hidden 64, 2 GRU layers
    where the config sets them, batch 8; GAN phase on) on the card against
    the same port on the CPU: the same weights, batch and CPU generator
    (so the same dropout masks, noise and coins; dropout 0 where the
    config sets it); every loss term and every gradient, the batch-normed
    audio encoders at the looser bound."""
    from ha2g_torch.train.loop import build_system

    cfg = _baseline_cfg(config, compute_dtype="float32", hidden_size=64,
                        n_layers=2, dropout_prob=0.0)
    family = _family(cfg)
    systems = []
    for device in ("cpu", "cuda"):
        s = build_system(cfg, N_WORDS, N_SPEAKERS, device=device,
                         generator=torch.Generator().manual_seed(3))
        if cfg.model == "multimodal_context":
            s.gen.text_encoder.emb_dropout = 0.0
            s.dis.gru.dropout = 0.0
        systems.append(s)
    cpu, gpu = systems
    gpu.load_state_dict(cpu.state_dict())
    batch = _baseline_batch(cfg, 8, 7)
    extra = {"rand_vids": torch.from_numpy(np.roll(batch["vids"], 1))} \
        if cfg.model == "multimodal_context" else {}
    got = [_baseline_step(s, cfg, torch.Generator().manual_seed(4))(
        batch, True, **extra) for s in systems]
    worst_metric = max(abs(float(got[1][k]) / float(got[0][k]) - 1)
                       for k in got[0])
    # worst relative error by group over the leaves whose gradient is over
    # the floor; a leaf fails when it is over its group's bound and
    # differs by more than the floor
    worst = {"audio": 0.0, "other": 0.0, "zero": 0.0}
    failed = []
    grads = {k: p.grad for k, p in cpu.named_parameters()}
    bound = {"audio": TRAIN_AUDIO_GRAD_REL, "other": TRAIN_GRAD_REL}
    for key, p in gpu.named_parameters():
        want, have = grads[key], p.grad
        if want is None or have is None:
            if (want is None) != (have is None):
                raise AssertionError(f"{key}: gradient on one side only")
            continue
        have = have.cpu()
        if _zero_grad_leaf(family, key):
            # zero on both sides where the random mode's coin left the
            # layer out of the step
            scale = grads[key[:-len("bias")] + "weight"].double().norm()
            rel = float(max(have.double().norm(), want.double().norm())
                        / scale.clamp_min(1e-30))
            worst["zero"] = max(worst["zero"], rel)
            if rel > ZERO_GRAD_REL:
                failed.append(key)
            continue
        group = "audio" if key.startswith(AUDIO_PREFIXES) else "other"
        rel = _rel(have, want)
        if want.double().norm() > TRAIN_GRAD_FLOOR:     # not noise alone
            worst[group] = max(worst[group], rel)
        if rel > bound[group] and \
                (have.double() - want.double()).norm() > TRAIN_GRAD_FLOOR:
            failed.append(key)
    ok = (got[0].keys() == got[1].keys()
          and worst_metric <= TRAIN_METRIC_RTOL and not failed)
    _line("baseline-fp32-card-vs-cpu", model=family, hidden=64,
          gru_layers=2, batch=8, metrics=len(got[0]),
          metric_rel_err=f"{worst_metric:.2e}",
          grad_rel_err_audio_encoder=f"{worst['audio']:.2e}",
          grad_rel_err_other=f"{worst['other']:.2e}",
          zero_grad_leaves_vs_weight_grad=f"{worst['zero']:.2e}",
          leaves=len(grads), failed=failed[:4],
          tol=f"{TRAIN_METRIC_RTOL:.0e}/{TRAIN_AUDIO_GRAD_REL:.0e}/"
              f"{TRAIN_GRAD_REL:.0e}/{ZERO_GRAD_REL:.0e}", ok=ok)
    if not ok:
        raise AssertionError(f"the fp32 {family} train step on the card "
                             "disagrees with the CPU")


def _baseline_serving(config, work: Path, paths):
    """A 20 s clip at B = 1 and 8 through ``generate`` (B1's launches,
    times, a profile at B = 8); a checkpoint through export-checkpoint /
    import-checkpoint (every tensor equal); a warm GestureService and its
    HTTP API: one request each, bit for bit the direct ``generate`` on the
    same padded batch; speech2gesture: an fp32 20 s stream against
    ``generate`` (1e-3); the others (the raw waveform or words): a stream
    refused."""
    import base64
    import threading
    import types
    from ha2g_torch import checkpoint as ckpt
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.serve import GestureService, make_http_server
    from ha2g_torch.synthesis import _window_layout, make_synthesizer
    from ha2g_torch.train.loop import build_system

    cfg = _baseline_cfg(config)
    model = cfg.model
    key = f"serving:{model}"
    per_window = _window_b1(cfg)
    lang = _vocab()
    speaker = Vocab("vid", insert_default_tokens=False)
    for i in range(N_SPEAKERS - speaker.n_words):
        speaker.index_word(f"s{i}")
    system = build_system(cfg, lang.n_words, speaker.n_words,
                          generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    _, _, W = _window_layout(cfg, SERVE_CLIP_SECONDS)
    frames = cfg.n_poses + (W - 1) * (cfg.n_poses - cfg.n_pre_poses)
    e2e = {}
    for B in (1, 8):
        audio, words, vids = _requests(B, SERVE_CLIP_SECONDS, 50 + B)
        b0 = _b1_launches()
        out = synth.generate(audio, words, lang, vids)
        paths[key] += _expect_b1(f"{model} generate B={B}", b0,
                                 W * per_window)
        ok = out.shape == (B, frames, cfg.pose_dim) and \
            bool(np.isfinite(out).all())
        b0 = _b1_launches()
        e2e[B] = _host_ms(lambda: synth.generate(audio, words, lang, vids),
                          reps=5, warmup=1)
        paths[key] += _expect_b1(f"{model} generate B={B} timing", b0,
                                 6 * W * per_window)
        _line("baseline-generate", model=model, B=B, windows=W,
              shape=tuple(out.shape), b1_launches=W * per_window,
              ms_median_of_5=f"{e2e[B]:.2f}", ok=ok)
        if not ok:
            raise AssertionError(f"{model} generate B={B} failed its checks")
    b0 = _b1_launches()
    _profile(f"baseline_generate_B8:{model}",
             lambda: synth.generate(audio, words, lang, vids), e2e[8],
             kernels=("b1",) if per_window else ())
    paths[key] += _expect_b1(f"{model} generate B=8 profile", b0,
                             W * per_window)

    # checkpoints: the port's, a reference .bin and back
    d = work / model
    ckpt.save_checkpoint(d / "ckpt", system, cfg, lang, speaker)
    zero = dict.fromkeys(_read_counts(), 0)
    _cli_call(["export-checkpoint", str(d / "ckpt"), str(d / "ref.bin")],
              zero)
    _cli_call(["import-checkpoint", str(d / "ref.bin"), str(d / "imported")],
              zero)
    want = ckpt.read_state(d / "ckpt")["model"]
    got = ckpt.read_state(d / "imported")["model"]
    equal = want.keys() == got.keys() and all(
        torch.equal(got[k], v) for k, v in want.items())
    _line("baseline-ckpt-bridge", model=model, tensors=len(want),
          equal=equal, bin_bytes=(d / "ref.bin").stat().st_size, ok=equal)
    if not equal:
        raise AssertionError(f"{model}: the checkpoint bridge changed a "
                             "tensor")
    del system, synth
    torch.cuda.empty_cache()

    # the service (buckets 1 / 4 / 8, warm) and its HTTP API
    b0 = _b1_launches()
    t = time.perf_counter()
    svc = GestureService(str(d / "imported"),
                         max_clip_seconds=SERVE_CLIP_SECONDS, max_batch=8)
    warm_s = time.perf_counter() - t
    paths[key] += _expect_b1(f"{model} service warm-up", b0,
                             svc.stats["batches"] * W * per_window)
    httpd = make_http_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        audio, words = _serve_clip(SERVE_CLIP_SECONDS, 60)
        n0, b0 = svc.stats["batches"], _b1_launches()
        t = time.perf_counter()
        got = svc.synthesize(audio, words, vid=2)
        service_ms = (time.perf_counter() - t) * 1e3
        code, resp = _http(f"{url}/synthesize", {
            "audio": base64.b64encode(audio.astype("<f4").tobytes())
            .decode(), "words": [list(w) for w in words], "vid": 2})
        http = np.frombuffer(base64.b64decode(resp["dir_vec"]), "<f4") \
            .reshape(resp["shape"]) if code == 200 else None
        req = types.SimpleNamespace(audio=audio, words=words, vid=2)
        a, w, v = svc.padded_batch([req])
        direct = svc.synth.generate(a, w, svc.lang, v)[0, :len(got)]
        batches = svc.stats["batches"] - n0
        paths[key] += _expect_b1(f"{model} service request", b0,
                                 (batches + 1) * W * per_window)
        code_h, health = _http(f"{url}/healthz")
        code_s, stream = _http(f"{url}/stream/open", {"vid": 0})
        streams = model == "speech2gesture"
        if streams:
            refused = False
            if code_s == 200:
                svc.stream_finish(stream["stream_id"])
        else:       # not spectrogram-windowed: every way in refuses
            try:
                svc.synth.stream(lang, 0)
                refused = False
            except ValueError:
                refused = code_s == 500
        ok = (code == 200 and http is not None
              and np.array_equal(got, direct) and np.array_equal(http, got)
              and health.get("model") == model and batches == 2
              and (code_s == 200) == streams and refused != streams
              and svc.stats["errors"] == 0)
        _line("baseline-service", model=model, warmup_s=f"{warm_s:.1f}",
              buckets=svc.buckets, service_ms=f"{service_ms:.2f}",
              shape=tuple(got.shape), http=code, healthz=code_h,
              stream_open=code_s, stream_refused=refused,
              equal_to_direct=bool(np.array_equal(got, direct)), ok=ok)
        if not ok:
            raise AssertionError(f"{model}: the service failed its checks")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
        svc.close()

    # a live stream against generate, fp32 (speech2gesture)
    if model == "speech2gesture":
        cfg32 = cfg.replace(compute_dtype="float32")
        system = build_system(cfg32, lang.n_words, speaker.n_words,
                              generator=torch.Generator().manual_seed(0))
        synth = make_synthesizer(system, system.state_dict())
        audio, words = _serve_clip(SERVE_CLIP_SECONDS, 61, click=True)
        want = synth.generate(audio[None], [words], lang,
                              np.asarray([1]))[0]
        stream = synth.stream(lang, 1, total_seconds=SERVE_CLIP_SECONDS)
        outs = [stream.feed(words=words)]
        lat = []
        for i in range(0, len(audio), SR // 10):
            t = time.perf_counter()
            outs.append(stream.feed(audio[i:i + SR // 10]))
            lat.append((time.perf_counter() - t) * 1e3)
        outs.append(stream.finish())
        got = np.concatenate(outs)
        err = float(np.abs(got - want).max())
        p50, p95 = np.percentile(lat, [50, 95])
        ok = got.shape == want.shape and err <= STREAM_ATOL
        _line("baseline-stream-vs-batch", model=model, dtype="float32",
              feeds=len(lat), feed_ms_p50=f"{p50:.2f}",
              feed_ms_p95=f"{p95:.2f}", shape=tuple(got.shape),
              max_abs_err=f"{err:.3e}", tol=f"{STREAM_ATOL:.0e}", ok=ok)
        if not ok:
            raise AssertionError("the speech2gesture stream differs from "
                                 "generate")
        del system, synth
    torch.cuda.empty_cache()
    return e2e


def _masked_encoder_check(B):
    """The seq2seq encoder at batch ``B`` on the card, lengths ragged in
    [2, 32]: outputs, finals and every gradient with B1 (forward and
    backward kernel) against the same encoder through autograd of B1's
    plain version (``B1_ATOL`` / ``B1_GRAD_REL``, fp32)."""
    from ha2g_torch.models import seq2seq
    from ha2g_torch.models.common import init_parameters_
    from ha2g_torch.ops.gru_kernel import gru_recurrence_plain
    H, L = MASKED_ENCODER
    enc = seq2seq.MaskedBiGRUEncoder(N_WORDS, 300, H, L, dropout=0.0)
    init_parameters_(enc, torch.Generator().manual_seed(5))
    enc.cuda()
    seq, lengths = _word_seqs(np.random.default_rng(6), B)
    tokens = torch.from_numpy(seq).cuda()
    lens = torch.from_numpy(lengths).cuda()
    g = torch.Generator().manual_seed(7)
    ct_out = torch.randn((B, WORD_SEQ, H), generator=g).cuda()
    ct_fin = torch.randn((2 * L, B, H), generator=g).cuda()
    runs = []
    kernel_fn = seq2seq.gru_recurrence_fn
    for fn in (kernel_fn, gru_recurrence_plain):
        seq2seq.gru_recurrence_fn = fn
        try:
            enc.zero_grad(set_to_none=True)
            out, fin = enc(tokens, lens)
            ((out * ct_out).sum() + (fin * ct_fin).sum()).backward()
        finally:
            seq2seq.gru_recurrence_fn = kernel_fn
        runs.append((out.detach(), fin.detach(),
                     [p.grad.clone() for p in enc.parameters()]))
    torch.cuda.synchronize()
    (out, fin, grads), (p_out, p_fin, p_grads) = runs
    err = max((out - p_out).abs().max().item(),
              (fin - p_fin).abs().max().item())
    rel = max(_rel(a, b) for a, b in zip(grads, p_grads))
    t = torch.arange(WORD_SEQ, device="cuda")
    zero_past = not out[t[None] >= lens[:, None]].any()
    ok = (err <= B1_ATOL[torch.float32] and rel <= B1_GRAD_REL[torch.float32]
          and zero_past)
    _line("masked-encoder-check", B=B, H=H, layers=L, T=WORD_SEQ,
          lengths=f"{int(lengths.min())}..{int(lengths.max())}",
          max_abs_err=f"{err:.3e}", grad_rel_err=f"{rel:.2e}",
          zero_past_length=zero_past,
          tol=f"{B1_ATOL[torch.float32]:.0e}/"
              f"{B1_GRAD_REL[torch.float32]:.0e}", ok=ok)
    if not ok:
        raise AssertionError("the masked seq2seq encoder on B1 disagrees "
                             "with its plain version")


def _embedder_loop(work: Path, paths):
    """The embedders' training closes the loop: ``cli train`` of each
    gesture_autoencoder config (2 epochs at batch 32 on stored synthetic
    clips, bf16), its checkpoint_best then named as ``eval_net_path`` of a
    ``Trainer.evaluate`` of another family at full width, which must give
    a finite FGD."""
    from ha2g_torch import cli, skeleton
    from ha2g_torch.data.storage import save_clips
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.train.loop import Trainer

    for ae_config, other, spec in EMBEDDER_LOOPS:
        t0 = time.perf_counter()
        data = work / spec
        for split, (n, seed) in (("train", (12, 0)), ("val", (16, 1))):
            save_clips(data / split, synthetic_clips(
                getattr(skeleton, spec), n_clips=n, n_speakers=8, seed=seed))
        ae_cfg = _baseline_cfg(ae_config)
        out = work / f"ae{ae_cfg.pose_dim}"
        _cli_call(["train", "--config", str(ROOT / ae_config), "--epochs",
                   "2", "--batch_size", "32", "--subdivision_stride", "10",
                   "--compute_dtype", "bfloat16", "--random_seed", "0",
                   "--train_data_path", str(data / "train"),
                   "--test_data_path", str(data / "val"),
                   "--model_save_path", str(out), "--eval_net_path", ""],
                  dict.fromkeys(_read_counts(), 0))
        cfg = _baseline_cfg(other, eval_net_path=str(out / "checkpoint_best"),
                            train_data_path=str(data / "train"),
                            test_data_path=str(data / "val"))
        cfg, lang, speaker, train_s, val_s = cli._prepare(cfg)
        trainer = Trainer(cfg, train_s, val_s, lang, speaker,
                          cli.make_evaluator(cfg, torch.device("cuda")))
        n_val = len(trainer.val_loader)
        b0 = _b1_launches()
        val = trainer.evaluate(0)
        paths[f"evaluate:{cfg.model}"] = _expect_b1(
            f"{cfg.model} evaluate", b0, n_val * _window_b1(cfg))
        # B1 at the evaluate's batches against its plain version: the
        # seq2seq encoder (fp32, width 32, H = 200) or the joint
        # embedding's decoder (n_poses steps, H = 300)
        batches = sorted({len(i) for i in trainer.val_loader._indices()})
        with _uncounted():
            if cfg.model == "seq2seq":
                for b in batches:
                    _masked_encoder_check(b)
            else:
                _b1_check([(cfg.n_poses, b, 300) for b in batches])
        ok = all(np.isfinite(val.get(k, np.nan))
                 for k in ("loss", "frechet", "feat_dist", "diversity"))
        _line("embedder-loop", embedder=_family(ae_cfg), evaluated=cfg.model,
              val_batches=n_val, **{k: f"{v:.5f}" for k, v in val.items()},
              seconds=f"{time.perf_counter() - t0:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"the port-trained {_family(ae_cfg)} "
                                 "embedder gave no finite FGD")
        del trainer
        torch.cuda.empty_cache()


def _baselines(work: Path, runs, phase: str, evaluate=None):
    """Phase 9 (the GAN baselines) or 10 (the text and embedding
    baselines, with ``evaluate`` the embedders' loop): train steps of each
    run, each against the CPU in fp32, the serving of each family that
    synthesizes; -> the kernels' launch counts by path."""
    t0 = time.perf_counter()
    counts = {}
    for config, steps in runs:
        family = _family(_baseline_cfg(config))
        counts[f"training:{family}"] = _baseline_train(config, steps)
    for config, _ in runs:
        _baseline_card_vs_cpu(config)
    served = [c for c, _ in runs
              if _baseline_cfg(c).model != "gesture_autoencoder"]
    paths = {f"serving:{_baseline_cfg(c).model}": 0 for c in served}
    _reset_counts()
    for config in served:
        _baseline_serving(config, work, paths)
    if evaluate is not None:
        evaluate(work, paths)
    serving = _read_counts()
    if any(serving[k] for k in ("b1_bwd", "b2", "b3", "b4")):
        raise AssertionError("training kernels launched while serving")
    if serving["b1"] != sum(paths.values()):
        raise AssertionError("B1 launches outside the counted serving calls")
    for path, n in paths.items():
        counts[path] = {**dict.fromkeys(serving, 0), "b1": n}
    if any(c[k] for c in counts.values() for k in ("b2", "b3", "b4")):
        raise AssertionError(f"B2-B4 launched in the {phase} phase")
    _line(f"{phase}-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: v["b1"] for k, v in counts.items()})
    return counts


# ---------------------------------------------------------------------------
# phase 11: multi-device training and sharded synthesis
# ---------------------------------------------------------------------------

MULTI_CONFIG = "configs_expressive/hierarchy.yaml"
# the fp32 step held across meshes: the Expressive config at a narrow width
MULTI_NARROW = dict(hidden_size=32, n_layers=2, batch_size=8,
                    compute_dtype="float32")
# a step on a mesh against the single-process step on the same global batch
# (tests/test_parallel.py::_assert_step_equiv): loss terms, batch-norm
# statistics, and each parameter's SGD delta by norm (relative, unless the
# difference is under the floor) and direction
STEP_METRIC_RTOL, STEP_METRIC_ATOL = 5e-4, 1e-4
STEP_STATS_RTOL, STEP_STATS_ATOL = 1e-4, 1e-5
STEP_DELTA_REL, STEP_DELTA_COS, STEP_DELTA_FLOOR = 0.02, 0.999, 3e-5
# the full-width bf16 step of the ranks (DP, FSDP) against one process's on
# the same global batch and generator, its first step from the seeded
# state: the worst relative error over the loss terms (each against
# max(|term|, the floor)) and over the batch-norm running statistics (by
# norm, each buffer), and the median relative error of the G gradients'
# leaves.  The H100 gave 1.7e-4 / 1.9e-2 / 1.0e-2 to 1.4e-2 for DP and
# FSDP, and 4.0e-4 / 1.3e-1 / 1.4e-2 for the control, the DP step with
# each rank's own batch-norm statistics, which must fall outside the
# bounds (on the statistics: 2.5x each side of the bound).  bf16 leaves
# the worst gradient leaves no better than noise either way, and a
# gradient average that is missing or doubled moves the median to ~1
WIDE_METRIC_REL, WIDE_METRIC_FLOOR = 1e-3, 1e-2
WIDE_STATS_REL = 5e-2
WIDE_GRAD_MEDIAN = 5e-2
# run_fused over two devices against one call (tests/test_streaming.py:257)
FUSED_DEVICES_ATOL = 2e-4
FUSED_DEVICES_B = 8


def _sgd(system):
    """SGD in place of both Adams: a step's parameter delta is -lr times
    its gradient, so the new parameters compare every gradient."""
    g = [p for m in (system.audio, system.text, system.gens)
         for p in m.parameters()]
    system.g_opt = torch.optim.SGD(g, lr=0.05)
    system.d_opt = torch.optim.SGD(system.dis.parameters(), lr=0.01)
    return system


def _local(batch, rank, world):
    return {k: np.array_split(np.asarray(v), world)[rank]
            for k, v in batch.items()}


def _hierarchy(cfg, sgd=False, device="cuda"):
    from ha2g_torch.train.hierarchy import HierarchySystem
    system = HierarchySystem(cfg, N_WORDS, N_SPEAKERS, device=device,
                             generator=torch.Generator().manual_seed(0))
    return _sgd(system) if sgd else system


def _multi_nccl(device, overrides):
    """(a) One rank on an NCCL group: the data-parallel path (its
    all-reduces, gathers, the gradient bucket) against the plain step on
    the same batch, bit for bit (deterministic algorithms on)."""
    from ha2g_torch.config import Config
    from ha2g_torch.parallel.mesh import Mesh

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    cfg = Config.from_yaml(ROOT / MULTI_CONFIG, **overrides)
    batch = _train_batch(cfg, cfg.batch_size, 400)

    def run(mesh):
        system = _hierarchy(cfg, device=device)
        if mesh is not None:
            mesh.place(system)
        _reset_counts()
        metrics = system.train_step(batch, True,
                                    torch.Generator(device).manual_seed(1))
        _sync(device)
        return system, metrics, _read_counts()

    plain, m_plain, _ = run(None)
    dp, m_dp, counts = run(Mesh(1, 1, device))
    diffs = [k for k in m_plain if not torch.equal(m_plain[k], m_dp[k])]
    grads = dict(dp.named_parameters())
    n_grads = 0
    for k, p in plain.named_parameters():
        q = grads[k]
        if (p.grad is None) != (q.grad is None) or (
                p.grad is not None and not torch.equal(p.grad, q.grad)):
            diffs.append(f"grad:{k}")
        n_grads += p.grad is not None
    have = dp.state_dict()
    diffs += [k for k, v in plain.state_dict().items()
              if not torch.equal(v, have[k])]
    return {"diffs": diffs, "counts": counts, "n_grads": n_grads,
            "metrics": {k: float(v) for k, v in m_dp.items()}}


def _bn_stats(system) -> dict:
    return {k: v.detach().float().cpu().clone()
            for k, v in system.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _g_grads(system) -> dict:
    """The G phase's gradients (averaged over the ranks under a mesh),
    fp32 on the CPU; under FSDP a sharded leaf's is this rank's shard."""
    names = {p: k for k, p in system.named_parameters()}
    return {names[p]: p.grad.detach().float().cpu().clone()
            for group in system.g_opt.param_groups for p in group["params"]
            if p.grad is not None}


def _wide_step(cfg, device, rank=0, world=1, mesh=None, timed=None):
    """The full-width GAN step the ranks and the parent hold against each
    other: one step from the seeded state on a global batch split over
    ``world`` ranks -> its metrics (averaged over the ranks), batch-norm
    running statistics and, on rank 0, its G gradients.  With ``timed``
    (called just before it), a second step from the same generator, timed
    (the first did every kernel's set-up, the D phase's too), with its
    launch counts and this rank's resident bytes."""
    B = cfg.batch_size
    system = _hierarchy(cfg, device=device)
    if mesh is not None:
        mesh.place(system)
    gen = torch.Generator(device).manual_seed(1)
    metrics = system.train_step(
        _local(_train_batch(cfg, B, 100), rank, world), True, gen)
    rec = {"metrics": {k: float(v if mesh is None else
                                mesh.mean_over_ranks(v.reshape(1))[0])
                       for k, v in metrics.items()},
           "stats": _bn_stats(system),
           "grads": _g_grads(system) if rank == 0 else None}
    if timed is None:
        return rec
    timed()
    _reset_counts()
    _sync(device)
    t = time.perf_counter()
    second = system.train_step(
        _local(_train_batch(cfg, B, 101), rank, world), True, gen)
    _sync(device)
    rec.update(ms=(time.perf_counter() - t) * 1e3, counts=_read_counts(),
               finite=all(bool(torch.isfinite(v)) for v in
                          (*metrics.values(), *second.values())),
               resident_bytes=mesh.resident_bytes(system))
    return rec


def _multi_gloo(rank, world, device, overrides):
    """(b) and (c) on ranks sharing one card over gloo: the full-width
    bf16 step at each rank's rows, DP then FSDP, with launch counts, each
    rank's resident bytes and what the parent holds against one process;
    the control, DP with each rank's own batch-norm statistics; then the
    narrow fp32 step on both meshes for the parent to hold against one
    process."""
    from ha2g_torch.config import Config
    from ha2g_torch.models import common
    from ha2g_torch.parallel.mesh import Mesh
    from ha2g_torch.train import losses

    cfg = Config.from_yaml(ROOT / MULTI_CONFIG, **overrides)
    seen_n = []
    flash = losses.flash_contrastive

    def spy(a, b):
        seen_n.append(a.shape[0])
        return flash(a, b)

    losses.flash_contrastive = spy
    out = {}
    for layout, shape in (("dp", (world, 1)), ("fsdp", (1, world))):
        mesh = Mesh(*shape, device)
        out[layout] = _wide_step(cfg, device, rank, world, mesh,
                                 timed=seen_n.clear)
        out[layout]["contrastive_N"] = list(seen_n)
    losses.flash_contrastive = flash
    # the control: batch norm sees no mesh (each rank's own statistics);
    # everything else as in the DP step
    held = common.current_mesh
    common.current_mesh = lambda: None
    try:
        out["per_rank_bn"] = _wide_step(cfg, device, rank, world,
                                        Mesh(world, 1, device))
    finally:
        common.current_mesh = held

    narrow = Config.from_yaml(ROOT / MULTI_CONFIG, **overrides).replace(
        **MULTI_NARROW)
    batch = _local(_train_batch(narrow, narrow.batch_size, 500), rank, world)
    for layout, shape in (("dp", (world, 1)), ("fsdp", (1, world))):
        mesh = Mesh(*shape, device)
        system = _hierarchy(narrow, sgd=True, device=device)
        mesh.place(system)
        metrics = system.train_step(batch, True,
                                    torch.Generator(device).manual_seed(2))
        metrics = {k: float(mesh.mean_over_ranks(v.reshape(1))[0])
                   for k, v in metrics.items()}
        with mesh.full_state(system, state=False):
            state = {k: v.detach().cpu().clone()
                     for k, v in system.state_dict().items()}
        out[f"narrow_{layout}"] = {"metrics": metrics, "state": state}
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _multi_rank(rank, world, port, part, work, device, overrides):
    """One rank of phase 11 (``torch.multiprocessing`` spawns it): joins
    the group at ``port`` on ``device`` (NCCL for part "a" on the card,
    gloo otherwise) and writes its results to ``work``; ``overrides`` of
    the full-width config (a rehearsal's narrow widths)."""
    import os
    # cuBLAS's deterministic workspace, before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = "nccl" if part == "a" and cuda else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = _multi_nccl(device, overrides) if part == "a" else \
            _multi_gloo(rank, world, device, overrides)
        torch.save(out, Path(work) / f"multi_{part}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_equiv(name, old, m1, s1, m2, s2):
    """Hold a step on a mesh (m2, s2) to the single-process one (m1, s1)
    from the same state ``old``; -> the worst relative delta error."""
    if set(m1) != set(m2):
        raise AssertionError(f"{name}: metrics {sorted(m1)} / {sorted(m2)}")
    bad = [k for k in m1 if abs(m1[k] - m2[k]) >
           STEP_METRIC_ATOL + STEP_METRIC_RTOL * abs(m1[k])]
    worst_rel, worst_stat = 0.0, 0.0
    for k, v in s1.items():
        if k.endswith(("running_mean", "running_var")):
            err = (v - s2[k]).abs()
            if not bool((err <= STEP_STATS_ATOL
                         + STEP_STATS_RTOL * v.abs()).all()):
                bad.append(k)
            worst_stat = max(worst_stat, float(err.max()))
        elif not k.endswith("num_batches_tracked"):
            da = (v.double() - old[k].double()).ravel()
            db = (s2[k].double() - old[k].double()).ravel()
            diff = float((da - db).norm())
            if diff <= STEP_DELTA_FLOOR:
                continue
            nb = float(db.norm())
            cos = float(da @ db) / (float(da.norm()) * nb + 1e-30)
            worst_rel = max(worst_rel, diff / nb)
            if diff / nb > STEP_DELTA_REL or cos < STEP_DELTA_COS:
                bad.append(k)
    ok = not bad
    metric_rel = max(abs(m1[k] - m2[k]) / max(abs(m1[k]), 1e-12) for k in m1)
    _line("multi-step-equiv", pair=name, metrics=len(m1),
          worst_metric_rel=f"{metric_rel:.3e}",
          worst_stat_abs=f"{worst_stat:.3e}",
          worst_delta_rel=f"{worst_rel:.3e}", ok=ok)
    if not ok:
        raise AssertionError(f"{name}: {bad[:8]} outside the bounds")


def _wide_equiv(name, want, have) -> tuple[float, float, float]:
    """The full-width bf16 step ``have`` (ranks) against ``want`` (one
    process): -> the worst relative errors of the loss terms and of the
    batch-norm running statistics, the G gradients' median one."""
    if set(want["metrics"]) != set(have["metrics"]):
        raise AssertionError(f"{name}: metrics {sorted(want['metrics'])} / "
                             f"{sorted(have['metrics'])}")
    metric = max(abs(have["metrics"][k] - v) / max(abs(v), WIDE_METRIC_FLOOR)
                 for k, v in want["metrics"].items())
    stat = max(float((have["stats"][k] - v).norm() / v.norm())
               for k, v in want["stats"].items())
    rels, coss = [], []
    for k, g in want["grads"].items():
        e = have["grads"][k]
        if e.shape != g.shape:
            # an FSDP leaf: rank 0's shard, along the dimension it split
            d = next(i for i, (m, n) in enumerate(zip(e.shape, g.shape))
                     if m != n)
            g = g.chunk(g.shape[d] // e.shape[d], d)[0]
        ng = float(g.norm())
        if ng == 0.0:
            continue
        rels.append(float((e - g).norm()) / ng)
        coss.append(float(e.double().ravel() @ g.double().ravel())
                    / (float(e.norm()) * ng + 1e-30))
    _line("multi-wide-equiv", pair=name, metrics=len(want["metrics"]),
          worst_metric_rel=f"{metric:.3e}", worst_stat_rel=f"{stat:.3e}",
          stats=len(want["stats"]), g_grads=len(rels),
          grad_rel_median=f"{statistics.median(rels):.3e}",
          grad_rel_worst=f"{max(rels):.3e}",
          grad_cos_worst=f"{min(coss):.6f}")
    return metric, stat, statistics.median(rels)


def _fused_over_devices(device):
    """(d) run_fused over [cuda:0, cuda:0] (two threads, one replica)
    against one call, fp32, B = 8, 20 s clips; -> B1's launches."""
    from ha2g_torch.ops.gru_kernel import gru_recurrence
    from ha2g_torch.synthesis import _window_layout, make_synthesizer

    cfg = _config("float32")
    system = _hierarchy(cfg, device=device)
    synth = make_synthesizer(system, system.state_dict())
    lang = _vocab()
    audio, words, vids = _requests(FUSED_DEVICES_B, CLIP_SECONDS, 21)
    _, _, W = _window_layout(cfg, CLIP_SECONDS)
    per_call = W * cfg.skeleton.n_levels * cfg.n_layers
    outs, ms, launches = {}, {}, 0
    # each twice in turns; the second round's times (the first builds the
    # replicas' shapes)
    for name, devices in (("one", None), ("two", [device, device])) * 2:
        plan = synth.prepare_fused(words, lang, vids, audio.shape[1],
                                   torch.Generator(device).manual_seed(5))
        _reset_counts()
        _sync(device)
        t = time.perf_counter()
        outs[name] = synth.run_fused(audio, plan, devices=devices)
        ms[name] = (time.perf_counter() - t) * 1e3
        n = gru_recurrence.launches
        want = per_call * (1 if devices is None else len(devices))
        if n != want:
            raise AssertionError(f"run_fused({name}) launched B1 {n} times,"
                                 f" the dataflow {want}")
        launches += n
    err = float(np.abs(outs["two"] - outs["one"]).max())
    ok = outs["two"].shape == outs["one"].shape and \
        bool(np.isfinite(outs["two"]).all()) and err <= FUSED_DEVICES_ATOL
    _line("multi-fused-devices", B=FUSED_DEVICES_B, windows=W,
          shape=tuple(outs["two"].shape), max_abs_err=f"{err:.3e}",
          tol=f"{FUSED_DEVICES_ATOL:.0e}", ms_one=f"{ms['one']:.1f}",
          ms_two_threads=f"{ms['two']:.1f}", b1_launches=launches, ok=ok)
    if not ok:
        raise AssertionError("run_fused over two devices disagrees with "
                             "one call")
    return launches


def _multi_device(work: Path, device="cuda:0", overrides=None):
    """Phase 11: (a) one rank on a real NCCL group, the DP path bit for
    bit against the plain step; (b) two ranks on the one card over gloo
    (NCCL refuses two ranks on one device): the Expressive step at 48 rows
    a rank with its launch counts, B2-B4 on the gathered N; (c) the same
    under FSDP on a 1 x 2 mesh, each rank's resident bytes against DP's;
    both, and the control (DP with each rank's own batch-norm statistics),
    against the full-width step in one process on the whole batch; the
    narrow fp32 step of both meshes against one process on the card;
    (d) run_fused over two devices.  (a) and (b)-(c) run at once, each in
    processes of its own.  ``device`` and ``overrides`` of the full-width
    config serve a rehearsal on the CPU.  -> the kernels' launches by
    path."""
    import torch.multiprocessing as mp
    from ha2g_torch.config import Config

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    overrides = overrides or {}
    nccl = ctx.Process(target=_multi_rank, args=(
        0, 1, _free_port(), "a", str(work), device, overrides))
    nccl.start()
    gloo = mp.start_processes(
        _multi_rank, args=(2, _free_port(), "bc", str(work), device,
                           overrides),
        nprocs=2, join=False, start_method="spawn")
    # while the ranks run: the single-process narrow step on the card, and
    # the sharded synthesis
    cfg = Config.from_yaml(ROOT / MULTI_CONFIG, **overrides).replace(
        **MULTI_NARROW)
    single = _hierarchy(cfg, sgd=True, device=device)
    old = {k: v.detach().cpu().clone() for k, v in single.state_dict().items()}
    m1 = single.train_step(_train_batch(cfg, cfg.batch_size, 500), True,
                           torch.Generator(device).manual_seed(2))
    m1 = {k: float(v) for k, v in m1.items()}
    s1 = {k: v.detach().cpu().clone() for k, v in single.state_dict().items()}
    del single
    fused_launches = _fused_over_devices(device)
    # the full-width bf16 step in one process on the global batch the
    # ranks split
    wide = _wide_step(Config.from_yaml(ROOT / MULTI_CONFIG, **overrides),
                      device)
    while not gloo.join(timeout=5):
        pass
    nccl.join()
    if nccl.exitcode != 0:
        raise AssertionError(f"the NCCL rank exited {nccl.exitcode}")

    a = torch.load(work / "multi_a_rank0.pt", weights_only=False)
    cfg_full = Config.from_yaml(ROOT / MULTI_CONFIG, **overrides)
    ok = not a["diffs"] and a["counts"] == _expected_counts(cfg_full, True)
    _line("multi-nccl-1-rank", config=MULTI_CONFIG, bit_equal=not a["diffs"],
          grads=a["n_grads"], first_diffs=a["diffs"][:4],
          **{k: f"{a['counts'][k]}" for k in a["counts"]}, ok=ok)
    if not ok:
        raise AssertionError("the 1-rank NCCL step is not the plain step's")

    want = _expected_counts(cfg_full, True)
    N = cfg_full.batch_size * cfg_full.n_poses
    ranks = [torch.load(work / f"multi_bc_rank{r}.pt", weights_only=False)
             for r in range(2)]
    counts = {}
    for r, res in enumerate(ranks):
        for layout in ("dp", "fsdp"):
            x = res[layout]
            ok = x["finite"] and x["counts"] == want and \
                x["contrastive_N"] == [N, N]
            _line("multi-gloo-step", rank=r, layout=layout,
                  rows=cfg_full.batch_size // 2,
                  ms=f"{x['ms']:.1f}", contrastive_N=x["contrastive_N"],
                  resident_gib=f"{x['resident_bytes'] / 2 ** 30:.3f}",
                  **{k: f"{x['counts'][k]}/{want[k]}" for k in want},
                  **{k: f"{v:.4f}" for k, v in x["metrics"].items()}, ok=ok)
            if not ok:
                raise AssertionError(f"rank {r} {layout} step failed its "
                                     "checks")
            counts[f"multi-device:{layout}:rank{r}"] = x["counts"]
        share = res["fsdp"]["resident_bytes"] / res["dp"]["resident_bytes"]
        _line("multi-fsdp-resident", rank=r,
              dp_gib=f"{res['dp']['resident_bytes'] / 2 ** 30:.3f}",
              fsdp_gib=f"{res['fsdp']['resident_bytes'] / 2 ** 30:.3f}",
              share=f"{share:.3f}", ok=share <= 0.55)
        if share > 0.55:
            raise AssertionError("an FSDP rank holds more than half")
    r0 = ranks[0]
    errs = {k: _wide_equiv(f"{k}_vs_single", wide, r0[k])
            for k in ("dp", "fsdp", "per_rank_bn")}
    sound = all(m <= WIDE_METRIC_REL and st <= WIDE_STATS_REL
                and g <= WIDE_GRAD_MEDIAN
                for k, (m, st, g) in errs.items() if k != "per_rank_bn")
    m, st, g = errs["per_rank_bn"]
    caught = m > WIDE_METRIC_REL or st > WIDE_STATS_REL or \
        g > WIDE_GRAD_MEDIAN
    _line("multi-wide-bounds", metric_rel=f"{WIDE_METRIC_REL:.1e}",
          stats_rel=f"{WIDE_STATS_REL:.1e}",
          grad_median_rel=f"{WIDE_GRAD_MEDIAN:.1e}", sound_within=sound,
          control_outside=caught, ok=sound and caught)
    if not (sound and caught):
        raise AssertionError("the full-width steps on two ranks against one "
                             "process: the sound runs outside the bounds, "
                             "or the control within them")
    _step_equiv("dp_vs_single", old, m1, s1, r0["narrow_dp"]["metrics"],
                r0["narrow_dp"]["state"])
    _step_equiv("fsdp_vs_single", old, m1, s1, r0["narrow_fsdp"]["metrics"],
                r0["narrow_fsdp"]["state"])
    _step_equiv("fsdp_vs_dp", old, r0["narrow_dp"]["metrics"],
                r0["narrow_dp"]["state"], r0["narrow_fsdp"]["metrics"],
                r0["narrow_fsdp"]["state"])
    counts["multi-device:nccl-1-rank"] = a["counts"]
    counts["multi-device:run_fused"] = {
        **dict.fromkeys(want, 0), "b1": fused_launches}
    _line("multi-device-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: v["b1"] for k, v in counts.items()})
    return counts


# ---------------------------------------------------------------------------
# phase 12: the host data path
# ---------------------------------------------------------------------------

DATA_CONFIG = "configs_expressive/hierarchy.yaml"
# the source lmdb: videos x clips of 20 s TED Expressive clips at the
# released records' size (audio_raw at 16 kHz float32, a float16 log-mel
# audio_feat): ~40 MB, ~310 overflow pages a clip
DATA_VIDEOS, DATA_CLIPS_PER_VIDEO, DATA_CLIP_SECONDS = 6, 4, 20.0
DATA_WORDS_PER_SECOND = 2.5
# the cache lmdb's windows: n_poses * 1.25 frames at the config's stride
DATA_N_EXT, DATA_STRIDE = 42, 10
# the fastText model: the crawl model's dim, n-grams 3-6, a small bucket
FASTTEXT = dict(dim=300, bucket=2000, minn=3, maxn=6)
# the H36M npz: subject -> action -> frames of 32 joints
H36M_FRAMES = {"S1": 1500, "S5": 1200, "S11": 1500}
# the hierarchy's ConvDiscriminator: a bi-GRU of 64 over n_poses - 6 steps
DISCRIMINATOR_HIDDEN = 64


def _data_videos():
    """The source lmdb's video records (make_ted_dataset.py's layout):
    synthetic TED Expressive clips with a word every 0.4 s, their log-mel
    as float16 ``audio_feat``."""
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.ops.mel import log_mel_np
    from ha2g_torch.skeleton import TED_EXPRESSIVE
    clips = synthetic_clips(TED_EXPRESSIVE,
                            n_clips=DATA_VIDEOS * DATA_CLIPS_PER_VIDEO,
                            clip_seconds=DATA_CLIP_SECONDS, n_speakers=6,
                            seed=12)
    rng = np.random.default_rng(12)
    vocab = [f"word{i}" for i in range(400)]
    videos = []
    for v in range(DATA_VIDEOS):
        records = []
        first = v * DATA_CLIPS_PER_VIDEO
        for c in clips[first:first + DATA_CLIPS_PER_VIDEO]:
            n = int(DATA_CLIP_SECONDS * DATA_WORDS_PER_SECOND)
            starts = np.sort(rng.uniform(0, DATA_CLIP_SECONDS - 0.3, n))
            records.append({
                "words": [[str(rng.choice(vocab)), float(t), float(t + 0.25)]
                          for t in starts],
                "skeletons_3d": c["skeletons_3d"].astype(np.float32),
                "audio_feat": log_mel_np(c["audio_raw"]).astype(np.float16),
                "audio_raw": c["audio_raw"].astype(np.float32),
                "start_frame_no": int(c["start_frame_no"]),
                "end_frame_no": int(c["end_frame_no"]),
                "start_time": float(c["start_time"]),
                "end_time": float(c["end_time"])})
        videos.append({"vid": f"video_{v}", "clips": records})
    return videos


def _cache_records(videos, mean_dir_vec):
    """The same clips as the reference's cache stores them
    (data_preprocessor.py:150-165): a record a window of n_poses * 1.25
    resampled frames at the stride with two words or more: [words, poses,
    direction vectors minus the mean, audio, log-mel, aux_info]."""
    from ha2g_torch.data.dataset import (_pose_to_dir_vec_np,
                                         resample_pose_seq,
                                         spectrogram_length_for)
    from ha2g_torch.skeleton import TED_EXPRESSIVE
    fps = 15
    audio_len = int(round(DATA_N_EXT / fps * SR))
    spec_len = spectrogram_length_for(DATA_N_EXT, fps)
    records = []
    for video in videos:
        for clip in video["clips"]:
            skel = resample_pose_seq(clip["skeletons_3d"],
                                     clip["end_time"] - clip["start_time"],
                                     fps)
            spec, audio = clip["audio_feat"], clip["audio_raw"]
            for s in range(0, len(skel) - DATA_N_EXT + 1, DATA_STRIDE):
                t0 = clip["start_time"] + s / fps
                t1 = t0 + DATA_N_EXT / fps
                words = [w for w in clip["words"] if t0 <= w[1] <= t1]
                a0 = int(s / len(skel) * spec.shape[1])
                r0 = int(s / len(skel) * len(audio))
                if (len(words) < 2 or a0 + spec_len > spec.shape[1]
                        or r0 + audio_len > len(audio)):
                    continue
                poses = skel[s:s + DATA_N_EXT]
                vec = _pose_to_dir_vec_np(poses, TED_EXPRESSIVE).reshape(
                    DATA_N_EXT, -1) - mean_dir_vec.reshape(1, -1)
                records.append([
                    words, poses, vec.astype(np.float32),
                    audio[r0:r0 + audio_len],
                    spec[:, a0:a0 + spec_len].astype(np.float32),
                    {"vid": video["vid"], "start_frame_no": s,
                     "end_frame_no": s + DATA_N_EXT, "start_time": t0,
                     "end_time": t1}])
    return records


def _same(got, want) -> bool:
    """Equal objects, ndarrays bit for bit with equal dtypes."""
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and got.shape == want.shape
                and got.tobytes() == want.tobytes())
    if isinstance(want, dict):
        return (type(got) is dict and list(got) == list(want)
                and all(_same(got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return (type(got) is type(want) and len(got) == len(want)
                and all(_same(a, b) for a, b in zip(got, want)))
    return type(got) is type(want) and got == want


def _read_back(path, values, card):
    """Every record of an lmdb read with the port's reader and decoded with
    its codec, against what was written; -> MB."""
    from ha2g_torch.data.arrow_legacy import deserialize
    from ha2g_torch.data.lmdb_mini import MiniLmdbReader
    reader = MiniLmdbReader(path)
    t = time.perf_counter()
    raw = [bytes(v) for _, v in reader.items()]
    read_s = time.perf_counter() - t
    reader.close()
    t = time.perf_counter()
    decoded = [deserialize(r) for r in raw]
    decode_s = time.perf_counter() - t
    mb = sum(len(r) for r in raw) / 1e6
    file_mb = (Path(path) / "data.mdb").stat().st_size / 1e6
    ok = len(decoded) == len(values) and all(
        _same(d, v) for d, v in zip(decoded, values))
    _line("data-lmdb", store=Path(path).name, MB=f"{mb:.1f}",
          records=len(raw), file_MB=f"{file_mb:.1f}",
          read_MB_per_s=f"{mb / read_s:.0f}",
          decode_MB_per_s=f"{mb / decode_s:.0f}", bit_equal=ok, card=card)
    if not ok:
        raise AssertionError(f"{path} does not read back what was written")
    return mb


def _timed_train_steps():
    """Wrap HierarchySystem.train_step with a synchronised host clock;
    -> (the step times list, a function that unwraps it)."""
    from ha2g_torch.train.hierarchy import HierarchySystem
    step = HierarchySystem.train_step
    times = []

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(self, *args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    HierarchySystem.train_step = timed
    return times, lambda: setattr(HierarchySystem, "train_step", step)


def _data_train(name, argv, n_train, n_val, gan_on, card, cfg):
    """``cli train`` of one epoch: the launches of every kernel against the
    dataflow, finite validation rows; step ms, samples/s, peak GiB.
    -> the launch counts."""
    zero = dict.fromkeys(_expected_counts(cfg, True), 0)
    per_eval = {**zero, "b1": n_val * cfg.skeleton.n_levels * cfg.n_layers}
    epoch = {k: n_train * v for k, v in _expected_counts(cfg, gan_on).items()}
    times, unwrap = _timed_train_steps()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        _cli_call(argv, _add(per_eval, per_eval, epoch))
    finally:
        unwrap()
    counts = _read_counts()
    out = Path(argv[argv.index("--model_save_path") + 1])
    rows = [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]
    finite = [r["epoch"] for r in rows] == [0, 1] and all(
        np.isfinite(r[k]) for r in rows for k in ("loss", "joint_mae"))
    steady = times[1:] or times
    ms = statistics.median(steady)
    _line("data-train", data=name, gan_on=gan_on, steps=len(times),
          first_step_ms=f"{times[0]:.1f}", step_ms_median=f"{ms:.1f}",
          samples_per_s=f"{cfg.batch_size / ms * 1e3:.1f}",
          peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}",
          val_rows_finite=finite, card=card)
    if not finite or len(times) != n_train:
        raise AssertionError(f"cli train on {name} failed its checks")
    return counts, out


def _hierarchy_checks(cfg, B):
    """B1, its backward and B2-B4 against their plain versions at the
    shapes a hierarchy GAN step of ``cfg`` at batch B gives them: the
    generator's GRU (n_poses, B, hidden), the discriminator's (n_poses - 6,
    B, 64) and the contrastive rows N = B * n_poses."""
    T, N = cfg.n_poses, B * cfg.n_poses
    shapes = ((T, B, cfg.hidden_size), (T - 6, B, DISCRIMINATOR_HIDDEN))
    with _uncounted():
        _b1_check(shapes)
        _b1_bwd_check(shapes)
        _b234_check(random_shapes=((N, 32),), aligned=(N,),
                    duplicates=False)


def _data_path(work: Path, card: str):
    """Phase 12: the reference's lmdb stores written and read back by the
    port's lmdb writer / reader and pyarrow-0.14 codec, ``cli import-lmdb``
    in both formats, ``cli import-embeddings`` from a fastText .bin and a
    .vec, ``cli train`` of the full-width bf16 Expressive hierarchy on the
    imported clips (warm-up steps, fastText vectors) and on the imported
    cache samples (GAN steps) with the kernels' launches and B1-B4 against
    their plain versions at the path's shapes, ``compare-trajectory``, the
    H36M gesture autoencoder and ``doctor``.  -> launch counts by path."""
    from ha2g_torch import cli
    from ha2g_torch.config import Config, parse_cli
    from ha2g_torch.data.arrow_legacy import serialize
    from ha2g_torch.data.fasttext_bin import load_model, write_model
    from ha2g_torch.data.lmdb_import import (load_imported_samples,
                                             write_reference_lmdb)
    from ha2g_torch.data.lmdb_mini import write_lmdb
    from ha2g_torch.eval.trajectory import load_history_jsonl

    t0 = time.perf_counter()
    cfg = Config.from_yaml(ROOT / DATA_CONFIG)
    zero = dict.fromkeys(_expected_counts(cfg, True), 0)
    videos = _data_videos()
    cache = _cache_records(videos, cfg.mean_dir_vec_array)
    t = time.perf_counter()
    write_reference_lmdb(work / "lmdb_train", videos)
    write_lmdb(work / "lmdb_train_cache", {
        f"{i:010}".encode("ascii"): serialize(r)
        for i, r in enumerate(cache)})
    _line("data-write", videos=len(videos), windows=len(cache),
          seconds=f"{time.perf_counter() - t:.2f}", card=card)
    src_mb = _read_back(work / "lmdb_train", videos, card)
    cache_mb = _read_back(work / "lmdb_train_cache", cache, card)

    # imports (host only: no launch)
    _reset_counts()
    for fmt, src, dst, mb in (
            ("source", "lmdb_train", "clips", src_mb),
            ("cache", "lmdb_train_cache", "samples", cache_mb)):
        t = time.perf_counter()
        _cli_call(["import-lmdb", str(work / src), str(work / dst),
                   "--format", fmt], zero)
        s = time.perf_counter() - t
        _line("data-import", format=fmt, seconds=f"{s:.2f}",
              MB_per_s=f"{mb / s:.1f}", card=card)
    words = sorted({w[0] for v in videos for c in v["clips"]
                    for w in c["words"]})
    rng = np.random.default_rng(13)
    model_words = ["</s>"] + words[::2] + [f"extra{i}" for i in range(500)]
    matrix = (rng.normal(size=(len(model_words) + FASTTEXT["bucket"],
                               FASTTEXT["dim"])) * 0.1).astype(np.float32)
    write_model(work / "crawl.bin", model_words, matrix,
                bucket=FASTTEXT["bucket"], minn=FASTTEXT["minn"],
                maxn=FASTTEXT["maxn"])
    model = load_model(work / "crawl.bin")
    (work / "crawl.vec").write_text(
        f"{len(model_words)} {FASTTEXT['dim']}\n" + "".join(
            w + " " + " ".join(f"{x:.6f}" for x in model.get_word_vector(w))
            + "\n" for w in model_words), encoding="utf-8")
    data = ["--train_data_path", str(work / "clips"),
            "--test_data_path", str(work / "clips")]
    tables = []
    for name in ("crawl.bin", "crawl.vec"):
        t = time.perf_counter()
        _cli_call(["import-embeddings", str(work / name),
                   str(work / f"{name}.npy"), "--config",
                   str(ROOT / DATA_CONFIG), "--dim", str(FASTTEXT["dim"]),
                   *data], zero)
        s = time.perf_counter() - t
        tables.append(np.load(work / f"{name}.npy"))
        mb = (work / name).stat().st_size / 1e6
        _line("data-embeddings", model=name, words=tables[-1].shape[0],
              seconds=f"{s:.2f}", MB_per_s=f"{mb / s:.1f}", card=card)
    # the words both models hold get the same row (the .vec's 6 digits)
    held = np.abs(tables[0] - tables[1]).max(axis=1) < 1e-5
    if not (tables[0].shape == tables[1].shape and held.sum() > len(words) / 3
            and np.isfinite(tables[0]).all()):
        raise AssertionError("the aligned fastText tables disagree")

    # training on the imported data at full width, bf16
    counts = {}
    train_cfg, _, _, train_s, val_s = cli._prepare(parse_cli(
        ["--config", str(ROOT / DATA_CONFIG), *data]))
    B = cfg.batch_size
    argv = ["train", "--config", str(ROOT / DATA_CONFIG), *data,
            "--wordembed_path", str(work / "crawl.bin"), "--epochs", "1",
            "--loss_warmup", "0", "--eval_net_path", "", "--random_seed",
            "0", "--model_save_path", str(work / "out_clips")]
    counts["data:train-imported-clips"], out = _data_train(
        "imported_clips", argv, len(train_s) // B, len(val_s) // B, False,
        card, cfg)
    samples = load_imported_samples(work / "samples")[0]
    argv = ["train", "--config", str(ROOT / DATA_CONFIG),
            "--train_data_path", str(work / "samples"),
            "--test_data_path", str(work / "samples"),
            "--wordembed_path", str(work / "crawl.vec"), "--epochs", "1",
            "--loss_warmup", "-1", "--eval_net_path", "", "--random_seed",
            "0", "--model_save_path", str(work / "out_cache")]
    counts["data:train-imported-samples"], _ = _data_train(
        "imported_samples", argv, len(samples) // B, len(samples) // B, True,
        card, cfg)
    del train_cfg, train_s, val_s, samples
    _hierarchy_checks(cfg, B)
    rc = cli.main(["compare-trajectory", str(out / "history.jsonl"),
                   "--ref", "ted_expressive_new", "--json",
                   str(work / "report.json")])
    report = json.loads((work / "report.json").read_text())
    verdicts = {k: e["verdict"] for k, e in report["metrics"].items()}
    ok = (rc in (0, 1) and report["ref_name"] == "ted_expressive_new"
          and set(verdicts) == {"frechet", "joint_mae", "diversity",
                                "feat_dist", "loss"}
          and set(verdicts.values()) <= {"BEATS", "WITHIN_NOISE", "BEHIND",
                                         "MISSING", "INSUFFICIENT_REF"}
          and len(load_history_jsonl(out / "history.jsonl").val) == 2)
    _line("data-trajectory", rc=rc, **verdicts, ok=ok)
    if not ok:
        raise AssertionError("compare-trajectory gave a malformed report")

    # the H36M gesture autoencoder (no kernel: its step has no GRU)
    rng = np.random.default_rng(14)
    positions = {s: {"Walking": rng.normal(size=(n, 32, 3)).astype(
        np.float32)} for s, n in H36M_FRAMES.items()}
    np.savez(work / "h36m.npz", positions_3d=np.array(positions,
                                                      dtype=object))
    _reset_counts()
    t = time.perf_counter()
    _cli_call(["train", "--config", str(ROOT / "configs" /
                                       "gesture_autoencoder.yaml"),
               "--train_data_path", str(work / "h36m.npz"), "--epochs", "1",
               "--eval_net_path", "", "--model_save_path",
               str(work / "out_h36m")], zero)
    saved = json.loads((work / "out_h36m" / "checkpoint_final" /
                        "config.json").read_text())["config"]
    rows = (work / "out_h36m" / "history.jsonl").read_text().splitlines()
    ok = saved["embed_pose_diff_loss"] is True and all(
        np.isfinite(json.loads(r)["loss"]) for r in rows)
    _line("data-h36m", seconds=f"{time.perf_counter() - t:.1f}",
          val_rows=len(rows), embed_pose_diff_loss=saved[
              "embed_pose_diff_loss"], ok=ok, card=card)
    if not ok:
        raise AssertionError("the H36M autoencoder run failed its checks")
    counts["data:h36m"] = _read_counts()

    # doctor on the card: its tiny GAN step's launches as the dataflow's
    doctor_cfg = Config(**cli.DOCTOR_CONFIG)
    want = _expected_counts(doctor_cfg, True)
    if doctor_cfg.z_type not in ("speaker", "random"):
        # no speaker z: no diversity term, so no diversity cascade
        want["b1"] -= doctor_cfg.skeleton.n_levels * doctor_cfg.n_layers
    _reset_counts()
    printed = _cli_call(["doctor"], want)
    counts["data:doctor"] = _read_counts()
    _hierarchy_checks(doctor_cfg, cli.DOCTOR_BATCH)
    name = torch.cuda.get_device_name(0)
    ok = printed.strip().splitlines()[-1] == "OK" and name in printed
    _line("data-doctor", ok=ok, last_line=printed.strip().splitlines()[-1])
    for ln in printed.strip().splitlines():
        print("  doctor:", ln, flush=True)
    if not ok:
        raise AssertionError("doctor failed on the card")
    _line("data-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: v["b1"] for k, v in counts.items()}, card=card)
    return counts


# ---------------------------------------------------------------------------
# phase 13: the last modules (dataset construction, native windowing, the
# trainer's hooks, rendering)
# ---------------------------------------------------------------------------

LAST_CONFIG = "configs_expressive/hierarchy.yaml"
# the artifact work directory: videos of 66 s at 25 fps, three scenes of
# 22 s each, a word every 0.4 s; the last video's speaker faces away (the
# filter rejects its scenes as "looking behind").  Nine clips pass: one
# val, one test, seven train (203 windows: two batches of 96 an epoch)
LAST_VIDEOS, LAST_SECONDS, LAST_FPS, LAST_SCENES = 4, 66.0, 25, 3
# a warm-up epoch and two GAN epochs: six steps, so the profiler records
# global iterations 3-5
LAST_EPOCHS = 3
NATIVE_TARGET_ATOL = 2e-5


def _person25(x0, front=True, shoulder=150.0):
    """An OpenPose BODY_25 person: nose, neck, shoulders, elbows and
    wrists around x0 (facing the camera, or away: shoulders swapped), the
    other 17 points zero."""
    p = np.zeros((25, 3), np.float32)
    half = shoulder / 2
    xs = [x0, x0, x0 - half, x0 - half - 10, x0 - half - 20, x0 + half,
          x0 + half + 10, x0 + half + 20]
    if not front:
        xs[2], xs[5] = xs[5], xs[2]
    p[:8, 0] = xs
    p[:8, 1] = [100, 160, 160, 220, 280, 160, 220, 280]
    p[:8, 2] = 0.9
    return p


def _vtt_time(t: float) -> str:
    return f"{int(t // 3600):02d}:{int(t % 3600 // 60):02d}:{t % 60:06.3f}"


def _last_artifacts(work: Path) -> list:
    """build-dataset's work directory as the outside tools leave it (each
    step resumes from its artifact): a video marker, a 16 kHz mono wav,
    OpenPose frames with TED Expressive skeletons (``keypoints/``, the
    skeletons written directly: the ExPose adapter keeps 23 joints), the
    scenes and an auto-subtitle .vtt, a video.  -> the video ids."""
    import wave
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.skeleton import TED_EXPRESSIVE
    n_frames = int(LAST_SECONDS * LAST_FPS)
    for d in ("videos", "audio", "keypoints", "scenes"):
        (work / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(13)
    vocab = [f"word{i}" for i in range(300)]
    ids = []
    for v in range(LAST_VIDEOS):
        vid = f"ted_video_{v}"
        ids.append(vid)
        clip = synthetic_clips(TED_EXPRESSIVE, n_clips=1,
                               clip_seconds=LAST_SECONDS, fps=LAST_FPS,
                               seed=130 + v)[0]
        (work / "videos" / f"{vid}.mp4").write_bytes(b"\x00")
        pcm = (np.clip(clip["audio_raw"], -1, 1) * 32767).astype("<i2")
        with wave.open(str(work / "audio" / f"{vid}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        front = v < LAST_VIDEOS - 1
        kp = np.empty(n_frames, dtype=object)
        for i in range(n_frames):
            kp[i] = _person25(400 + 30 * np.sin(i / 40), front)[None]
        np.savez_compressed(work / "keypoints" / f"{vid}.npz",
                            keypoints_2d=kp,
                            skeletons_3d=clip["skeletons_3d"])
        step = n_frames // LAST_SCENES
        (work / "scenes" / f"{vid}.csv").write_text("".join(
            f"{s},{s + step}\n" for s in range(0, n_frames, step)))
        # cues of 2 s, five words each: every word's end inline but the
        # last's, which ends with the cue
        cues = []
        for c in range(int(LAST_SECONDS // 2)):
            t0 = 2.0 * c
            words = rng.choice(vocab, 5)
            line = words[0] + "".join(
                f"<{_vtt_time(t0 + 0.4 * (k + 1))}><c> {words[k + 1]}</c>"
                for k in range(4))
            cues.append(f"{_vtt_time(t0)} --> {_vtt_time(t0 + 2.0)}\n"
                        f"{line}\n")
        (work / "videos" / f"{vid}-en-auto.vtt").write_text(
            "WEBVTT\nKind: captions\nLanguage: en\n\n" + "\n".join(cues))
    return ids


def _gif_info(path) -> dict:
    """A GIF read with the standard library alone: its size, frames and
    frame delays (hundredths of a second), walking its blocks."""
    import struct
    data = Path(path).read_bytes()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise AssertionError(f"{path} is not a GIF")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    i = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays = 0, []

    def skip_sub_blocks(i):
        while data[i]:
            i += data[i] + 1
        return i + 1

    while data[i] != 0x3B:
        if data[i] == 0x21:                      # an extension
            if data[i + 1] == 0xF9:
                delays.append(struct.unpack("<H", data[i + 4:i + 6])[0])
            i = skip_sub_blocks(i + 2)
        elif data[i] == 0x2C:                    # an image
            fw, fh, fpacked = struct.unpack("<HHB", data[i + 5:i + 10])
            if (fw, fh) != (w, h):
                raise AssertionError(f"{path}: a frame of another size")
            i += 10 + (3 << ((fpacked & 7) + 1) if fpacked & 0x80 else 0)
            i = skip_sub_blocks(i + 1)           # LZW code size, data
            frames += 1
        else:
            raise AssertionError(f"{path}: a bad block at byte {i}")
    return {"width": w, "height": h, "frames": frames, "delays": delays}


def _trace_kernels(path, pattern) -> tuple[int, list]:
    """A Chrome trace's device kernels named like ``pattern`` and the
    iterations of its ``train_step#<i>`` ranges."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    n = sum(1 for e in events if e.get("cat") == "kernel"
            and pattern in e.get("name", ""))
    steps = sorted({int(e["name"].split("#")[1]) for e in events
                    if e.get("name", "").startswith("train_step#")})
    return n, steps


def _last_modules(work: Path, card: str):
    """Phase 13: ``cli build-dataset --qa-report`` over a work directory of
    synthetic TED Expressive videos, the built clips windowed by the native
    engine and by numpy, the shipped Expressive config (bf16, batch 96)
    trained on them through ``Trainer(tensorboard=True, profile_dir=...)``
    and ``fit(render_every=1)`` with a seeded random MotionAE evaluator,
    its feature view, ``cli synthesize --render`` from the checkpoint; B1,
    its backward and B2-B4 against their plain versions at the phase's
    shapes.  -> launch counts by path."""
    import ast
    from ha2g_torch import cli, native, render
    from ha2g_torch.config import Config
    from ha2g_torch.data.dataset import window_clips
    from ha2g_torch.data.storage import load_clips
    from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator
    from ha2g_torch.models.common import init_parameters_
    from ha2g_torch.models.motion_ae import MotionAE
    from ha2g_torch.synthesis import _window_layout
    from ha2g_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = Config.from_yaml(ROOT / LAST_CONFIG)
    zero = dict.fromkeys(_expected_counts(cfg, True), 0)
    per_call = cfg.skeleton.n_levels * cfg.n_layers
    counts = {}

    # build-dataset (host only: no launch)
    ids = _last_artifacts(work / "work")
    data = work / "data"
    _reset_counts()
    t = time.perf_counter()
    printed = _cli_call(["build-dataset", *ids, "--work", str(work / "work"),
                         "--out", str(data), "--qa-report"], zero)
    build_s = time.perf_counter() - t
    result = ast.literal_eval(printed.strip().splitlines()[-1])
    report = Path(result["qa_report"]).read_text()
    ok = (result["videos"] == LAST_VIDEOS - 1
          and result["skipped"] == [ids[-1]]
          and (result["train"], result["val"], result["test"]) == (7, 1, 1)
          and "looking behind" in report
          and report.count("data:image/png;base64") == 6)
    _line("last-build-dataset", videos=result["videos"],
          skipped=result["skipped"], train=result["train"],
          val=result["val"], test=result["test"],
          seconds=f"{build_s:.2f}", report_bytes=len(report), ok=ok,
          card=card)
    if not ok:
        raise AssertionError("build-dataset built other clips than planned")

    # the built clips windowed by the native engine and by numpy
    train_clips = load_clips(data / "train")
    run_cfg, lang, speaker, train_s, val_s = cli._prepare(cfg.replace(
        train_data_path=str(data / "train"),
        test_data_path=str(data / "val"), eval_net_path="",
        loss_warmup=0, epochs=LAST_EPOCHS, random_seed=0,
        model_save_path=str(work / "out")))
    kw = dict(spec=cfg.skeleton, lang=lang, speaker=speaker,
              mean_pose=cfg.mean_pose_array,
              mean_dir_vec=cfg.mean_dir_vec_array, n_poses=cfg.n_poses,
              subdivision_stride=cfg.subdivision_stride,
              fps=cfg.motion_resampling_framerate, static_joints=(6, 7))
    windows, seconds = {}, {}
    for use in (True, False):
        t = time.perf_counter()
        windows[use] = window_clips(train_clips, use_native=use, **kw)
        seconds[use] = time.perf_counter() - t
    a, b = windows[True], windows[False]
    diff = float(np.abs(a.target - b.target).max()) if len(a) == len(b) \
        else float("inf")
    ok = (native.available() and len(a) == len(b) == len(train_s)
          and diff <= NATIVE_TARGET_ATOL and all(
              np.array_equal(getattr(a, f), getattr(b, f))
              for f in ("text", "word_seq", "audio", "spec", "vids")))
    _line("last-windows", native=len(a), numpy=len(b),
          max_target_diff=f"{diff:.3g}", atol=NATIVE_TARGET_ATOL,
          native_s=f"{seconds[True]:.3f}", numpy_s=f"{seconds[False]:.3f}",
          ok=ok, card=card)
    if not ok:
        raise AssertionError("the native engine and numpy window apart")
    del windows, a, b

    # the trainer's hooks and renders on the built clips
    B = cfg.batch_size
    n_train, n_val = len(train_s) // B, -(-len(val_s) // B)
    if n_train * LAST_EPOCHS < 6 or len(val_s) >= B:
        raise AssertionError(f"{len(train_s)} train / {len(val_s)} val "
                             "windows: not the phase's plan")
    net = MotionAE(126, 128)
    init_parameters_(net, torch.Generator().manual_seed(0))
    evaluator = EmbeddingSpaceEvaluator(126, cfg.n_poses, net.state_dict())
    trainer = Trainer(run_cfg, train_s, val_s, lang, speaker, evaluator,
                      tensorboard=True, profile_dir=str(work / "profile"))
    tb_wrote = trainer.tb is not None
    # the B1 launches inside the profiler's recording: from its step after
    # iteration 2 to its step after iteration 5
    window = {}
    profile_step = Trainer._profile_step

    def marked(self):
        if self.global_iter in (3, 6):
            window[self.global_iter] = _read_counts()["b1"]
        profile_step(self)

    renders = []
    create = render.create_video_and_save

    def timed_render(*args, **kwargs):
        t = time.perf_counter()
        path = create(*args, **kwargs)
        renders.append((path, time.perf_counter() - t))
        return path

    times, unwrap = _timed_train_steps()
    Trainer._profile_step = marked
    render.create_video_and_save = timed_render
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    try:
        history = trainer.fit(render_every=1)
    finally:
        unwrap()
        Trainer._profile_step = profile_step
        render.create_video_and_save = create
    fit_s = time.perf_counter() - t
    counts["last-modules:fit"] = _read_counts()
    evals = {**zero, "b1": n_val * per_call}
    want = _add(*[evals] * (2 * LAST_EPOCHS + 1), *[
        {k: n_train * v for k, v in _expected_counts(cfg, e > 0).items()}
        for e in range(LAST_EPOCHS)])
    launches_ok = counts["last-modules:fit"] == want
    trace = work / "profile" / "trace.json"
    traced, steps = _trace_kernels(trace, KERNEL_PATTERNS["b1"]) \
        if trace.exists() else (0, [])
    in_window = window.get(6, -1) - window.get(3, 0)
    gifs = [_gif_info(p) for p, _ in renders]
    frames = sum(g["frames"] for g in gifs)
    tb_files = list((work / "out" / "tb").glob("events.out.tfevents*"))
    real, gen = evaluator.get_features_for_viz()
    # epoch 0 warms up without the discriminator; the GAN steps are the
    # later epochs'.  Each of them runs under the profiler (its warm-up at
    # step 2, its recording at steps 3-5), and each epoch's first follows
    # an evaluation and a render
    warm_ms, gan_ms = times[:n_train], times[n_train:]
    ok = (launches_ok and len(times) == n_train * LAST_EPOCHS
          and steps == [3, 4, 5] and traced == in_window
          >= 3 * _expected_counts(cfg, True)["b1"]
          and len(renders) == LAST_EPOCHS and all(
              g["frames"] == cfg.n_poses and g["width"] == 2 * g["height"]
              and set(g["delays"]) == {1000 // 15 // 10} for g in gifs)
          and bool(tb_files) == tb_wrote
          and real.shape == gen.shape == (len(val_s), 2)
          and np.isfinite(real).all() and np.isfinite(gen).all()
          and all(np.isfinite(r[k]) for r in history
                  for k in ("loss", "frechet")))
    _line("last-fit", epochs=LAST_EPOCHS, steps=len(times),
          first_step_ms=f"{times[0]:.1f}",
          warmup_step_ms_median=f"{statistics.median(warm_ms):.1f}",
          gan_steps=len(gan_ms),
          gan_step_ms_median=f"{statistics.median(gan_ms):.1f}",
          fit_seconds=f"{fit_s:.1f}",
          peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          launches={k: f"{counts['last-modules:fit'][k]}/{want[k]}"
                    for k in want}, card=card)
    _line("last-profile", trace_MB=f"{trace.stat().st_size / 1e6:.1f}"
          if trace.exists() else 0, step_ranges=steps,
          b1_kernels_traced=traced, b1_launched_while_recording=in_window)
    _line("last-render", files=len(renders),
          frames=[g["frames"] for g in gifs],
          size=f"{gifs[0]['width']}x{gifs[0]['height']}" if gifs else "",
          s_per_frame=f"{sum(s for _, s in renders) / max(frames, 1):.4f}",
          card=card)
    _line("last-tensorboard", wrote=tb_wrote, event_files=len(tb_files),
          note="" if tb_wrote else "no tensorboard package: warned")
    _line("last-features", real=tuple(real.shape), generated=tuple(gen.shape),
          ok=ok)
    if not ok:
        raise AssertionError("the trainer's hooks failed their checks")
    val_rows = len(val_s)
    del trainer, evaluator, train_s, val_s
    torch.cuda.empty_cache()

    # synthesize --render from the checkpoint the run saved
    seconds_clip = min(len(c["audio_raw"]) for c in train_clips[:2]) / SR
    _, _, W = _window_layout(cfg, seconds_clip)
    _reset_counts()
    out_npz = work / "synth.npz"
    t = time.perf_counter()
    _cli_call(["synthesize", str(work / "out" / "checkpoint_final"),
               "--clips", str(data / "train"), "--n", "2", "--render",
               "--out", str(out_npz)], {**zero, "b1": W * per_call})
    counts["last-modules:synthesize"] = _read_counts()
    synth = np.load(out_npz)["dir_vec"]
    gif = _gif_info(work / "synth_000_0.gif")
    ok = (synth.shape[0] == 2 and np.isfinite(synth).all()
          and gif["frames"] == synth.shape[1])
    _line("last-synthesize", shape=tuple(synth.shape), windows=W,
          gif_frames=gif["frames"], seconds=f"{time.perf_counter() - t:.1f}",
          ok=ok, card=card)
    if not ok:
        raise AssertionError("synthesize --render failed its checks")

    # the kernels against their plain versions at the phase's shapes: the
    # train step's, and the evaluation's and renders' batch of val rows
    _hierarchy_checks(cfg, B)
    with _uncounted():
        _b1_check(((cfg.n_poses, val_rows, cfg.hidden_size),))
    _line("last-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: v["b1"] for k, v in counts.items()}, card=card)
    return counts


# ---------------------------------------------------------------------------
# phase 14: the benchmark's synthesis batch
# ---------------------------------------------------------------------------

# the JAX package's benchmark workload (bench.py:131-138): 256 clips of 20 s
# of mu-law audio, one prepare_fused, run_fused at chunk 128 with a float16
# pull (the headline) beside chunk 0 and float32
BENCH_CLIPS = 256
BENCH_CHUNK = 128
# timed calls of the headline and of the other variants, after a first
# call of each (the one the checks read)
BENCH_REPS = {True: 10, False: 3}
# a float16 pull against the float32 pull of the same call: float16
# rounding, half a step of 2^-10 relative
F16_REL, F16_ABS = 2.0 ** -11, 1e-7
# chunked against unchunked at B = 8 in fp32 (z at mu): cuDNN may take
# another algorithm at another batch
CHUNK_FP32_ATOL = 1e-4


def _intervals_union(spans):
    """Merged (start, end) intervals of ``spans``."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _copy_overlap(fn):
    """One call of fn under torch.profiler -> {kernels, copies, device busy
    ms (the union of every device interval), copy ms, the ms during which
    a copy ran beside a kernel, and (device ms, count) by name, largest
    first}, or None without device events."""
    spans = []
    per_name = _device_kernels(fn, spans=spans)
    copies = [(a, b) for name, a, b in spans if name.startswith("Memcpy")]
    kernels = [(a, b) for name, a, b in spans
               if not name.startswith("Memcpy")]
    if not kernels:
        return None
    running = _intervals_union(kernels)
    starts = [c for c, _ in running]
    overlap = 0.0
    for a, b in copies:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(running) and running[i][0] < b:
            overlap += max(0.0, min(b, running[i][1]) - max(a, running[i][0]))
            i += 1
    return {"kernels": len(kernels), "copies": len(copies),
            "busy_ms": sum(b - a for a, b in
                           _intervals_union(kernels + copies)) / 1e3,
            "copy_ms": sum(b - a for a, b in copies) / 1e3,
            "overlap_ms": overlap / 1e3,
            "by_name": sorted(per_name.items(), key=lambda kv: -kv[1][0])}


def _pinned_synthesizer(compute_dtype):
    """Phase 3's full-width hierarchy (seed-0 weights) with speaker z
    pinned at mu (logvar weight 0, bias -100): the same operations, and a
    result that does not depend on how the batch is split."""
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.hierarchy import HierarchySystem
    cfg = _config(compute_dtype)
    system = HierarchySystem(cfg, N_WORDS, N_SPEAKERS,
                             generator=torch.Generator().manual_seed(0))
    state = system.state_dict()
    for level in range(cfg.skeleton.n_levels):
        state[f"gens.{level}.speaker_logvar.weight"].zero_()
        state[f"gens.{level}.speaker_logvar.bias"].fill_(-100.0)
    return cfg, make_synthesizer(system, state)


def _chunked_fp32_check(lang):
    """run_fused at B = 8 in fp32 on the card, speaker z pinned at mu:
    chunks of 3 (a ragged last chunk of 2) against one call."""
    _, synth = _pinned_synthesizer("float32")
    audio, words, vids = _requests(8, CLIP_SECONDS, 21)
    plan = synth.prepare_fused(words, lang, vids, audio.shape[1])
    one = synth.run_fused(audio, plan)
    chunked = synth.run_fused(audio, plan, chunk=3)
    err = float(np.abs(chunked - one).max())
    ok = chunked.shape == one.shape and err <= CHUNK_FP32_ATOL
    _line("bench-chunk-fp32", B=8, chunk=3, max_abs_err=f"{err:.3e}",
          tol=f"{CHUNK_FP32_ATOL:.0e}", ok=ok)
    if not ok:
        raise AssertionError("chunked run_fused disagrees with one call")


def _bench_batch(card, window_flops_cpu, gan):
    """Phase 14: the JAX benchmark's batch (256 x 20 s mu-law clips, one
    plan) through run_fused at chunk 0 / 128 with float32 / float16 pulls
    on the full-width Expressive hierarchy (bf16, seed-0 weights, speaker
    z pinned at mu): ms a call by the host clock ending in the host array,
    pose frames/s, peak device memory, B1's launches a call (checked); the
    float16 pulls within float16 rounding of the float32 ones; a profile of the headline
    call (device busy, idle share, copies beside kernels); its MFU, and
    the GAN step's (``gan``: config -> (FLOPs, ms)); the chunked fp32 call
    at B = 8 against one call; the card's FLOPs of one window against the
    CPU's (phase 3).  -> launch counts."""
    from ha2g_torch.ops.mel import mulaw_encode_np
    from ha2g_torch.synthesis import _window_layout
    from ha2g_torch.utils.roofline import count_flops, mfu_line

    t0 = time.perf_counter()
    cfg, synth = _pinned_synthesizer("bfloat16")
    lang = _vocab()
    audio, words, vids = _requests(BENCH_CLIPS, CLIP_SECONDS, 14)
    audio = mulaw_encode_np(audio)
    _, _, W = _window_layout(cfg, CLIP_SECONDS)
    per_call = W * cfg.skeleton.n_levels * cfg.n_layers
    frames = BENCH_CLIPS * (cfg.n_poses + (W - 1)
                            * (cfg.n_poses - cfg.n_pre_poses))
    _line("bench-batch", clips=BENCH_CLIPS, seconds=CLIP_SECONDS,
          upload_mb=f"{audio.nbytes / 1e6:.1f}", windows=W,
          pose_frames=frames, card=card)

    _reset_counts()
    plan = synth.prepare_fused(words, lang, vids, audio.shape[1])
    outs, times = {}, {}
    for chunk in (0, BENCH_CHUNK):
        for half in (False, True):
            out_dtype = np.float16 if half else None
            call = lambda: synth.run_fused(audio, plan, chunk=chunk,
                                           out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = _read_counts()["b1"]
            outs[(chunk, half)] = out = call()
            launches = _read_counts()["b1"] - before
            want = per_call * (-(-BENCH_CLIPS // chunk) if chunk else 1)
            ms = []
            for _ in range(BENCH_REPS[chunk == BENCH_CHUNK and half]):
                t = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            times[(chunk, half)] = med = statistics.median(ms)
            ok = (out.dtype == np.float32 and out.shape[0] == BENCH_CLIPS
                  and out.shape[1] * BENCH_CLIPS == frames
                  and bool(np.isfinite(out).all()) and launches == want)
            _line("bench-run", chunk=chunk,
                  pull="float16" if half else "float32", calls=len(ms),
                  ms_median=f"{med:.2f}", ms_min=f"{min(ms):.2f}",
                  ms_max=f"{max(ms):.2f}",
                  frames_per_s=f"{frames / med * 1e3:.0f}",
                  peak_memory_gib=f"{peak:.2f}",
                  b1_launches=f"{launches}/{want}", ok=ok, card=card)
            if not ok:
                raise AssertionError(f"run_fused chunk={chunk} half={half} "
                                     "failed its checks")
    # the float16 pull is the float32 pull of the same call, rounded
    for chunk in (0, BENCH_CHUNK):
        full, half = outs[(chunk, False)], outs[(chunk, True)]
        excess = float(np.max(np.abs(half - full)
                              - (F16_REL * np.abs(full) + F16_ABS)))
        ok = excess <= 0.0
        _line("bench-f16-pull", chunk=chunk,
              max_abs_err=f"{np.abs(half - full).max():.3e}",
              worst_excess_over_bound=f"{excess:.3e}", ok=ok)
        if not ok:
            raise AssertionError(f"the float16 pull at chunk={chunk} is not "
                                 "the float32 pull rounded")
    # chunked against unchunked in bf16: informative (with z at mu, the
    # encoder's and the cascade's products at another batch, rounded to
    # bf16, are all that differs)
    for half in (False, True):
        a, b = outs[(BENCH_CHUNK, half)], outs[(0, half)]
        _line("bench-chunk-vs-one-bf16", pull="float16" if half else
              "float32", equal=bool(np.array_equal(a, b)),
              unequal_share=f"{np.mean(a != b):.4f}",
              max_abs_err=f"{np.abs(a - b).max():.3e}")

    headline = lambda: synth.run_fused(audio, plan, chunk=BENCH_CHUNK,
                                       out_dtype=np.float16)
    e2e = times[(BENCH_CHUNK, True)]
    for chunk, half in ((0, False), (BENCH_CHUNK, True)):
        pull = "float16" if half else "float32"
        prof = _copy_overlap(lambda: synth.run_fused(
            audio, plan, chunk=chunk,
            out_dtype=np.float16 if half else None))
        if prof is None:
            _line("bench-profile", chunk=chunk, pull=pull,
                  device_busy_ms="not measured",
                  reason="the profiler recorded no device events")
            continue
        wall = times[(chunk, half)]
        _line("bench-profile", chunk=chunk, pull=pull, e2e_ms=f"{wall:.2f}",
              device_busy_ms=f"{prof['busy_ms']:.2f}",
              idle_share=f"{1 - prof['busy_ms'] / wall:.3f}",
              kernels=prof["kernels"], copies=prof["copies"],
              copy_ms=f"{prof['copy_ms']:.2f}",
              copy_beside_kernel_ms=f"{prof['overlap_ms']:.2f}", card=card)
        for name, (ms, n) in prof["by_name"][:10]:
            _line("bench-profile-top", chunk=chunk, pull=pull,
                  ms=f"{ms:.2f}", count=n, name=name[:90].replace(" ", "_"))
        for name, (ms, n) in prof["by_name"]:
            if name.startswith("Memcpy"):
                _line("bench-profile-copy", chunk=chunk, pull=pull,
                      ms=f"{ms:.3f}", count=n, name=name.replace(" ", "_"))
    flops = count_flops(headline)
    _line("bench-mfu", chunk=BENCH_CHUNK, pull="float16",
          flops=f"{flops:.0f}", line=f"'{mfu_line(flops, e2e / 1e3)}'")
    for config, (step_flops, step_ms) in gan.items():
        _line("train-mfu", config=config, gan_step_ms=f"{step_ms:.1f}",
              flops=f"{step_flops:.0f}",
              line=f"'{mfu_line(step_flops, step_ms / 1e3)}'")
    counts = {"bench-batch": _read_counts()}

    # one window's FLOPs on the card against the CPU's (phase 3)
    _reset_counts()
    window = count_flops(synth.generate_fused,
                         *_requests(1, WINDOW_SECONDS, 4)[:2], lang,
                         np.array([1]), torch.Generator().manual_seed(11))
    ok = window == window_flops_cpu
    _line("bench-window-flops", card=f"{window:.0f}",
          cpu=f"{window_flops_cpu:.0f}", ok=ok)
    if not ok:
        raise AssertionError("one window counts other FLOPs on the card "
                             "than on the CPU")
    del synth
    torch.cuda.empty_cache()
    _chunked_fp32_check(lang)
    counts["bench-checks"] = _read_counts()
    _line("bench-phase", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: v["b1"] for k, v in counts.items()}, card=card)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "ha2g_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no ha2g_torch package beside {Path(__file__).name};"
              " run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ha2g_torch import kernels
    from ha2g_torch.ops import add_norm, contrastive, gru_kernel

    # phase 1: device and build
    smi = _smi()
    print(smi, flush=True)
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = kernels.build([gru_kernel.SOURCE, contrastive.SOURCE,
                          add_norm.SOURCE])
    _line("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=[str(s.relative_to(ROOT)) for s in logs] or "cached")
    for log in logs.values():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip(), flush=True)
    if logs:
        _backward_spills(logs)

    # phase 2: kernels against their plain versions
    errs = _b1_check()
    bwd_errs = _b1_bwd_check()
    _b1_grad_check()
    b234_errs = _b234_check()
    add_norm_errs = _add_norm_check()

    # phase 3: the serving path
    _reset_counts()
    serving_b1, per_request, e2e, window_flops = _slice()
    serving = {**_read_counts(), "b1": serving_b1}
    if any(serving[k] for k in ("b1_bwd", "b2", "b3", "b4", "add_norm")):
        raise AssertionError("training or denoiser kernels launched while "
                             "serving the hierarchy")
    diffuse = _diffuse_counts()

    # phase 4: the training path, each run read on its own
    runs, bare_gan_ms, gan_flops = {}, {}, {}
    for config, steps in TRAIN_RUNS:
        runs[config], bare_gan_ms[config], gan_flops[config] = _train(
            config, steps)
    training = {k: sum(r[k] for r in runs.values()) for k in serving}
    _train_card_vs_cpu()

    # phase 5: kernel times at the serving and train shapes
    times = {}
    for B in (1, 8, 16, 96):
        for dtype in (torch.bfloat16, torch.float32):
            times[(B, dtype)] = _b1_times(34, B, 300, dtype)
    main = times[(8, torch.bfloat16)]
    # B1's share of each request: its launches times its time per launch
    for name, (B, ms) in e2e.items():
        b1_ms = per_request * times[(B, torch.bfloat16)]["ms"]
        _line("e2e-b1-share", request=name, e2e_ms=f"{ms:.2f}",
              b1_launches=per_request, b1_ms=f"{b1_ms:.2f}",
              share=f"{b1_ms / ms:.3f}")
    bwd = {dtype: _b1_backward_times(dtype)
           for dtype in (torch.bfloat16, torch.float32)}
    # the benchmark batch's 256 clips unchunked (phase 14)
    b256 = {dtype: _b1_times(34, 256, 300, dtype)
            for dtype in (torch.bfloat16, torch.float32)}
    # the baselines' train shapes: batch 128, the multimodal generator's
    # H = 300 and its discriminator's H = 64 (28 steps)
    for T, H in ((34, 300), (28, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            _b1_times(T, 128, H, dtype)
            _b1_backward_times(dtype, T=T, B=128, H=H)
    # the seq2seq encoder's train shape: word sequences of 32, batch 128,
    # H = 200; the Expressive step's 48 rows a rank on two ranks
    for T, B, H in ((32, 128, 200), (34, 48, 300)):
        for dtype in (torch.bfloat16, torch.float32):
            _b1_times(T, B, H, dtype)
            _b1_backward_times(dtype, T=T, B=B, H=H)
    # the backward at the Gesture step's batch 256
    for dtype in (torch.bfloat16, torch.float32):
        _b1_backward_times(dtype, T=34, B=256, H=300)
    b234 = {N: _b234_times(N) for N in (3264, 8704)}
    add_norm_times = _add_norm_times()
    _sass_reckoning()

    # phase 6: the training driver (loader, command line, trainer, fp32
    # evaluation against the CPU); its files live in a directory of the
    # checkout that is removed at the end
    _loader_check()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        work = Path(tmp)
        cli_counts, cli_argv = _cli(work)
        _trainer_times(cli_argv, bare_gan_ms[CLI_CONFIG], work)
        _eval_card_vs_cpu(work)

    # phase 7: bf16 training against fp32
    _bf16_drift()

    # phase 8: serving a checkpoint (bridge, service, HTTP, streams, CLI)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        serve_paths, _ = _serving(Path(tmp))

    # phase 9: the GAN baselines (train, card vs CPU, serve, checkpoints)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        baselines = _baselines(Path(tmp), BASELINE_RUNS, "baselines")

    # phase 10: the text and embedding baselines (the masked encoder on
    # B1, train, card vs CPU, serve, checkpoints, the embedders' loop)
    for b in MASKED_ENCODER_BATCHES:
        _masked_encoder_check(b)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        baselines.update(_baselines(Path(tmp), TEXT_RUNS, "text",
                                    _embedder_loop))

    # phase 11: multi-device training (NCCL, gloo ranks sharing the card,
    # DP and FSDP) and sharded synthesis
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        baselines.update(_multi_device(Path(tmp)))

    # phase 12: the host data path (lmdb stores, imports, fastText, cli
    # train on imported data, trajectory, H36M, doctor)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        baselines.update(_data_path(Path(tmp), smi))

    # phase 13: the last modules (build-dataset, native windowing, the
    # trainer's tensorboard / profiler / render hooks, synthesize --render)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        baselines.update(_last_modules(Path(tmp), smi))

    # phase 14: the benchmark's synthesis batch (256 x 20 s mu-law clips,
    # chunk 0 / 128, float32 / float16 pulls), FLOPs and MFU
    baselines.update(_bench_batch(smi, window_flops, {
        c: (gan_flops[c], bare_gan_ms[c]) for c in gan_flops}))

    print(smi, flush=True)
    by_path = lambda k: {"serving": serving[k], **{
        f"training:{config}": run[k] for config, run in runs.items()},
        "training:cli": cli_counts[k], **{
            path: n if k == "b1" else 0 for path, n in serve_paths.items()},
        **{path: c[k] for path, c in baselines.items()}}
    # phases 9 to 14
    phase9 = lambda k: sum(c[k] for c in baselines.values())
    entries = [{
        "name": "gru_recurrence", "route": "cuda",
        "source": "ha2g_torch/csrc/gru_recurrence.cu",
        "replaces": "ha2g_tpu/ops/pallas_gru.py:48",
        "launches": serving["b1"] + training["b1"] + cli_counts["b1"]
        + sum(serve_paths.values()) + phase9("b1"),
        "launches_by_path": by_path("b1"),
        "max_abs_err": errs[(34, 8, 300, torch.bfloat16)],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "ms_B256": b256[torch.bfloat16]["ms"],
        "bound_ms_B256": b256[torch.bfloat16]["bound_ms"],
        "library_ms_B256": b256[torch.bfloat16]["library_ms"],
        "waves_B256": b256[torch.bfloat16]["waves"],
        "max_abs_err_B256": errs[(34, 256, 300, torch.bfloat16)]}]
    t = bwd[torch.bfloat16]
    entries.append({
        "name": "gru_recurrence_backward", "route": "cuda",
        "source": "ha2g_torch/csrc/gru_recurrence.cu",
        "replaces": "ha2g_tpu/ops/gru.py:100",
        "launches": serving["b1_bwd"] + training["b1_bwd"]
        + cli_counts["b1_bwd"] + phase9("b1_bwd"),
        "launches_by_path": by_path("b1_bwd"),
        "max_abs_err": bwd_errs[(34, 96, 300, torch.bfloat16)],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "waves": t["waves"]})
    for k, name, line in (("b2", "contrastive_fwd", 51),
                          ("b3", "contrastive_bwd_da", 97),
                          ("b4", "contrastive_bwd_db", 115)):
        t = b234[3264][k]
        entries.append({
            "name": name, "route": "cuda",
            "source": "ha2g_torch/csrc/contrastive.cu",
            "replaces": f"ha2g_tpu/ops/pallas_contrastive.py:{line}",
            "launches": serving[k] + training[k] + cli_counts[k]
            + phase9(k),
            "launches_by_path": by_path(k),
            "max_abs_err": b234_errs[(3264, 32)][k],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "call_ms": t["call_ms"],
            "ms_N8704": b234[8704][k]["ms"],
            "bound_ms_N8704": b234[8704][k]["bound_ms"]})
    t = add_norm_times
    entries.append({
        "name": "add_layer_norm", "route": "cuda",
        "source": "ha2g_torch/csrc/add_layer_norm.cu", "replaces": None,
        "launches": diffuse["add_norm"],
        "launches_by_path": {"serving:diffusion": diffuse["add_norm"],
                             **by_path("add_norm")},
        "max_err_of_tol": max(add_norm_errs.values()),
        "ms": t["ms"], "cold_ms": t["fused_cold_ms"],
        "plain_ms": t["plain_cold_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_cold_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
