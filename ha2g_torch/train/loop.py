"""The epoch training driver (the port of ha2g_tpu/train/loop.py;
reference train.py:91-324 and evaluate_testset, train.py:326-508).

* Each epoch evaluates first (every ``eval_every``-th epoch with
  ``fit(eval_every=N)``), then trains.  Evaluation draws speaker ids
  from ``np.random.default_rng(epoch)`` (speaker z) and gives eval batch i
  a CPU generator seeded ``seed + 10_000 + i``, so an evaluation is the
  same on every device.
* Per-key best tracking: ``frechet`` picks ``checkpoint_best`` when an
  FGD evaluator is present, else ``loss``; ``diversity`` is maximised,
  every other key minimised.  ``checkpoint_{epoch:03d}`` every 10 epochs
  and ``checkpoint_final`` at the end; every evaluation is a row of
  ``history.jsonl``.
* GAN steps run when ``epoch > loss_warmup`` for the hierarchy and
  multimodal_context; the other families' steps have no warm-up, and the
  TED Expressive FGD embedder (gesture_autoencoder at pose 126) takes the
  epoch's learning rate (``MotionAESystem.lr_for_epoch``).  The train
  loader ships the fields the system reads (its ``batch_keys``).
* gesture_autoencoder evaluates its reconstruction loss only: no MAJE,
  accel, BC or FGD (JAX loop.py:186), so it selects by the loss.
* The train steps' metrics are summed on the device and read once at the
  end of an epoch (and every N global iterations with
  ``fit(log_every=N)``), so no other step waits on a host read.
* One ``torch.Generator`` on the device, seeded from ``random_seed``,
  drives the train steps' randomness.
* Hooks (JAX loop.py:104-114, 277-333): ``tensorboard`` writes
  ``train/<k>`` at each read of the metric sums (the epoch's means at the
  global step) and ``val/<k>`` at each evaluation to
  ``<model_save_path>/tb`` when ``torch.utils.tensorboard`` imports (else
  a warning); ``profile_dir`` takes a ``torch.profiler`` trace of the
  global iterations 3 to 5 of ``fit`` (CUDA activity too on the card),
  written there as the Chrome trace ``trace.json`` (``trace.rank<r>.json``
  under several processes), each step a ``train_step#<i>`` range holding
  the program's spans (``utils/spans.py``; recorded under any profiler);
  ``fit(render_every=N)`` renders a validation sample against its ground
  truth every N epochs (``render.py``), not for gesture_autoencoder and
  only with ``save_result_video``; a failed render is logged.

Every family of the JAX package: hierarchy, multimodal_context,
speech2gesture, seq2seq, joint_embedding and gesture_autoencoder; and the
port's own pose_diffusion (DiffGesture, ``train/diffusion.py``).

Several processes (``torchrun``, or a process group the caller made) train
as one global batch on the mesh of every rank, ``fsdp_devices`` of them
sharding each parameter (``parallel/mesh.py``; the counterpart of the JAX
trainer's mesh and ``_place_state``): rank 0's state is broadcast, or
sharded under FSDP; each rank's loader takes its rows of every global
batch; the epoch's metric sums are averaged over the ranks with the one
host read; rank 0 evaluates (under FSDP after a gather every rank joins),
keeps the history and writes the checkpoints (full tensors, both Adam
states whole: the file a single process writes), and broadcasts the
validation row, so every rank's best-tracking decides alike.  ``resume`` loads the whole state on
every rank and shards it again.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ha2g_torch.checkpoint import load_config, load_state, save_checkpoint
from ha2g_torch.config import Config
from ha2g_torch.data.loader import BatchLoader
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.device import resolve_device
from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator
from ha2g_torch.eval.metrics import beat_consistency, maje_and_accel
from ha2g_torch.models.seq2seq import MaskedBiGRUEncoder
from ha2g_torch.models.tcn import TextEncoderTCN
from ha2g_torch.parallel.mesh import mesh_for
from ha2g_torch.utils.average_meter import AverageMeter
from ha2g_torch.utils.spans import span

# the families whose train step takes gan_on (epoch > loss_warmup)
GAN_GATED = ("hierarchy", "multimodal_context")


def build_system(cfg: Config, n_words: int, n_speakers: int,
                 word_embeddings=None, device=None,
                 generator: Optional[torch.Generator] = None):
    """The training system of ``cfg.model`` (reference init_model,
    train.py:50-88; gesture_autoencoder at pose 126 is the TED Expressive
    FGD embedder's ``MotionAESystem``).  A word-embedding table, when
    given, initialises every text encoder's embedding (the TCNs' and the
    seq2seq encoder's), as in the JAX package."""
    from ha2g_torch.train import baselines
    if cfg.model == "hierarchy":
        from ha2g_torch.train.hierarchy import HierarchySystem as cls
    elif cfg.model == "pose_diffusion":
        from ha2g_torch.train.diffusion import DiffusionSystem as cls
    elif cfg.model == "gesture_autoencoder" and cfg.pose_dim == 126:
        cls = baselines.MotionAESystem
    else:
        cls = {"multimodal_context": baselines.MultimodalGanSystem,
               "speech2gesture": baselines.S2GSystem,
               "seq2seq": baselines.Seq2SeqSystem,
               "joint_embedding": baselines.EmbedSystem,
               "gesture_autoencoder": baselines.EmbedSystem}.get(cfg.model)
        if cls is None:
            raise ValueError(f"unknown model {cfg.model!r}")
    system = cls(cfg, n_words, n_speakers, device=device, generator=generator)
    if word_embeddings is not None:
        table = torch.as_tensor(np.asarray(word_embeddings, np.float32))
        with torch.no_grad():
            for m in system.modules():
                if isinstance(m, (TextEncoderTCN, MaskedBiGRUEncoder)):
                    m.embedding.weight.copy_(table)
    return system


class Trainer:
    def __init__(self, cfg: Config, train_samples, val_samples, lang: Vocab,
                 speaker: Vocab,
                 evaluator: Optional[EmbeddingSpaceEvaluator] = None,
                 beat_consistency_score: bool = False, device=None,
                 tensorboard: bool = False,
                 profile_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lang = lang
        self.speaker = speaker
        self.evaluator = evaluator
        self.bc_enabled = beat_consistency_score
        self.seed = max(cfg.random_seed, 0)
        self.system = build_system(
            cfg, lang.n_words, max(speaker.n_words, 1),
            lang.word_embedding_weights, device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        # several processes: rank 0's state on every rank (sharded under
        # FSDP), each rank's loader its rows of every global batch
        self.mesh = mesh_for(cfg, self.device)
        part = (0, 1)
        if self.mesh is not None:
            self.mesh.place(self.system)
            part = (self.mesh.rank, self.mesh.world)
        # the train loader ships only the fields the step reads, to the
        # device; the val batches stay on the host (the metrics read them)
        self.train_loader = BatchLoader(
            train_samples, cfg.batch_size, shuffle=True,
            keys=self.system.batch_keys, device=self.device, part=part)
        # drop the odd-sized last val batch, as the JAX package does
        self.val_loader = BatchLoader(
            val_samples, cfg.batch_size, shuffle=False,
            drop_last=len(val_samples) >= cfg.batch_size)
        self.step = 0
        self.best_values: dict[str, tuple[float, int]] = {}
        # host seconds of the last evaluate() by part: the eval steps (to
        # the host read of their output), the embedding, MAJE / accel / BC,
        # and the FGD statistics (np.cov + sqrtm)
        self.eval_times: dict[str, float] = {}
        # the steps fit() has taken; the profiler traces iterations 3-5
        self.global_iter = 0
        # fit's log_every: train_epoch also reads the metric sums every N
        # global iterations (0: once an epoch)
        self.log_every = 0
        self.profile_dir = profile_dir
        self._prof = None
        self.tb = None
        if tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(
                    log_dir=str(Path(cfg.model_save_path) / "tb"))
            except ImportError:
                logging.warning("tensorboard unavailable; scalars disabled")

    @property
    def is_main(self) -> bool:
        """The process that evaluates, logs the history and writes."""
        return self.mesh is None or self.mesh.is_main

    def _full_state(self, state: bool = True):
        """Every parameter (and Adam moment) whole within the block: a
        gather every rank joins under FSDP, nothing otherwise."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return self.mesh.full_state(self.system, state=state)

    def validate(self, epoch: int = 0) -> dict:
        """``evaluate`` on rank 0, its row on every rank."""
        if self.mesh is None:
            return self.evaluate(epoch)
        with self._full_state(state=False):
            val = self.evaluate(epoch) if self.mesh.is_main else None
        return self.mesh.broadcast_object(val)

    # ------------------------------------------------------------------
    def evaluate(self, epoch: int = 0) -> dict:
        """Validation metrics of the current parameters: loss (mean L1),
        joint_mae, accel, BC (with beat consistency on), and frechet,
        feat_dist, diversity (with an evaluator).  gesture_autoencoder
        computes the loss alone (joint_mae and accel stay 0)."""
        cfg = self.cfg
        meters = {k: AverageMeter(k) for k in ("loss", "joint_mae", "accel",
                                               "bc")}
        poses = cfg.model != "gesture_autoencoder"
        if self.evaluator:
            self.evaluator.reset()
        mean_vec = cfg.mean_dir_vec_array
        rng = np.random.default_rng(epoch)
        times = dict.fromkeys(("eval_step", "embed", "metrics", "stats"), 0.0)
        t0 = time.perf_counter()
        for i, batch in enumerate(self.val_loader):
            b = dict(batch)
            if cfg.z_type == "speaker" and self.speaker.n_words > 0:
                # random speaker ids at eval (train.py:366)
                b["vids"] = rng.integers(0, self.speaker.n_words,
                                         b["vids"].shape).astype(np.int32)
            t = time.perf_counter()
            # a CPU generator: the speaker-z noise of an evaluation is the
            # same on every device
            gen = torch.Generator().manual_seed(self.seed + 10_000 + i)
            out, loss = self.system.eval_step(b, gen)
            B = b["target"].shape[0]
            meters["loss"].update(float(loss), B)
            if not poses:
                times["eval_step"] += time.perf_counter() - t
                continue
            out_np = out.cpu().numpy()
            times["eval_step"] += time.perf_counter() - t
            if self.evaluator:
                t = time.perf_counter()
                self.evaluator.push_samples(out, b["target"])
                times["embed"] += time.perf_counter() - t
            t = time.perf_counter()
            mae, acc = maje_and_accel(out_np, b["target"], mean_vec,
                                      cfg.skeleton, cfg.n_pre_poses)
            meters["joint_mae"].update(mae, B)
            meters["accel"].update(acc, B)
            if self.bc_enabled:
                bc, n = beat_consistency(
                    out_np, b["audio"], mean_vec, cfg.skeleton,
                    cfg.motion_resampling_framerate)
                if n:
                    meters["bc"].update(bc, n)
            times["metrics"] += time.perf_counter() - t

        ret = {"loss": meters["loss"].avg,
               "joint_mae": meters["joint_mae"].avg,
               "accel": meters["accel"].avg}
        if self.bc_enabled:
            ret["BC"] = meters["bc"].avg
        if self.evaluator and self.evaluator.get_no_of_samples() > 0:
            t = time.perf_counter()
            ret["frechet"], ret["feat_dist"] = self.evaluator.get_scores()
            times["stats"] = time.perf_counter() - t
            ret["diversity"] = self.evaluator.get_diversity_scores()
        times["total"] = time.perf_counter() - t0
        self.eval_times = times
        logging.info("[VAL] " + ", ".join(f"{k}: {v:.4f}"
                                          for k, v in ret.items()) +
                     f" / {times['total']:.1f}s")
        return ret

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        """One pass over the train loader; -> the metrics' epoch means and
        ``samples_per_s``.  The metrics are summed on the device and read
        at the epoch's end, and with ``log_every`` N (``fit``'s) also every
        N global iterations, each such read logged with the epoch's
        running means and samples/s (JAX loop.py:341-347)."""
        log_every = self.log_every
        sums: dict[str, torch.Tensor] = {}     # on the device, since a read
        totals: dict[str, float] = {}          # the reads' sums
        world = 1 if self.mesh is None else self.mesh.world
        t0, n_steps, n_samples, pending = time.perf_counter(), 0, 0, 0

        def read():
            nonlocal sums, pending
            keys = sorted(sums)
            if not keys:
                return
            with span("ha2g.trainer.read"):
                stacked = torch.stack([sums[k] for k in keys])
                if self.mesh is not None:
                    # each rank's metric is its rows' share of the global one
                    stacked = self.mesh.mean_over_ranks(stacked)
                for k, v in zip(keys, stacked.cpu().tolist()):
                    totals[k] = totals.get(k, 0.0) + v
                    if self.tb is not None:
                        self.tb.add_scalar(f"train/{k}", v / pending,
                                           self.global_iter)
            sums, pending = {}, 0

        batches = iter(self.train_loader)
        while True:
            with span("ha2g.trainer.loader_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            with span(f"train_step#{self.global_iter}"):
                metrics = self._train_step(batch, epoch)
            self.step += 1
            self.global_iter += 1
            self._profile_step()
            n_steps += 1
            pending += 1
            n_samples += batch["target"].shape[0] * world
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
            if log_every and self.global_iter % log_every == 0:
                read()
                sps = n_samples / max(time.perf_counter() - t0, 1e-9)
                logging.info(f"ep {epoch} it {self.global_iter}: " +
                             ", ".join(f"{k}: {v / n_steps:.4f}"
                                       for k, v in totals.items())
                             + f", {sps:.1f} samples/s")
        read()
        means = {k: v / n_steps for k, v in totals.items()}
        sps = n_samples / max(time.perf_counter() - t0, 1e-9)
        logging.info(f"[TRAIN] epoch {epoch}: " +
                     ", ".join(f"{k}: {v:.4f}" for k, v in means.items())
                     + f" ({sps:.1f} samples/s)")
        return {**means, "samples_per_s": sps}

    def _train_step(self, batch: dict, epoch: int) -> dict:
        """The GAN-gated step of the hierarchy and multimodal_context
        (GAN phase when epoch > loss_warmup), the TED Expressive embedder's
        at the epoch's learning rate, the plain one of the others (JAX
        loop.py:119-136, 323-326)."""
        cfg = self.cfg
        if cfg.model in GAN_GATED:
            return self.system.train_step(
                batch, epoch > cfg.loss_warmup, self.generator)
        if cfg.model == "gesture_autoencoder" and cfg.pose_dim == 126:
            return self.system.train_step(
                batch, self.generator, lr=self.system.lr_for_epoch(epoch))
        return self.system.train_step(batch, self.generator)

    def _start_profile(self) -> None:
        """A profiler over fit's first six steps whose schedule records
        iterations 3-5 (2 is its warm-up, discarded: the tracer starts
        there, so the recorded steps lose none of their first records)."""
        from torch.profiler import ProfilerActivity, profile, schedule
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        # one file a rank under several processes
        name = "trace.json" if self.mesh is None else \
            f"trace.rank{self.mesh.rank}.json"
        path = Path(self.profile_dir) / name
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=2, warmup=1, active=3, repeat=1),
            on_trace_ready=lambda prof: prof.export_chrome_trace(str(path)))
        self._prof.start()

    def _profile_step(self) -> None:
        """After a step: advance the profiler's schedule; after iteration
        5 the trace is written and the profiler stopped."""
        if self._prof is None:
            return
        if self.global_iter == 6 and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.step()
        if self.global_iter == 6:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def render_sample(self, epoch: int, save_path: Path,
                      n_samples: int = 1) -> list[str]:
        """The first validation batch through the eval step, its first
        ``n_samples`` rendered against their ground truth into
        ``<save_path>/videos`` (reference evaluate_sample_and_save_video,
        train.py:246-250, 510-649); -> the files written."""
        from ha2g_torch.render import create_video_and_save
        batch = next(iter(self.val_loader))
        gen = torch.Generator().manual_seed(self.seed + 99_000)
        out, _ = self.system.eval_step(dict(batch), gen)
        out = out.float().cpu().numpy()
        paths = []
        for i in range(min(n_samples, out.shape[0])):
            paths.append(create_video_and_save(
                str(Path(save_path) / "videos"), epoch, "val", i,
                batch["target"][i], out[i], self.cfg.mean_dir_vec_array,
                f"epoch {epoch}", self.cfg.skeleton, audio=batch["audio"][i]))
        return paths

    def _render(self, epoch: int, save_path: Path) -> None:
        try:
            self.render_sample(epoch, save_path)
        except Exception as e:  # a render never ends training (JAX too)
            logging.warning("sample render failed: %s", e)

    def resume(self, path) -> int:
        """Restore parameters, batch-norm statistics, the optimisers and
        the step count from a checkpoint; -> the epoch to start at (the
        saved ``extra.epoch`` + 1)."""
        with self._full_state():
            self.step = load_state(path, self.system)
        _, extra = load_config(path)
        return int(extra.get("epoch", -1)) + 1

    def save(self, path, extra: dict) -> None:
        """Rank 0 writes the whole state (every rank joins the gather)."""
        with self._full_state():
            if self.is_main:
                save_checkpoint(path, self.system, self.cfg, self.lang,
                                self.speaker, extra=extra, step=self.step)

    def fit(self, epochs: Optional[int] = None, save_path=None,
            eval_every: int = 1, log_every: int = 0,
            resume_from: Optional[str] = None,
            render_every: int = 0) -> list[dict]:
        """Train ``epochs`` epochs (the config's by default), or the rest
        of them after ``resume_from``; -> the history rows.  Epochs
        divisible by ``eval_every`` evaluate first (a history row, best
        tracking, tensorboard ``val/`` scalars), and the run ends with an
        evaluation; ``log_every`` N reads and logs the train metrics every
        N global iterations (``train_epoch``).  With ``render_every`` N,
        every N-th epoch renders a sample first."""
        epochs = epochs or self.cfg.epochs
        save_path = Path(save_path or self.cfg.model_save_path)
        start_epoch = 0
        if resume_from:
            start_epoch = self.resume(resume_from)
            logging.info(f"resumed from {resume_from} at epoch "
                         f"{start_epoch}")
        save_path.mkdir(parents=True, exist_ok=True)
        history_path = save_path / "history.jsonl"
        if self.is_main and not resume_from and history_path.exists():
            history_path.unlink()   # a fresh run starts a fresh trajectory
        history = []

        def record(val: dict, epoch_no: int):
            row = {"epoch": epoch_no, **{k: float(v) for k, v in val.items()}}
            history.append(row)
            if self.is_main:
                with open(history_path, "a") as f:
                    f.write(json.dumps(row) + "\n")

        self.global_iter = 0
        self.log_every = log_every
        if self.profile_dir is not None:
            self._start_profile()
        try:
            for epoch in range(start_epoch, epochs):
                if epoch % eval_every == 0:
                    # evaluation first (train.py:190)
                    val = self.validate(epoch)
                    record(val, epoch)
                    if self.tb is not None:
                        for k, v in val.items():
                            self.tb.add_scalar(f"val/{k}", v, epoch)
                    self._track_best(val, epoch, save_path)
                if epoch % 10 == 0 and epoch > 0:
                    self.save(save_path / f"checkpoint_{epoch:03d}",
                              {"epoch": epoch - 1})
                if (render_every and epoch % render_every == 0
                        and self.cfg.model != "gesture_autoencoder"
                        and self.cfg.save_result_video):
                    with self._full_state(state=False):
                        if self.is_main:
                            self._render(epoch, save_path)
                self.train_epoch(epoch)
        finally:
            # fewer than six steps: the trace holds the steps it recorded
            self._stop_profile()
        if self.tb is not None:
            self.tb.flush()

        val = self.validate(epochs)
        record(val, epochs)
        self._track_best(val, epochs, save_path)
        self.save(save_path / "checkpoint_final", {"epoch": epochs - 1})
        return history

    def _track_best(self, val: dict, epoch: int, save_path: Path) -> None:
        """Per-key best values; the selection key's best saves
        checkpoint_best (train.py:174-243)."""
        select_key = "frechet" if "frechet" in val else "loss"
        for k, v in val.items():
            if k in self.best_values:
                prev = self.best_values[k][0]
                if not (v > prev if k == "diversity" else v < prev):
                    continue
            self.best_values[k] = (v, epoch)
            if k == select_key:
                self.save(save_path / "checkpoint_best",
                          {"epoch": epoch, "val": val})
                logging.info(f"  [BEST] {k} = {v:.4f} @ epoch {epoch}")
