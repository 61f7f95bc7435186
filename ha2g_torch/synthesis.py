"""Sliding-window gesture synthesis (the port of ha2g_tpu/synthesis.py).

Long audio is processed in n_poses-frame windows with stride
n_poses - n_pre_poses; each window is seeded with the last n_pre frames of
the previous window's output, and the n_pre overlapping frames are linearly
cross-faded (reference synthesize.py:36-209, synthesize_hierarchy.py:
36-215).  ``SlidingWindowSynthesizer`` holds the window loop; a subclass
gives one window's step: ``HierarchySynthesizer`` (the audio encoder on
the window's spectrogram, then the level cascade), ``S2GSynthesizer``
(the speech2gesture generator on the spectrogram window),
``MultimodalSynthesizer`` (the multimodal_context generator on the raw
waveform window), ``Seq2SeqSynthesizer`` (the seq2seq net on the window's
SOS..EOS word sequence, teacher-seeded with the carry; the clip is then
smoothed across window joints, ``polyfit_smooth``) and
``EmbedSynthesizer`` (joint_embedding decoding from the speech latent of
the window's words and raw waveform) and ``DiffusionSynthesizer``
(DiffGesture's guided denoising chain on the raw waveform window, each
window's chain a CUDA graph's replay on the card).  ``make_synthesizer``
picks by the config's model.

The hierarchy has a second loop that computes the same thing,
``generate_fused`` (``prepare_fused`` + ``run_fused``): the audio encoder
does not depend on the carry, so it runs once over all windows at W-fold
batch; the cascade, carry and cross-fade then run per window.
``run_fused`` can take the batch in chunks (pinned staging, an upload and
a download stream beside the compute stream) and pull float16.  On the
card its per-window cascade is captured once as a CUDA graph and replayed
window after window (``_CascadeGraph``).

Every GRU recurrence goes through kernel B1 on CUDA.  The speaker-z noise
comes from a ``torch.Generator`` (seed 0 when none is given), drawn in
window order (and level order) by every loop.

``GestureStream`` (``SlidingWindowSynthesizer.stream``) runs the window
step of a spectrogram-windowed model on audio that arrives in chunks, one
window behind the live edge; ``fade_out_to_mean`` is the reference's
quadratic fade to the mean pose.  Every entry point runs under
``torch.inference_mode``, which is per thread: the serving layer calls
them from several threads.
"""

from __future__ import annotations

import copy
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ha2g_torch import kernels
from ha2g_torch.config import Config
from ha2g_torch.data.dataset import spectrogram_length_for
from ha2g_torch.data.vocab import EOS_TOKEN, SOS_TOKEN, Vocab
from ha2g_torch.ops.mel import (HOP, N_FFT, batched_log_mel,
                                batched_log_mel_i16, batched_log_mel_mulaw,
                                log_mel_abs, pcm_to_float_np)
from ha2g_torch.ops.precision import resolve_dtype
from ha2g_torch.parallel.mesh import batch_part
from ha2g_torch.skeleton import SkeletonSpec
from ha2g_torch.train.cascade import run_cascade
from ha2g_torch.utils.spans import span

SR = 16000
# the word-sequence width of a window (the JAX package's fixed 32)
WORD_SEQ_WIDTH = 32


def _mel_any(audio, device: torch.device) -> torch.Tensor:
    """Log-mel of float32 audio, int16 PCM or uint8 mu-law, a host array or
    a tensor (on ``device`` already, or moved there); the compact formats
    are uploaded as they are and decoded on the device."""
    t = audio if isinstance(audio, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(audio))
    t = t.to(device)
    if t.dtype == torch.int16:
        return batched_log_mel_i16(t)
    if t.dtype == torch.uint8:
        return batched_log_mel_mulaw(t)
    return batched_log_mel(t)


def _pull_dtype(out_dtype) -> torch.dtype:
    """run_fused's ``out_dtype``: None or float32, or float16 for the
    half-size pull."""
    if out_dtype is None or np.dtype(out_dtype) == np.float32:
        return torch.float32
    if np.dtype(out_dtype) == np.float16:
        return torch.float16
    raise ValueError(f"out_dtype must be float32 or float16, got {out_dtype}")


def _window_layout(cfg: Config, clip_seconds: float):
    unit_time = cfg.n_poses / cfg.motion_resampling_framerate
    stride_time = (cfg.n_poses - cfg.n_pre_poses) / \
        cfg.motion_resampling_framerate
    if clip_seconds < unit_time:
        num = 1
    else:
        num = math.ceil((clip_seconds - unit_time) / stride_time) + 1
    return unit_time, stride_time, num


def frame_aligned_word_indices(words, start_time, end_time, n_frames,
                               lang: Vocab) -> np.ndarray:
    """One word index per pose frame (synthesize_hierarchy.py:100-113)."""
    ext = np.zeros(n_frames, dtype=np.int64)
    frame_duration = (end_time - start_time) / n_frames
    for w in words:
        if w[1] < start_time or w[1] > end_time:
            continue
        idx = max(0, int(np.floor((w[1] - start_time) / frame_duration)))
        if idx < n_frames:
            ext[idx] = lang.get_word_index(w[0])
    return ext


def word_seq_indices(words, start_time, end_time, lang: Vocab,
                     max_words: int = WORD_SEQ_WIDTH) -> np.ndarray:
    """The SOS..EOS token sequence of one window's words
    (synthesize_hierarchy.py:102-111; JAX synthesis.py:82)."""
    seq = [SOS_TOKEN]
    for w in words:
        if start_time <= w[1] <= end_time:
            seq.append(lang.get_word_index(w[0]))
    seq.append(EOS_TOKEN)
    return np.asarray(seq[:max_words], np.int64)


def _cross_fade(prev_tail: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Linear blend over the n_pre overlap (synthesize_hierarchy.py:153-162)."""
    n = head.shape[1]
    j = torch.arange(n, device=head.device, dtype=head.dtype).view(1, n, 1)
    return prev_tail * (n - j) / (n + 1) + head * (j + 1) / (n + 1)


def _graphable(device: torch.device, generator, gens) -> bool:
    """Whether the fused cascade can run as a CUDA graph: on the card, the
    levels in eval mode (a graph keeps the mode it was captured in), and
    the speaker-z noise drawn from a generator on the same device, or none
    drawn (no level with a speaker z)."""
    if device.type != "cuda" or any(g.training for g in gens):
        return False
    return (_indexed(generator.device) == device
            or all(g.z_type == "none" for g in gens))


def _indexed(device: torch.device) -> torch.device:
    """``device`` with the current CUDA device's index where it names
    none (a ``torch.Generator("cuda")`` does not)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _CascadeGraph:
    """One CUDA graph of a step function at one key, captured from ``step``
    and replayed for every later call at that key: a hierarchy window's
    level cascade (key: batch rows, device, compute dtype), or a diffusion
    window's whole denoising chain (the same key).

    ``step(*inputs, generator) -> tensor``: static buffers hold its inputs
    (for the cascade ``text_w``, ``blend_w``, the carry ``tail`` and
    ``vids``; for the chain the window's condition) and its output; a
    replay copies the call's inputs in, launches the graph and returns a
    copy of the output, so the next replay may overwrite it.  Whatever
    noise the step draws comes from a generator registered with the graph:
    its state is set from the caller's generator before the replay and
    written back after it, so a replay draws the numbers, and leaves the
    caller's generator where, the eager step would.  The graph reads the
    weights by address: the live parameters, cast inside the step as the
    eager step casts them, so an in-place update (``load_state_dict``)
    reaches the next replay, and a module replaced by another does not (the
    graph keeps ``step``, and with it the modules it captured, alive).
    ``warmup`` runs the step once op by op on the capture stream with the
    graph's own generator before the capture, for a step whose kernels
    have not run on the device yet (the hierarchy's first window runs op
    by op before its capture, and needs none).

    The graphs of one synthesizer and device share one memory pool and one
    lock: a replay holds the lock from its copies to its output's copy,
    and its stream waits on the last replay's ``free`` event first, so
    replays of the pool never overlap, whatever thread or stream calls."""

    def __init__(self, step, inputs, shared: dict, warmup: bool = False):
        device = inputs[0].device
        self.step, self.shared = step, shared
        self.inputs = [x.clone() for x in inputs]
        self.generator = torch.Generator(device)
        if warmup:
            stream = shared["stream"]
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                step(*self.inputs, self.generator)
            torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        with kernels.captured_launches() as self.launches, torch.cuda.graph(
                self.graph, pool=shared["pool"], stream=shared["stream"],
                capture_error_mode="thread_local"):
            self.out = step(*self.inputs, self.generator)

    def __call__(self, inputs, generator) -> torch.Tensor:
        sync = _indexed(generator.device) == self.generator.device
        with self.shared["lock"]:
            stream = torch.cuda.current_stream(self.out.device)
            stream.wait_event(self.shared["free"])
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            if sync:
                self.generator.set_state(generator.get_state())
            self.graph.replay()
            if sync:
                generator.set_state(self.generator.get_state())
            out = self.out.clone()
            self.shared["free"].record(stream)
        kernels.add_launches(self.launches)
        return out


class SlidingWindowSynthesizer:
    """The window loop over a training system whose parameters are
    ``state`` (JAX synthesis.py:94-228); a subclass gives ``window_step``
    and says which inputs it reads: the spectrogram window ``spec_w``
    (``uses_spec``) and / or the raw waveform window ``audio_w``
    (``uses_audio``)."""

    uses_spec = True
    uses_audio = False
    # the window's SOS..EOS word sequence ("word_seq" (B, 32), zero-padded,
    # and "word_lengths" (B,))
    uses_word_seq = False
    # cubic smoothing across window joints after the loop (seq2seq)
    smooth = False
    # the span around each window of ``generate`` (args: the window), if any
    window_span: Optional[str] = None

    def __init__(self, system, state: dict):
        system.load_state_dict(state, strict=True)
        system.eval()
        self.system = system
        self.cfg: Config = system.cfg
        self.spec: SkeletonSpec = self.cfg.skeleton
        self.device = system.device
        self.dtype = resolve_dtype(self.cfg.compute_dtype)
        # run_fused's model replicas and copy streams by device
        self._replicas: dict = {}
        self._streams: dict = {}

    @staticmethod
    def _generator(generator):
        return generator if generator is not None \
            else torch.Generator().manual_seed(0)

    def window_step(self, inputs: dict, generator) -> torch.Tensor:
        """One window: inputs {"text_w" (B, T), "carry" (B, n_pre,
        pose_dim), "vids" (B,), "spec_w" (B, 128, S) and / or "audio_w"
        (B, n) and / or "word_seq" (B, 32) with "word_lengths" (B,)} as
        tensors on the device -> float32 (B, T, pose_dim)."""
        raise NotImplementedError

    @torch.inference_mode()
    def run_window(self, inputs: dict, generator: torch.Generator
                   ) -> np.ndarray:
        """``window_step`` on host arrays (numpy, the same keys) -> float32
        numpy (B, T, pose_dim).  The stream's window call, and the one the
        serving layer batches."""
        dev = self.device
        t = {k: torch.as_tensor(v, device=dev).long()
             if k in ("text_w", "vids", "word_seq", "word_lengths")
             else torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in inputs.items()}
        return self.window_step(t, generator).cpu().numpy()

    def _text_windows(self, words_per_clip, lang, num_sub, unit_time,
                      stride_time) -> torch.Tensor:
        text = np.stack([
            np.stack([frame_aligned_word_indices(
                w, i * stride_time, i * stride_time + unit_time,
                self.cfg.n_poses, lang) for w in words_per_clip])
            for i in range(num_sub)])                       # (W, B, T)
        return torch.from_numpy(text).to(self.device)

    def _word_seqs(self, words_per_clip, lang, start, end) -> dict:
        seqs = [word_seq_indices(w, start, end, lang)
                for w in words_per_clip]
        padded = np.zeros((len(seqs), WORD_SEQ_WIDTH), np.int64)
        for b, seq in enumerate(seqs):
            padded[b, :len(seq)] = seq
        return {"word_seq": torch.from_numpy(padded).to(self.device),
                "word_lengths": torch.as_tensor(
                    [len(seq) for seq in seqs], device=self.device)}

    @torch.inference_mode()
    def generate(self, audio: np.ndarray, words_per_clip: Sequence,
                 lang: Vocab, vids: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 fade_out: bool = False) -> np.ndarray:
        """audio (B, n_samples) float32, int16 or uint8 mu-law;
        words_per_clip: B lists of (word, start, end); vids (B,) ->
        (B, total_frames, pose_dim) float32.

        Spectrogram windows are sliced from the whole clip's log-mel (the
        last one edge-padded); raw-waveform windows start at
        floor(start / clip * n_samples), are int(unit_time * 16000)
        samples long and the last one is zero-padded (int16 / mu-law
        audio is decoded on the host first).  seq2seq's clip is smoothed
        across window joints (``polyfit_smooth``).  ``fade_out`` appends the
        fade to the mean pose (``fade_out_to_mean``) over the last
        window's zero padding, 0 s for a spectrogram model."""
        cfg = self.cfg
        generator = self._generator(generator)
        if self.uses_audio:
            audio = pcm_to_float_np(np.asarray(audio))
        B, n_samples = np.shape(audio)
        clip_seconds = n_samples / SR
        unit_time, stride_time, num_sub = _window_layout(cfg, clip_seconds)
        if self.uses_spec:
            spec_len = spectrogram_length_for(cfg.n_poses,
                                              cfg.motion_resampling_framerate)
            full_spec = _mel_any(audio, self.device)
            S_total = full_spec.shape[2]
        if self.uses_audio:
            audio_len = int(unit_time * SR)
            wav = torch.from_numpy(np.ascontiguousarray(audio, np.float32)) \
                .to(self.device)
        text_all = self._text_windows(words_per_clip, lang, num_sub,
                                      unit_time, stride_time)
        vids_t = torch.as_tensor(np.asarray(vids), device=self.device).long()
        n = cfg.n_pre_poses
        end_padding = 0.0

        pieces = []
        carry = torch.zeros((B, n, self.spec.pose_dim), device=self.device)
        for i in range(num_sub):
            with span(self.window_span, i):
                inputs = {"text_w": text_all[i], "carry": carry,
                          "vids": vids_t}
                if self.uses_spec:
                    s0 = math.floor(i * stride_time / clip_seconds * S_total)
                    s1 = s0 + spec_len
                    spec = full_spec if s1 <= S_total else F.pad(
                        full_spec, (0, s1 - S_total), mode="replicate")
                    inputs["spec_w"] = spec[:, :, s0:s1]
                if self.uses_audio:
                    a0 = math.floor(i * stride_time / clip_seconds * n_samples)
                    aw = wav[:, a0:a0 + audio_len]
                    if aw.shape[1] < audio_len:
                        if i == num_sub - 1:
                            end_padding = (audio_len - aw.shape[1]) / SR
                        aw = F.pad(aw, (0, audio_len - aw.shape[1]))
                    inputs["audio_w"] = aw
                if self.uses_word_seq:
                    inputs.update(self._word_seqs(
                        words_per_clip, lang, i * stride_time,
                        i * stride_time + unit_time))
                out = self.window_step(inputs, generator)
                carry = out[:, -n:]
                if pieces:
                    last = pieces[-1]
                    pieces[-1] = last[:, :-n]
                    out = torch.cat([_cross_fade(last[:, -n:], out[:, :n]),
                                     out[:, n:]], dim=1)
                pieces.append(out)
        result = torch.cat(pieces, dim=1).cpu().numpy()
        if self.smooth:
            result = np.stack([polyfit_smooth(r, cfg) for r in result])
        if fade_out:
            result = np.stack([fade_out_to_mean(r, cfg, end_padding)
                               for r in result])
        return result

    def stream(self, lang: Vocab, vid: int,
               total_seconds: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               db_ref: Optional[float] = None,
               executor=None) -> "GestureStream":
        """A live synthesis stream over one audio source (GestureStream);
        spectrogram-windowed models only (hierarchy, speech2gesture)."""
        return GestureStream(self, lang, vid, total_seconds=total_seconds,
                             generator=generator, db_ref=db_ref,
                             executor=executor)


class _GraphedSynthesizer(SlidingWindowSynthesizer):
    """A synthesizer whose window work may replay CUDA graphs
    (``_CascadeGraph``): its graphs by key, what the graphs of one device
    share (pool, capture stream, lock, free event), and a counter of the
    work "eager" (run op by op), "replayed" (in a graph's replay) and
    "captured" (in graphs captured)."""

    def __init__(self, system, state: dict):
        super().__init__(system, state)
        self._graphs: dict = {}
        self._graph_shared: dict = {}
        self._lock = threading.Lock()
        self._counts = {"eager": 0, "replayed": 0, "captured": 0}

    def _capture(self, key, step, inputs, warmup: bool = False) -> bool:
        """Capture ``step`` on ``inputs`` as the graph of ``key`` unless
        another thread did; -> whether this call captured it."""
        shared = self._shared(inputs[0].device)
        with shared["lock"]:        # one capture at a time
            if key in self._graphs:
                return False
            self._graphs[key] = _CascadeGraph(step, inputs, shared, warmup)
            return True

    def _shared(self, device: torch.device) -> dict:
        """What the graphs on ``device`` share (see ``_CascadeGraph``)."""
        with self._lock:
            if device not in self._graph_shared:
                self._graph_shared[device] = {
                    "pool": torch.cuda.graph_pool_handle(),
                    "stream": torch.cuda.Stream(device),
                    "lock": threading.Lock(), "free": torch.cuda.Event()}
            return self._graph_shared[device]

    def _count(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self._counts[kind] += n


class HierarchySynthesizer(_GraphedSynthesizer):
    """A HierarchySystem's window: the audio encoder on the window's
    spectrogram, then the level cascade (synthesize_hierarchy.py:127-146);
    besides the window loop, a fused loop (``generate_fused``).

    ``window_counts`` counts the fused loop's windows: "eager" (run op by
    op), "replayed" (a CUDA graph's replay) and "captured" (graphs
    captured)."""

    def __init__(self, system, state: dict):
        super().__init__(system, state)
        self.window_counts = self._counts

    def window_step(self, inputs, generator):
        vids = inputs["vids"]
        blend = self.system.audio(inputs["spec_w"], vids, self.dtype)[-1]
        return self._cascade_step(inputs["text_w"], blend, inputs["carry"],
                                  vids, generator)

    def _cascade_step(self, text_w, blend_w, carry, vids, generator,
                      gens=None):
        """Level cascade on precomputed blend features for one window
        (``gens``: the level generators, the system's by default)."""
        cfg = self.cfg
        B = text_w.shape[0]
        target = torch.zeros((B, cfg.n_poses, self.spec.pose_dim),
                             device=carry.device)
        target[:, :cfg.n_pre_poses] = carry
        gens = self.system.gens if gens is None else gens
        outs, _, _, _, _ = run_cascade(gens, self.spec, target, text_w,
                                       blend_w, vids, cfg.n_pre_poses,
                                       self.dtype, generator)
        return outs[-1].float()

    # ---- fused loop -------------------------------------------------------
    def prepare_fused(self, words_per_clip, lang: Vocab, vids: np.ndarray,
                      n_samples: int,
                      generator: Optional[torch.Generator] = None) -> dict:
        """Host-side plan of the fused loop: window layout, per-window word
        indices and spectrogram offsets.  Depends on the transcripts and the
        clip length only, not on the samples."""
        with span("ha2g.synth.plan"):
            cfg = self.cfg
            clip_seconds = n_samples / SR
            unit_time, stride_time, num_sub = _window_layout(cfg, clip_seconds)
            spec_len = spectrogram_length_for(cfg.n_poses,
                                              cfg.motion_resampling_framerate)
            # frame count of the centre-padded mel front-end
            S_total = n_samples // HOP + 1
            s0_all = [math.floor(i * stride_time / clip_seconds * S_total)
                      for i in range(num_sub)]
            return {"text_all": self._text_windows(words_per_clip, lang,
                                                   num_sub, unit_time,
                                                   stride_time),
                    "s0_all": s0_all,
                    "vids": torch.as_tensor(np.asarray(vids),
                                            device=self.device).long(),
                    "generator": self._generator(generator),
                    "num_sub": num_sub, "spec_len": spec_len,
                    "S_total": S_total, "pad_to": max(s0_all) + spec_len}

    @torch.inference_mode()
    def run_fused(self, audio: np.ndarray, plan: dict, chunk: int = 0,
                  out_dtype=None,
                  devices: Optional[Sequence] = None) -> np.ndarray:
        """Device part of the fused loop: mel front-end, audio encoder over
        all windows at once, then the per-window cascade, carry and
        cross-fade, and the pull to the host.  ``plan`` from
        ``prepare_fused``; -> (B, total_frames, pose_dim) float32.

        ``chunk`` > 0 (and < B) runs consecutive chunks of ``chunk`` clips,
        the last one possibly smaller (JAX synthesis.py:371-420).  On the
        card each chunk is staged in pinned host memory and goes up with
        ``non_blocking`` copies on an upload stream; the compute stream
        waits on the chunk's upload event, then runs its mel front-end,
        encoder and window cascade; its poses go down into pinned host
        memory on a download stream once the compute stream's event says
        they are done.  Chunk i+1's upload is queued before chunk i's
        compute, so transfers overlap compute; the call synchronises once,
        at the end, and concatenates the chunks in order.  The card holds
        one chunk's activations at a time.

        ``out_dtype=np.float16`` casts the poses on the device and pulls
        half the bytes; the result is float32 either way.

        On the card, without ``devices``, and where the plan's generator
        lies on the synthesizer's device (or no level draws noise), the
        window cascade runs as a CUDA graph (``_CascadeGraph``): the first
        window at a new (batch rows, device, compute dtype) runs op by op
        and the graph is captured after it; every later window, in this
        call or a later one, replays it.  The replays give the op-by-op
        numbers bit for bit, noise included.  Everything else (CPU
        tensors, a CPU generator, ``devices``) runs the same cascade op by
        op.

        The speaker-z noise is drawn from the plan's generator chunk after
        chunk, window by window, at the chunk's batch: chunking changes
        the draw exactly as synthesizing the clips in smaller batches
        would (the JAX package's caveat; with z pinned at mu the chunks
        give the unchunked result), and the generator ends after the last
        chunk's draws.

        ``devices`` (the JAX package's ``mesh=``): each chunk (the whole
        batch without ``chunk``) splits into len(devices) contiguous equal
        parts (every chunk must divide), each run on its device's replica
        of the model (made once, cached; the synthesizer's own modules on
        its own device) from a thread of its own.  Each part draws the
        speaker-z noise of the chunk's batch from a copy of the plan's
        generator and keeps its rows (``parallel.mesh.batch_part``), so the
        output equals the single-device call, and the plan's generator
        ends where that call leaves it.  This is the counterpart of JAX's
        API, not a way to speed a call up: the path is bound by the host's
        dispatch, which the threads share under one interpreter lock (two
        devices on one H100 took 3.9-4.4x one call, PERF.md); its speed
        over separate cards, or with each part in a process of its own,
        is not measured."""
        B = np.shape(audio)[0]
        pull = _pull_dtype(out_dtype)
        step = B if chunk <= 0 or chunk >= B else chunk
        chunks = [slice(i, min(i + step, B)) for i in range(0, B, step)]
        if devices:
            n = len(devices)
            for rows in chunks:
                if (rows.stop - rows.start) % n:
                    raise ValueError(
                        f"a batch of {rows.stop - rows.start} clips does "
                        f"not split over {n} devices")
            outs = [self._run_devices(audio[rows], plan, rows, devices, pull)
                    for rows in chunks]
        else:
            outs = self._run_chunks(audio, plan, chunks, pull)
        with span("ha2g.synth.pull"):
            # a copy: the result holds none of the pinned buffers
            return np.concatenate(outs, axis=0).astype(np.float32, copy=False)

    def _run_chunks(self, audio, plan, chunks, pull) -> list:
        """The chunks on the synthesizer's own device, pipelined on the
        card (see ``run_fused``) -> their host arrays in ``pull``."""
        modules = self._replica(self.device)
        gen = plan["generator"]

        def compute(x, rows):
            return self._fused_device(x, plan["text_all"][:, rows],
                                      plan["vids"][rows], plan, gen,
                                      modules, graphs=True).to(pull)

        if self.device.type != "cuda":
            return [compute(audio[rows], rows).numpy() for rows in chunks]
        dev = self.device
        main = torch.cuda.current_stream(dev)
        up, down = self._copy_streams(dev)
        # every pinned buffer lives until the closing synchronise
        hosts, uploads, pulled = [], [], []

        def upload(rows):
            with span("ha2g.synth.upload"):
                src = torch.from_numpy(np.ascontiguousarray(audio[rows]))
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True).copy_(src)
                with torch.cuda.stream(up):
                    x = host.to(dev, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(up)
            hosts.append(host)
            uploads.append((x, ready))

        upload(chunks[0])
        for k, rows in enumerate(chunks):
            if k + 1 < len(chunks):
                upload(chunks[k + 1])
            x, ready = uploads[k]
            main.wait_event(ready)
            x.record_stream(main)   # allocated on the upload stream
            out = compute(x, rows)
            with span("ha2g.synth.pull"):
                done = torch.cuda.Event()
                done.record(main)
                host = torch.empty(out.shape, dtype=pull, pin_memory=True)
                with torch.cuda.stream(down):
                    down.wait_event(done)
                    host.copy_(out, non_blocking=True)
                out.record_stream(down)
            uploads[k] = None
            pulled.append(host)
        with span("ha2g.synth.pull"):
            down.synchronize()
            return [h.numpy() for h in pulled]

    def _copy_streams(self, device: torch.device):
        """(upload, download) side streams of ``device``, made once."""
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device),
                                     torch.cuda.Stream(device))
        return self._streams[device]

    def _run_devices(self, audio, plan, rows, devices, pull) -> np.ndarray:
        """The clips ``rows`` of the plan split over ``devices`` (see
        ``run_fused``) -> host array in ``pull``."""
        n, B = len(devices), np.shape(audio)[0]
        b = B // n
        replicas = [self._replica(torch.device(d)) for d in devices]
        text, vids = plan["text_all"][:, rows], plan["vids"][rows]
        gen = plan["generator"]
        start = gen.get_state()
        outs, gens, errors = [None] * n, [None] * n, []

        def part(i):
            try:
                g = torch.Generator(gen.device)
                g.set_state(start)
                r = slice(i * b, (i + 1) * b)
                with torch.inference_mode(), batch_part(i, n):
                    outs[i] = self._fused_device(
                        audio[r], text[:, r], vids[r], plan, g, replicas[i]
                    ).to(pull).cpu().numpy()
                gens[i] = g
            except BaseException as e:  # noqa: BLE001 (raised below)
                errors.append(e)

        threads = [threading.Thread(target=part, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        gen.set_state(gens[0].get_state())
        return np.concatenate(outs, axis=0)

    def _replica(self, device: torch.device):
        """(audio encoder, level generators) on ``device``: the system's
        own on its device, else a copy made once."""
        if device == self.device:
            return self.system.audio, self.system.gens
        if device not in self._replicas:
            with torch.inference_mode(False):
                self._replicas[device] = tuple(
                    copy.deepcopy(m).to(device).eval()
                    for m in (self.system.audio, self.system.gens))
        return self._replicas[device]

    def _fused_device(self, audio, text_all, vids, plan, generator,
                      modules, graphs: bool = False) -> torch.Tensor:
        """The fused loop on audio (float32, int16 or uint8 mu-law; a host
        array, or a tensor on the modules' device) -> the poses on that
        device, float32 (B, total_frames, pose_dim).  ``graphs``: the
        single-device path, where the cascade may run as a CUDA graph
        (``run_fused``)."""
        audio_enc, gens = modules
        device = next(audio_enc.parameters()).device
        cfg = self.cfg
        n, T = cfg.n_pre_poses, cfg.n_poses
        W, spec_len = plan["num_sub"], plan["spec_len"]
        with span("ha2g.synth.mel"):
            full_spec = _mel_any(audio, device)
            if full_spec.shape[2] != plan["S_total"]:
                raise ValueError(f"audio gives {full_spec.shape[2]} mel "
                                 f"frames, the plan expects {plan['S_total']}")
            if plan["pad_to"] > plan["S_total"]:
                full_spec = F.pad(full_spec,
                                  (0, plan["pad_to"] - plan["S_total"]),
                                  mode="replicate")
            spec_all = torch.stack([full_spec[:, :, s0:s0 + spec_len]
                                    for s0 in plan["s0_all"]])  # (W, B, 128, S)
        B = full_spec.shape[0]
        vids, text_all = vids.to(device), text_all.to(device)
        blend = audio_enc(spec_all.flatten(0, 1), vids.repeat(W),
                          self.dtype)[-1]                    # (L, W*B, T, 32)
        blend_all = blend.unflatten(1, (W, B)).transpose(0, 1)  # (W, L, B, ..)

        graphs = graphs and _graphable(device, generator, gens)
        pieces = []
        tail = torch.zeros((B, n, self.spec.pose_dim), device=device)
        for w in range(W):
            with span("ha2g.synth.window", w):
                out = self._window((text_all[w], blend_all[w], tail, vids),
                                   generator, gens, graphs, w)
                head = out[:, :n] if w == 0 else _cross_fade(tail, out[:, :n])
                tail = out[:, -n:]
                # windows 0..W-2 keep their first T-n frames, the last all T
                pieces.append(torch.cat(
                    [head, out[:, n:T if w == W - 1 else T - n]], dim=1))
        return torch.cat(pieces, dim=1)

    def _window(self, inputs, generator, gens, graphs: bool, w: int):
        """One window's cascade on ``inputs`` (text_w, blend_w, tail,
        vids): the key's graph replayed where there is one; else op by op,
        and with ``graphs`` the key's graph captured after it."""
        text_w = inputs[0]
        key = (text_w.shape[0], text_w.device, self.dtype)
        graph = self._graphs.get(key) if graphs else None
        if graph is not None:
            with span("ha2g.synth.replay", w):
                out = graph(inputs, generator)
            self._count("replayed")
            return out
        out = self._cascade_step(*inputs, generator, gens)
        self._count("eager")
        if graphs:
            def step(text_w, blend_w, tail, vids, g):
                return self._cascade_step(text_w, blend_w, tail, vids, g,
                                          gens)
            if self._capture(key, step, inputs):
                self._count("captured")
        return out

    @torch.inference_mode()
    def generate_fused(self, audio: np.ndarray, words_per_clip, lang: Vocab,
                       vids: np.ndarray,
                       generator: Optional[torch.Generator] = None,
                       devices: Optional[Sequence] = None) -> np.ndarray:
        """One-plan variant of generate() (identical windowing and
        cross-fade); ``devices`` as ``run_fused``'s."""
        plan = self.prepare_fused(words_per_clip, lang, vids,
                                  np.shape(audio)[1], generator)
        return self.run_fused(audio, plan, devices=devices)


class MultimodalSynthesizer(SlidingWindowSynthesizer):
    """A multimodal_context generator per window, on the raw waveform
    window (synthesize.py:106-119)."""

    uses_spec = False
    uses_audio = True

    def window_step(self, inputs, generator):
        cfg = self.cfg
        carry = inputs["carry"]
        B, n, D = carry.shape
        pre_seq = carry.new_zeros((B, cfg.n_poses, D + 1))
        pre_seq[:, :n, :D] = carry
        pre_seq[:, :n, D] = 1.0
        out = self.system.gen(pre_seq, inputs["text_w"], inputs["audio_w"],
                              inputs["vids"], self.dtype, generator)[0]
        return out.float()


class S2GSynthesizer(SlidingWindowSynthesizer):
    """A speech2gesture generator per window (synthesize.py:100-105)."""

    def window_step(self, inputs, generator):
        return self.system.gen(inputs["spec_w"], inputs["carry"],
                               self.dtype).float()


class Seq2SeqSynthesizer(SlidingWindowSynthesizer):
    """A seq2seq net per window on the window's word sequence, its first
    n_pre_poses frames teacher-forced with the carry (synthesize.py:92-99);
    the clip is smoothed across window joints afterwards."""

    uses_spec = False
    uses_word_seq = True
    smooth = True

    def window_step(self, inputs, generator):
        cfg = self.cfg
        carry = inputs["carry"]
        poses = carry.new_zeros((carry.shape[0], cfg.n_poses,
                                 self.spec.pose_dim))
        poses[:, :cfg.n_pre_poses] = carry
        return self.system(inputs["word_seq"], inputs["word_lengths"], poses,
                           self.dtype, generator)


class EmbedSynthesizer(SlidingWindowSynthesizer):
    """joint_embedding per window: decode from the speech latent of the
    window's words and raw waveform, the pre-poses taken from the carry
    (synthesize.py mode 'speech'; eval_embed in train_joint_embed.py:
    54-62).  The context latent is a draw around its mean, from the
    generator."""

    uses_spec = False
    uses_audio = True

    def window_step(self, inputs, generator):
        return self.system(inputs["text_w"], inputs["audio_w"],
                           inputs["carry"], None, input_mode="speech",
                           dtype=self.dtype, generator=generator)[-1]


class DiffusionSynthesizer(_GraphedSynthesizer):
    """DiffGesture's window (``models/diffusion.py``): the raw-waveform
    audio encoder and the condition from the carry, then the guided
    denoising chain from fresh noise to the window's poses; the window loop
    (carry, cross-fade) is ``generate``'s.

    On the card, where the generator lies on the synthesizer's device, a
    window's whole chain runs as a replay of one CUDA graph
    (``_CascadeGraph``) captured at the first window of a (batch rows,
    device, compute dtype) key, after one op-by-op run of the chain on the
    capture stream as a warm-up, so every window's steps, the first's too,
    are replays; the replays give the op-by-op numbers bit for bit, noise
    included.  CPU tensors or a CPU generator run the same chain op by
    op.

    ``step_counts`` counts denoising steps: "eager" (run op by op),
    "replayed" (in a graph's replay) and "captured" (in graphs
    captured)."""

    uses_spec = False
    uses_audio = True
    window_span = "ha2g.diffuse.window"

    def __init__(self, system, state: dict):
        super().__init__(system, state)
        self.step_counts = self._counts

    def window_step(self, inputs, generator):
        model = self.system
        with span("ha2g.diffuse.condition"):
            cond = model.condition(inputs["carry"], inputs["audio_w"],
                                   self.dtype)
        with span("ha2g.diffuse.chain", model.steps):
            return self._chain(cond, generator)

    def _chain(self, cond, generator) -> torch.Tensor:
        model, steps = self.system, self.system.steps
        dev = cond.device
        if dev.type != "cuda" or _indexed(generator.device) != dev:
            self._count("eager", steps)
            return model.sample(cond, generator, self.dtype)
        key = (cond.shape[0], dev, self.dtype)
        if key not in self._graphs:
            model.tables(dev, self.dtype)     # uploaded before the capture

            def step(cond, g):
                return model.sample(cond, g, self.dtype)
            if self._capture(key, step, (cond,), warmup=True):
                self._count("captured", steps)
        with span("ha2g.diffuse.replay", steps):
            out = self._graphs[key]((cond,), generator)
        self._count("replayed", steps)
        return out


SYNTHESIZERS = {"hierarchy": HierarchySynthesizer,
                "pose_diffusion": DiffusionSynthesizer,
                "multimodal_context": MultimodalSynthesizer,
                "speech2gesture": S2GSynthesizer,
                "seq2seq": Seq2SeqSynthesizer,
                "joint_embedding": EmbedSynthesizer}


def make_synthesizer(system, state: dict, low_latency: bool = False):
    """Synthesizer for ``system`` with parameters ``state`` (a state dict of
    the system's layout, e.g. ``system.state_dict()`` or the output of
    ``convert.system_state``).

    ``low_latency`` is kept for API parity with the JAX package, where it
    selects the Pallas recurrence of a hierarchy; here every recurrence on
    CUDA already runs kernel B1, so it selects nothing."""
    del low_latency
    cls = SYNTHESIZERS.get(system.cfg.model)
    if cls is None:
        raise ValueError(f"no synthesizer for model {system.cfg.model!r} "
                         f"(the synthesizing families: {sorted(SYNTHESIZERS)})")
    return cls(system, state)


class GestureStream:
    """Live synthesis over ONE audio stream (JAX synthesis.py:552-764).

    Window i reads the spectrogram slice [s0_i, s0_i + spec_len) and the
    previous window's carry, so gestures come out while the audio arrives,
    one window (n_poses frames, ~2.27 s) behind the live edge:

        stream = synth.stream(lang, vid=3)
        for chunk, new_words in source:          # any chunk sizes
            frames = stream.feed(chunk, words=new_words)   # (n_new, D)
        frames = stream.finish()

    * Window layout: with ``total_seconds`` known (file playback, TTS) the
      batch path's layout is used; unknown (live), window i starts at the
      sample-exact spec frame ``(i * stride_samples) // hop``, within one
      32 ms spec frame of the batch layout.
    * Mel frames: an interior frame sees only real samples, so frames are
      computed as the audio comes, from hop-aligned segments
      (``log_mel_abs(center=False)``); the reflect padding of the clip's
      two ends is taken on the host.  A segment's DFT product has another
      row count than the whole clip's, so a frame may differ from the
      batch path's in its last bits (the summation order of the product).
    * dB reference: librosa's ``ref=np.max`` is the whole clip's peak,
      unknown live; the stream applies the running peak over the frames
      so far (or ``db_ref``).  Once the clip's loudest frame has arrived,
      the features are the batch path's.
    * Words may arrive as they are recognised; a window uses the words
      known when it runs, and it runs one spec frame (~32 ms) before its
      nominal end.

    Window 0 emits its first n_poses - n_pre_poses frames; each later
    window emits the previous window's held-back n_pre_poses tail
    cross-faded with its own head (the batch path's blend), then its
    middle; ``finish`` emits the last tail.  A window's speaker-z noise is
    drawn from the stream's ``generator`` (CPU, seed 0 when None) in
    window order, so a stream draws what ``generate`` draws at batch 1.
    ``executor``, when given, replaces the window call:
    ``executor(inputs, generator) -> (1, n_poses, pose_dim)`` with
    ``inputs`` as for ``SlidingWindowSynthesizer.run_window``.  A model
    that is not spectrogram-windowed (multimodal_context, joint_embedding:
    the raw waveform; seq2seq: words alone) is refused, as in the JAX
    package.
    """

    def __init__(self, synth: SlidingWindowSynthesizer, lang: Vocab,
                 vid: int,
                 total_seconds: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 db_ref: Optional[float] = None, executor=None):
        if not synth.uses_spec or synth.uses_audio:
            raise ValueError("a stream drives spectrogram-windowed models")
        self.synth = synth
        self.cfg = cfg = synth.cfg
        self.lang = lang
        self.vid = int(vid)
        self.generator = SlidingWindowSynthesizer._generator(generator)
        self.unit_time, self.stride_time, _ = _window_layout(cfg, 1.0)
        self.spec_len = spectrogram_length_for(
            cfg.n_poses, cfg.motion_resampling_framerate)
        self.total_seconds = total_seconds
        if total_seconds is not None:
            n_total = int(round(total_seconds * SR))
            self._S_total = n_total // HOP + 1
            _, _, self._num_sub = _window_layout(cfg, n_total / SR)
        self._executor = executor
        self._buf = np.zeros(0, np.float32)
        self._words: list = []
        self._frames = np.zeros((128, 0), np.float32)   # absolute log-mel
        self._ref = -np.inf if db_ref is None else float(db_ref)
        self._next_w = 0
        self._carry = np.zeros((1, cfg.n_pre_poses, synth.spec.pose_dim),
                               np.float32)
        self._tail: Optional[np.ndarray] = None
        self._finished = False

    @property
    def n_samples(self) -> int:
        """Samples fed so far."""
        return len(self._buf)

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.synth.spec.pose_dim), np.float32)

    def _s0(self, i: int) -> int:
        if self.total_seconds is not None:
            return math.floor(i * self.stride_time / self.total_seconds
                              * self._S_total)
        return (i * int(round(self.stride_time * SR))) // HOP

    def _extend_frames(self, final: bool) -> None:
        """Grow the absolute log-mel frames from the buffer.  Frame k of the
        centred transform covers E[k*hop : k*hop + n_fft] of the signal E
        extended by n_fft/2 reflected samples at each end; the end's
        reflection (``final``) adds the last frame."""
        half = N_FFT // 2
        n = len(self._buf)
        have = self._frames.shape[1]
        want = n // HOP + (1 if final else 0)
        if want <= have or n <= half:
            return
        parts = [self._buf[1:half + 1][::-1], self._buf]
        if final:
            parts.append(self._buf[-2:-half - 2:-1])
        seg = np.concatenate(parts)[have * HOP:(want + 1) * HOP]
        dev = self.synth.device
        new = log_mel_abs(torch.from_numpy(seg).to(dev), center=False)
        self._frames = np.concatenate([self._frames, new.cpu().numpy()],
                                      axis=1)
        if self._frames.shape[1] != want:
            raise AssertionError(f"{self._frames.shape[1]} frames, want "
                                 f"{want}")
        self._ref = max(self._ref, float(self._frames.max()))

    def _run_window(self, i: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.n_pre_poses
        s0 = self._s0(i)
        s1 = s0 + self.spec_len
        fr = self._frames
        if s1 > fr.shape[1]:          # the last window: edge padding
            fr = np.pad(fr, ((0, 0), (0, s1 - fr.shape[1])), mode="edge")
        # float32, as the batch path subtracts and floors on the device
        spec_w = np.maximum(fr[:, s0:s1] - np.float32(self._ref),
                            np.float32(-80.0))
        start = i * self.stride_time
        text_w = frame_aligned_word_indices(
            self._words, start, start + self.unit_time, cfg.n_poses,
            self.lang)
        inputs = {"spec_w": spec_w[None], "text_w": text_w[None],
                  "carry": self._carry,
                  "vids": np.asarray([self.vid], np.int64)}
        run = self._executor or self.synth.run_window
        out = run(inputs, self.generator)
        self._carry = out[:, -n:]
        if self._tail is None:
            emit = out[0, :-n]
        else:
            head = _cross_fade(torch.from_numpy(self._tail)[None],
                               torch.from_numpy(out[:, :n]))[0].numpy()
            emit = np.concatenate([head, out[0, n:-n]], axis=0)
        self._tail = out[0, -n:]
        self._next_w = i + 1
        return emit

    def _ready(self, i: int) -> bool:
        """Are window i's spec frames all made of real samples?"""
        if self.total_seconds is not None and i >= self._num_sub:
            return False
        return (self._s0(i) + self.spec_len) * HOP <= len(self._buf)

    @torch.inference_mode()
    def feed(self, samples=None, words: Sequence = ()) -> np.ndarray:
        """Append audio (float32 in [-1, 1], int16 or uint8 mu-law, decoded
        on the host) and / or word timings; -> the frames that became
        final, (n_new, pose_dim), possibly none."""
        if self._finished:
            raise RuntimeError("stream already finished")
        if words:
            self._words.extend(words)
        if samples is not None:
            self._buf = np.concatenate([self._buf, pcm_to_float_np(
                np.atleast_1d(samples))])
        outs = []
        while self._ready(self._next_w):
            self._extend_frames(final=False)
            outs.append(self._run_window(self._next_w))
        return np.concatenate(outs, axis=0) if outs else self._empty()

    @torch.inference_mode()
    def finish(self) -> np.ndarray:
        """Run the remaining (edge-padded) windows on the whole buffer and
        emit the held-back tail."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._finished = True
        if len(self._buf) <= N_FFT // 2:
            # less audio than one reflect-padded frame
            return self._tail if self._tail is not None else self._empty()
        if self.total_seconds is None:
            self.total_seconds = len(self._buf) / SR
            self._S_total = len(self._buf) // HOP + 1
            _, _, self._num_sub = _window_layout(self.cfg, self.total_seconds)
        self._extend_frames(final=True)
        outs = []
        while self._next_w < self._num_sub:
            outs.append(self._run_window(self._next_w))
        if self._tail is not None:
            outs.append(self._tail)
        return np.concatenate(outs, axis=0) if outs else self._empty()


def polyfit_smooth(out_dir_vec: np.ndarray, cfg: Config) -> np.ndarray:
    """Cubic-polyfit smoothing across window joints of a seq2seq clip
    (reference synthesize.py:163-185; JAX synthesis.py:767).
    out_dir_vec: (total_frames, D)."""
    n_smooth = cfg.n_pre_poses
    stride = cfg.n_poses - cfg.n_pre_poses
    total = out_dir_vec.shape[0]
    num_sub = max((total - cfg.n_poses) // stride + 1, 1)
    out = out_dir_vec.copy()
    for i in range(num_sub):
        start = cfg.n_pre_poses + i * stride - n_smooth
        if start < 0:
            start, end = 0, n_smooth * 2
        else:
            end = start + n_smooth * 3
        y = out[start:end]
        if y.shape[0] < 4:
            continue
        x = np.arange(y.shape[0])
        coeffs = np.polyfit(x, y, 3)
        out[start:end] = np.stack(
            [np.poly1d(coeffs[:, k])(x) for k in range(y.shape[1])], axis=1)
    return out


def fade_out_to_mean(out_dir_vec: np.ndarray, cfg: Config,
                     end_padding_duration_s: float) -> np.ndarray:
    """Quadratic-fit fade to the mean pose over the zero-padded tail
    (reference synthesize_hierarchy.py:189-213; JAX synthesis.py:791)."""
    n_smooth = cfg.n_pre_poses
    fps = cfg.motion_resampling_framerate
    start = len(out_dir_vec) - int(end_padding_duration_s * fps)
    end = start + n_smooth * 2
    out = out_dir_vec
    if len(out) < end:
        out = np.pad(out, [(0, end - len(out)), (0, 0)], mode="constant")
    out[end - n_smooth:] = 0.0
    y = out[start:end]
    x = np.arange(y.shape[0])
    w = np.ones(len(y))
    w[0] = w[-1] = 5
    coeffs = np.polyfit(x, y, 2, w=w)
    out[start:end] = np.stack(
        [np.poly1d(coeffs[:, k])(x) for k in range(y.shape[1])], axis=1)
    return out
