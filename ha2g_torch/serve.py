"""Serving gesture synthesis from a checkpoint (the port of
ha2g_tpu/serve.py): a process that holds the warm model, micro-batches
concurrent requests, keeps live streams, and answers a plain HTTP/JSON API
(stdlib ``http.server``).

  python -m ha2g_torch.cli serve CHECKPOINT --port 8017 [--device cuda|cpu]

  POST /synthesize   {"audio": [..16 kHz samples..] | base64,
                      "encoding": "pcm_f32" (default) | "pcm_i16"
                                  | "pcm_mulaw" (G.711, a byte a sample),
                      "words": [["hello", 0.1, 0.4], ...], "vid": 0,
                      "fused": true,
                      "return_dtype": "f32" (default) | "f16"}
      -> {"dir_vec": base64, "dtype", "shape": [T, pose_dim], "fps",
          "covered_seconds", "truncated", "latency_ms"}
  GET  /healthz      -> {"ok": true, "model", "dataset", "pose_dim", "fps",
                         "max_clip_seconds"}
  GET  /stats        -> request, batch, error and stream counters
  POST /stream/open          {"vid": 0, "total_seconds": null | float}
      -> {"stream_id": ...}
  POST /stream/<id>/feed     {"audio", "encoding", "words", "return_dtype"}
      -> the frames that became final (possibly none)
  POST /stream/<id>/finish   {"return_dtype"} -> the last frames; closes it

Requests that arrive within ``batch_window_ms`` of each other are padded
with silence to the service's clip length and to the smallest batch
bucket of {1, 4, 8, max_batch} that holds them, and run as one call;
each response is cut to its own length.  The batch norms run in eval
mode, so a padding row does not change a real row.  With
``stream_batching``, ready windows of concurrent live streams are batched
the same way (``_WindowBatcher``).

Threads: the batching loop, the stream batcher and the HTTP handler
threads (which drive unbatched streams) all launch work on the card.
Every thread stays on the default CUDA stream, so the work of all threads
runs in the order it was queued and each host copy waits for what was
queued before it; kernel B1 launches on the calling thread's current
stream, which is that default stream.  The entry points of
``synthesis.py`` enter ``torch.inference_mode`` themselves (it is per
thread), and ``kernels.load`` builds a kernel once under a lock.

Serving must not die: a batch that fails answers each of its requests
with the error and counts it in ``stats["errors"]``; it is never retried
on the CPU or with a kernel's plain version.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Optional

import numpy as np
import torch

from ha2g_torch.ops.mel import pcm_to_float_np

SR = 16000
# the seed of the stream batcher's noise for a batch of k > 1 windows,
# with the batch's counter
BATCH_SEED = 0x57BA7C


@dataclass
class _Request:
    audio: np.ndarray            # (n_samples,) float32
    words: list
    vid: int
    fused: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    truncated_from: Optional[float] = None   # seconds sent, if clipped


@dataclass
class _WindowReq:
    inputs: dict                 # one stream's window inputs (batch 1)
    generator: torch.Generator   # the stream's noise
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


def _collect(q: Queue, stop: threading.Event, window: float, cap: int):
    """Block for a first item, then take more until ``window`` seconds
    pass or ``cap`` are taken; -> the items, or [] once ``stop`` is set."""
    while not stop.is_set():
        try:
            first = q.get(timeout=0.1)
        except Empty:
            continue
        items = [first]
        deadline = time.perf_counter() + window
        while len(items) < cap:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(q.get(timeout=remaining))
            except Empty:
                break
        return items
    return []


class _WindowBatcher:
    """Runs ready windows of concurrent live streams as one window call.
    A stream's window inputs have one shape (spec_w (128, S), text_w (T,),
    carry (n_pre, D), vid), so k windows pad to a batch bucket and run
    through the same ``run_window`` as a stream alone.

    Noise: a batch of one uses the stream's own generator, so a stream on
    an idle service equals unbatched streaming.  A batch of k > 1 draws
    from a generator seeded from (BATCH_SEED, batch counter), as if the
    windows' clips had been synthesized together, and leaves the streams'
    generators where they were."""

    def __init__(self, synth, buckets, window_ms: float, count):
        self.synth = synth
        self.buckets = list(buckets)
        self.window = window_ms / 1000.0
        self._count = count
        self._q: Queue[_WindowReq] = Queue()
        self._stop = threading.Event()
        self._counter = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ha2g-stream-batcher")
        self._thread.start()

    def run(self, inputs: dict, generator: torch.Generator) -> np.ndarray:
        """The streams' executor hook: blocks until the window ran."""
        if self._stop.is_set():
            raise RuntimeError("window batcher closed")
        req = _WindowReq(inputs=inputs, generator=generator)
        self._q.put(req)
        req.done.wait()
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # answer what is still queued, so no caller waits forever
        while True:
            try:
                req = self._q.get_nowait()
            except Empty:
                break
            req.error = "window batcher closed"
            req.done.set()

    def _loop(self):
        while not self._stop.is_set():
            reqs = _collect(self._q, self._stop, self.window,
                            self.buckets[-1])
            if reqs:
                self._run(reqs)

    def _run(self, reqs: list[_WindowReq]):
        try:
            k = len(reqs)
            B = next(b for b in self.buckets if b >= k)
            stacked = {}
            for key in reqs[0].inputs:
                rows = [np.asarray(r.inputs[key]) for r in reqs]
                rows += [rows[-1]] * (B - k)      # pad: repeat the last row
                stacked[key] = np.concatenate(rows, axis=0)
            if k == 1:
                generator = reqs[0].generator
            else:
                generator = torch.Generator().manual_seed(
                    (BATCH_SEED << 32) + self._counter)
            self._counter += 1
            out = self.synth.run_window(stacked, generator)
            self._count(stream_batches=1, stream_windows=k)
            for i, r in enumerate(reqs):
                r.result = out[i:i + 1]
                r.done.set()
        except Exception as e:  # noqa: BLE001 — serving must not die
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()


class GestureService:
    """A checkpoint's warm synthesizer with a micro-batching loop and live
    streams (no HTTP).  ``checkpoint`` is a port checkpoint directory or
    a JAX one; ``device`` is CUDA unless ``"cpu"`` is given, and without
    CUDA and without it the service raises.  ``low_latency`` is accepted
    for the JAX package's API and selects nothing (every recurrence on
    CUDA runs kernel B1)."""

    def __init__(self, checkpoint: str, max_clip_seconds: float = 20.0,
                 max_batch: int = 16, batch_window_ms: float = 30.0,
                 low_latency: bool = True, warm: bool = True,
                 max_streams: int = 32, max_stream_seconds: float = 120.0,
                 stream_idle_timeout: float = 300.0,
                 stream_batching: bool = False,
                 stream_batch_window_ms: float = 8.0, device=None):
        from ha2g_torch.cli import load_checkpoint_system
        from ha2g_torch.device import resolve_device
        from ha2g_torch.synthesis import make_synthesizer

        self.device = resolve_device(device)
        self.cfg, self.lang, self.speaker, system = \
            load_checkpoint_system(checkpoint, self.device)
        self.synth = make_synthesizer(system, system.state_dict(),
                                      low_latency=low_latency)
        self.max_clip_seconds = float(max_clip_seconds)
        self.max_batch = int(max_batch)
        self.batch_window = batch_window_ms / 1000.0
        self.n_samples = int(self.max_clip_seconds * SR)
        self.fps = self.cfg.motion_resampling_framerate
        # every call is padded to one of these batch sizes; warmup() runs
        # each once, so no request pays a first launch
        self.buckets = sorted({b for b in (1, 4, 8, self.max_batch)
                               if b <= self.max_batch})
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "frames": 0, "streams_opened": 0}
        self._stats_lock = threading.Lock()
        self.max_streams = int(max_streams)
        self.max_stream_seconds = float(max_stream_seconds)
        self.stream_idle_timeout = float(stream_idle_timeout)
        self._streams: dict[str, dict] = {}
        self._streams_lock = threading.Lock()
        self._window_batcher = _WindowBatcher(
            self.synth, self.buckets, stream_batch_window_ms, self._count) \
            if stream_batching and self.supports_streaming() else None
        self._q: Queue[_Request] = Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ha2g-serve-loop")
        self._thread.start()
        if warm:
            self.warmup()

    def _count(self, **counts) -> None:
        with self._stats_lock:
            for k, n in counts.items():
                self.stats[k] = self.stats.get(k, 0) + int(n)

    # ------------------------------------------------------------------
    def warmup(self):
        """Run every (loop, bucket) once and, where the model streams, one
        stream: on the card this builds the kernels and picks cuDNN's
        algorithms before the first request.  A synthesizer without a
        fused loop runs its window loop only."""
        silent = np.zeros(self.n_samples, np.float32)
        fused_opts = (True, False) if hasattr(self.synth, "generate_fused") \
            else (False,)
        for fused in fused_opts:
            for bucket in self.buckets:
                reqs = [self.submit(silent, [], 0, fused=fused)
                        for _ in range(bucket)]
                for r in reqs:
                    r.done.wait()
        if not self.supports_streaming():
            return
        sid = self.open_stream(0)
        self.stream_feed(sid, np.zeros(2 * SR, np.float32))
        self.stream_feed(sid, np.zeros(2 * SR, np.float32))
        self.stream_finish(sid)

    # ---- live streams --------------------------------------------------
    def supports_streaming(self) -> bool:
        """Live streams drive spectrogram-windowed models only."""
        return self.synth.uses_spec and not self.synth.uses_audio

    def open_stream(self, vid: int = 0,
                    total_seconds: Optional[float] = None) -> str:
        """Open a live GestureStream; -> its id.  Idle streams past
        ``stream_idle_timeout`` are dropped first.  A model that is not
        spectrogram-windowed (multimodal_context, joint_embedding, seq2seq)
        raises ValueError."""
        if not self.supports_streaming():
            raise ValueError(
                f"model {self.cfg.model!r} is not spectrogram-windowed; "
                "live streaming drives spec-windowed models (hierarchy, "
                "speech2gesture)")
        now = time.monotonic()
        with self._streams_lock:
            for sid in [s for s, e in self._streams.items()
                        if now - e["t"] > self.stream_idle_timeout]:
                del self._streams[sid]
            if len(self._streams) >= self.max_streams:
                raise RuntimeError(
                    f"too many live streams (max {self.max_streams})")
            sid = uuid.uuid4().hex[:16]
            executor = self._window_batcher.run \
                if self._window_batcher is not None else None
            self._streams[sid] = {
                "stream": self.synth.stream(self.lang, int(vid),
                                            total_seconds=total_seconds,
                                            executor=executor),
                "lock": threading.Lock(), "t": now}
        self._count(streams_opened=1)
        return sid

    def _stream_entry(self, stream_id: str) -> dict:
        with self._streams_lock:
            entry = self._streams.get(stream_id)
            if entry is None:
                raise KeyError(f"unknown stream {stream_id!r} "
                               "(finished or idle-expired)")
            entry["t"] = time.monotonic()
            return entry

    def stream_feed(self, stream_id: str, samples=None,
                    words=()) -> np.ndarray:
        """Append audio and / or words to a live stream; -> the frames
        that became final (possibly none)."""
        entry = self._stream_entry(stream_id)
        with entry["lock"]:
            st = entry["stream"]
            n_new = 0 if samples is None else len(np.atleast_1d(samples))
            if (st.n_samples + n_new) / SR > self.max_stream_seconds:
                raise ValueError(
                    f"stream exceeds max_stream_seconds="
                    f"{self.max_stream_seconds}; finish it and open another")
            out = st.feed(samples, words=words)
        self._count(frames=out.shape[0])
        return out

    def stream_finish(self, stream_id: str) -> np.ndarray:
        """Flush and close a live stream; -> its last frames.  The id is
        taken out first, so a second finish of the same stream gets an
        unknown-stream error instead of a second tail."""
        with self._streams_lock:
            entry = self._streams.pop(stream_id, None)
        if entry is None:
            raise KeyError(f"unknown stream {stream_id!r} "
                           "(finished or idle-expired)")
        with entry["lock"]:      # waits for a feed in flight
            out = entry["stream"].finish()
        self._count(frames=out.shape[0])
        return out

    # ------------------------------------------------------------------
    def submit(self, audio: np.ndarray, words, vid: int,
               fused: bool = True) -> _Request:
        audio = np.asarray(audio, np.float32).reshape(-1)
        truncated_from = None
        if audio.shape[0] > self.n_samples:
            truncated_from = audio.shape[0] / SR
            audio = audio[:self.n_samples]
        req = _Request(audio=audio, words=list(words), vid=int(vid),
                       fused=bool(fused), truncated_from=truncated_from)
        self._q.put(req)
        return req

    def synthesize(self, audio, words, vid: int = 0, fused: bool = True,
                   timeout: float = 120.0) -> np.ndarray:
        req = self.submit(audio, words, vid, fused)
        if not req.done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def close(self):
        """Stop the batching loop and the stream batcher and drop the live
        streams."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._window_batcher is not None:
            self._window_batcher.close()
        with self._streams_lock:
            self._streams.clear()

    # ------------------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            batch = _collect(self._q, self._stop, self.batch_window,
                             self.max_batch)
            # one call per loop (fused or host)
            for fused in (True, False):
                group = [r for r in batch if r.fused == fused]
                if group:
                    self._run(group, fused)

    def padded_batch(self, group: list[_Request]):
        """The batch a group runs as: (audio (B, n_samples), words, vids)
        padded with silent clips to the smallest bucket B >= len(group)."""
        B = next(b for b in self.buckets if b >= len(group))
        audio = np.zeros((B, self.n_samples), np.float32)
        for i, r in enumerate(group):
            audio[i, :len(r.audio)] = r.audio
        words = [r.words for r in group] + [[] for _ in range(B - len(group))]
        vids = np.zeros(B, np.int64)
        vids[:len(group)] = [r.vid for r in group]
        return audio, words, vids

    def _run(self, group: list[_Request], fused: bool):
        try:
            audio, words, vids = self.padded_batch(group)
            run = self.synth.generate_fused \
                if fused and hasattr(self.synth, "generate_fused") \
                else self.synth.generate
            out = run(audio, words, self.lang, vids)
            frames = 0
            for i, r in enumerate(group):
                n = min(out.shape[1],
                        max(1, int(round(len(r.audio) / SR * self.fps))))
                r.result = out[i, :n]
                frames += n
            self._count(batches=1, requests=len(group), frames=frames)
        except Exception as e:  # noqa: BLE001 — serving must not die
            self._count(errors=len(group))
            for r in group:
                r.error = f"{type(e).__name__}: {e}"
        for r in group:
            r.done.set()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _decode_audio(payload, encoding: str = "pcm_f32") -> np.ndarray:
    """A base64 string or a list of samples -> float32 waveform.  The wire
    formats: pcm_f32 (default), pcm_i16 (half the bytes) and pcm_mulaw
    (G.711 mu-law, a quarter)."""
    if isinstance(payload, str):
        raw = base64.b64decode(payload)
        if encoding == "pcm_i16":
            return pcm_to_float_np(np.frombuffer(raw, "<i2"))
        if encoding == "pcm_mulaw":
            return pcm_to_float_np(np.frombuffer(raw, np.uint8))
        return np.frombuffer(raw, "<f4").copy()
    return np.asarray(payload, np.float32)


def _encode_poses(out: np.ndarray, return_dtype: str) -> dict:
    if return_dtype not in ("f32", "f16"):
        raise ValueError(f"return_dtype {return_dtype!r}")
    arr = np.ascontiguousarray(out, "<f2" if return_dtype == "f16" else "<f4")
    return {"dir_vec": base64.b64encode(arr.tobytes()).decode(),
            "dtype": return_dtype, "shape": list(arr.shape)}


def make_http_server(service: GestureService, host: str = "127.0.0.1",
                     port: int = 8017) -> ThreadingHTTPServer:
    """The HTTP API above on ``service`` (port 0 picks a free port:
    ``server.server_address[1]``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n)) if n else {}

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "model": service.cfg.model,
                                 "dataset": service.cfg.dataset,
                                 "pose_dim": service.cfg.pose_dim,
                                 "fps": service.fps,
                                 "max_clip_seconds":
                                 service.max_clip_seconds})
            elif self.path == "/stats":
                with service._stats_lock:
                    stats = dict(service.stats)
                self._json(200, stats)
            else:
                self._json(404, {"error": "unknown path"})

        def _do_stream(self, req: dict):
            """/stream/open | /stream/<id>/feed | /stream/<id>/finish."""
            if self.path == "/stream/open":
                sid = service.open_stream(int(req.get("vid", 0)),
                                          req.get("total_seconds"))
                return self._json(200, {"stream_id": sid})
            parts = self.path.split("/")     # ['', 'stream', id, verb]
            if len(parts) != 4 or parts[3] not in ("feed", "finish"):
                return self._json(404, {"error": "unknown path"})
            sid, verb = parts[2], parts[3]
            t0 = time.perf_counter()
            try:
                if verb == "feed":
                    samples = None
                    if "audio" in req:
                        samples = _decode_audio(
                            req["audio"], req.get("encoding", "pcm_f32"))
                    out = service.stream_feed(sid, samples,
                                              req.get("words", ()))
                else:
                    out = service.stream_finish(sid)
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            resp = _encode_poses(out, req.get("return_dtype", "f32"))
            resp["fps"] = service.fps
            resp["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            self._json(200, resp)

        def do_POST(self):
            try:
                if self.path.startswith("/stream"):
                    return self._do_stream(self._body())
                if self.path != "/synthesize":
                    return self._json(404, {"error": "unknown path"})
                req = self._body()
                audio = _decode_audio(req["audio"],
                                      req.get("encoding", "pcm_f32"))
                sent_s = len(audio) / SR
                t0 = time.perf_counter()
                out = service.synthesize(
                    audio, req.get("words", []), int(req.get("vid", 0)),
                    fused=bool(req.get("fused", True)))
                resp = _encode_poses(out, req.get("return_dtype", "f32"))
                resp.update({
                    "fps": service.fps,
                    # a clip over max_clip_seconds is covered up to the cap
                    "covered_seconds": round(
                        min(sent_s, service.max_clip_seconds), 3),
                    "truncated": sent_s > service.max_clip_seconds,
                    "latency_ms": round((time.perf_counter() - t0) * 1e3,
                                        1)})
                self._json(200, resp)
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(checkpoint: str, host: str = "127.0.0.1",
                  port: int = 8017, **kw):
    service = GestureService(checkpoint, **kw)
    httpd = make_http_server(service, host, port)
    print(f"serving {service.cfg.model}/{service.cfg.dataset} on "
          f"http://{host}:{httpd.server_address[1]} ({service.device}, warm)",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        service.close()
