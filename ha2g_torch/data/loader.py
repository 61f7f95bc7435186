"""Batch iterator (the port of ha2g_tpu/data/loader.py).

Samples live in fixed-shape host arrays; each epoch is a view through
``np.random.default_rng(seed).permutation``, drawn anew every epoch from
one generator, so a seed gives the JAX package's index order.

With a CUDA ``device``, a worker thread gathers each host batch into
pinned (page-locked) buffers and the consuming thread copies them to the
device with ``non_blocking=True``, so the copy overlaps the device's work.
A pinned buffer is written again only after its copy has finished: the
consumer records a CUDA event after each copy, and the worker waits on
that event before it refills the buffer (a ring of ``PINNED_SETS``
buffer sets).  Without the wait the worker could overwrite a batch the
card is still reading.  With a CPU device batches come as CPU tensors,
and without a device as numpy arrays.

Under a mesh, ``part=(r, W)`` makes the loader rank r's: the global batch
order is the single loader's (same seed, same ``drop_last``), and the rank
gathers, pins and copies only its own contiguous rows of each batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ha2g_torch.data.dataset import WindowedSamples

BATCH_KEYS = ("text", "word_seq", "word_lengths", "pose", "target", "audio",
              "spec", "vids")
# pinned buffer sets: the worker runs up to PINNED_SETS - 1 batches ahead
PINNED_SETS = 4


class BatchLoader:
    def __init__(self, samples: WindowedSamples, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, keys=None,
                 device: Optional[torch.device] = None,
                 part: tuple[int, int] = (0, 1)):
        # keys: only the fields the system reads (the raw 16 kHz audio is
        # most of a batch's bytes, and the hierarchy never reads it)
        self.keys = tuple(keys) if keys else BATCH_KEYS
        self.s = samples
        self.batch_size = batch_size
        # part (r, W): rank r of W takes the rows [r b, (r + 1) b), b =
        # batch_size / W, of every global batch
        self.part_index, self.parts = part
        if batch_size % self.parts:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{self.parts} ranks")
        self.rows = batch_size // self.parts
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.device = None if device is None else torch.device(device)
        # pinned buffer sets and, per set, the event of its last copy
        self._pinned: list[dict[str, torch.Tensor]] = []
        self._copied: list[Optional[torch.cuda.Event]] = []

    def __len__(self):
        n = len(self.s)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def batch_bytes(self) -> int:
        """Bytes of one full batch (this rank's rows) of the loader's
        keys."""
        return sum(getattr(self.s, k)[:1].nbytes * self.rows
                   for k in self.keys)

    def _indices(self) -> Iterator[np.ndarray]:
        n = len(self.s)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            sel = idx[i:i + self.batch_size]
            if self.parts > 1:
                # a last partial batch (drop_last off) splits as evenly
                sel = np.array_split(sel, self.parts)[self.part_index]
            yield sel

    def _gather(self, sel: np.ndarray) -> dict[str, np.ndarray]:
        return {k: getattr(self.s, k)[sel] for k in self.keys}

    def __iter__(self) -> Iterator[dict]:
        if self.device is not None and self.device.type == "cuda":
            yield from self._iter_pinned()
            return
        for sel in self._indices():
            batch = self._gather(sel)
            if self.device is not None:
                batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            yield batch

    # ---- the CUDA path ---------------------------------------------------
    def _buffers(self, slot: int) -> dict[str, torch.Tensor]:
        while len(self._pinned) <= slot:
            self._pinned.append({
                k: torch.empty((self.rows,) + getattr(self.s, k)
                               .shape[1:], dtype=torch.from_numpy(
                                   getattr(self.s, k)[:1]).dtype,
                               pin_memory=True) for k in self.keys})
        return self._pinned[slot]

    def _iter_pinned(self) -> Iterator[dict]:
        while len(self._copied) < PINNED_SETS:
            self._copied.append(None)
        free: queue.Queue = queue.Queue()
        for slot in range(PINNED_SETS):
            free.put(slot)
        ready: queue.Queue = queue.Queue()
        stop = threading.Event()
        end = object()

        def worker():
            try:
                for sel in self._indices():
                    if stop.is_set():
                        return
                    while True:
                        try:
                            slot = free.get(timeout=0.1)
                            break
                        except queue.Empty:
                            if stop.is_set():
                                return
                    # the last copy out of this slot, of this epoch or the
                    # one before, must be done before it is written again
                    if self._copied[slot] is not None:
                        self._copied[slot].synchronize()
                    bufs = self._buffers(slot)
                    n = len(sel)
                    for k, v in self._gather(sel).items():
                        bufs[k][:n].copy_(torch.from_numpy(v))
                    ready.put((slot, n))
            except BaseException as e:  # noqa: BLE001 (raised below)
                ready.put(e)
                return
            ready.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            stream = torch.cuda.current_stream(self.device)
            while True:
                item = ready.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                slot, n = item
                with torch.cuda.stream(stream):
                    batch = {k: v[:n].to(self.device, non_blocking=True)
                             for k, v in self._pinned[slot].items()}
                    copied = torch.cuda.Event()
                    copied.record(stream)
                self._copied[slot] = copied
                free.put(slot)
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)
