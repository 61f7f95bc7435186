"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes.  Libraries go
to ``ha2g_torch/_build/<hash of the source>/`` inside the checkout, so a
changed source builds anew and an unchanged one is reused.  Nothing here
runs at import time.  One lock serialises building and loading, so threads
that first use a kernel together build it once; a build writes its
library to a temporary file named by process and thread before moving it
into place.

The ops modules' wrappers route their tensors with ``on_card`` (the plain
version for CPU tensors, the kernel for contiguous tensors on one CUDA
device) and start their kernels with ``launch``, which counts each
execution in the wrapper's ``launches`` attribute through ``count_launch``:
an eager launch counts one; a launch recorded while the thread captures a
CUDA graph (inside ``captured_launches``) counts nothing, and goes into the
capture's tally, which ``add_launches`` adds again at each replay of the
graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.RLock()
_count_lock = threading.Lock()
_capture = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / f"lib{source.stem}.so"


def build(sources) -> dict[Path, str]:
    """Compile every source whose library is missing, all nvcc processes
    started together.  Returns {source: nvcc output (ptxas resource lines)}
    for the ones built; raises if any build fails."""
    with _lock:
        return _build(sources)


def _build(sources) -> dict[Path, str]:
    procs = {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    logs, failed = {}, []
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        (lib.parent / "build.log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib


def on_card(name: str, tensors) -> bool:
    """False for all-CPU tensors (the plain version); True for contiguous
    tensors on one CUDA device (the kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} needs all tensors on one CUDA device or "
                         f"all on the CPU, got {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return True


def launch(wrapper, fn, device, *args) -> None:
    """One kernel launch by ``wrapper``: the library function ``fn(*args,
    stream)`` on ``device``, handed that device's current stream; raises
    on a nonzero CUDA error, else counts the launch (``count_launch``)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(wrapper)


def count_launch(wrapper) -> None:
    """One kernel launch by ``wrapper``: one more in ``wrapper.launches``,
    or, while this thread captures a graph, one more in the capture's
    tally (under a lock: serving launches from several threads)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture on this thread: yields the tally
    {wrapper: launches recorded}, which no ``launches`` counts yet."""
    tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def add_launches(tally: dict) -> None:
    """A replay of a captured graph: each wrapper's ``launches`` grows by
    the launches captured in it."""
    with _count_lock:
        for wrapper, n in tally.items():
            wrapper.launches += n
