"""The native (C++) window engine of the host data path (the port of
ha2g_tpu/native/).

``window_engine.cpp`` runs the per-clip inner loop of the windowing stage:
resampling to the target fps, the sliding extended windows at the
subdivision stride, the motion filter and the unit direction vectors minus
the dataset mean (the work the reference spreads over DataLoader worker
processes).  It is built with ``g++`` at first use, with the JAX package's
flags, into ``ha2g_torch/_build/<hash of source, flags and host CPU>/``
and bound with ctypes.

``available()`` is False when no ``g++`` is on the PATH (the numpy path of
``data/dataset.py`` then runs, with a logged note).  Where ``g++`` exists
and the build fails, it raises: the JAX package logs and falls back, the
port does not hide a broken build.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "window_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[BaseException] = None
_lock = threading.Lock()


def _host_tag() -> bytes:
    """The machine a ``-march=native`` build is for: its architecture and
    the CPU's model and flags (a library built on another CPU may use
    instructions this one lacks)."""
    tag = platform.machine()
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
        tag += "".join(next((ln for ln in lines if ln.startswith(k)), "")
                       for k in ("model name", "flags"))
    except OSError:
        tag += platform.processor()
    return tag.encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _host_tag()).hexdigest()[:16]
    return BUILD_DIR / digest / "libwindow_engine.so"


def _build() -> Optional[ctypes.CDLL]:
    gxx = shutil.which("g++")
    if gxx is None:
        logging.info("no g++ on the PATH: the numpy windowing path runs")
        return None
    lib_path = library_path()
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native window engine "
                               f"({SOURCE}):\n{proc.stderr[-2000:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    f = lib.window_clip
    f.restype = ctypes.c_int64
    f.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The loaded engine, built on first use; None without ``g++``.  A
    failed build raises, here and on every later call, without running
    ``g++`` again."""
    global _lib, _tried, _error
    with _lock:
        if not _tried:
            try:
                _lib = _build()
            except Exception as e:
                _error = e
            _tried = True
        if _error is not None:
            raise _error
        return _lib


def available() -> bool:
    return _get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def window_clip_native(skel: np.ndarray, duration: float, fps: int, spec,
                       mean_dir_vec: np.ndarray, mean_pose: np.ndarray,
                       n_poses: int, n_ext: int, stride: int,
                       static_joints=(6, 9)):
    """One clip through the engine.  skel: (F, n_joints, 3) float32 ->
    (targets (N, n_poses, pose_dim), poses (N, n_poses, n_joints * 3),
    starts (N,)) of the N windows that pass the motion filter (always on,
    as in ``window_clips``)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("the native window engine is unavailable (no g++)")
    skel = np.ascontiguousarray(skel, np.float32)
    n_frames, n_joints = skel.shape[0], skel.shape[1]
    parents = np.ascontiguousarray(spec.parents, np.int32)
    children = np.ascontiguousarray(spec.children, np.int32)
    mdv = np.ascontiguousarray(mean_dir_vec, np.float32).reshape(-1)
    mp = np.ascontiguousarray(mean_pose, np.float32).reshape(-1)

    max_w = max((int(duration * fps) - n_ext) // stride + 2, 1)
    targets = np.empty((max_w, n_poses, spec.n_bones * 3), np.float32)
    poses = np.empty((max_w, n_poses, n_joints * 3), np.float32)
    starts = np.empty((max_w,), np.int64)

    n = lib.window_clip(
        _fptr(skel), n_frames, n_joints, float(duration), int(fps),
        _iptr(parents), _iptr(children), spec.n_bones,
        _fptr(mdv), _fptr(mp),
        n_poses, n_ext, stride,
        int(static_joints[0]), int(static_joints[1]), 0,
        _fptr(targets), _fptr(poses),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_w)
    if n < 0:
        raise RuntimeError("the native window engine failed on a clip")
    return targets[:n].copy(), poses[:n].copy(), starts[:n].copy()
