"""Skeleton animations (the port of ha2g_tpu/render.py; reference
train_utils.py:61-146): the human and the generated skeleton side by side,
a frame a pose, from direction-vector sequences.

The JAX package draws them with matplotlib's 3D axes and writes them
through matplotlib's ffmpeg or Pillow writer.  The port uses neither: it
projects the joints with matplotlib's own 3D view transform written in
numpy (``view_init(elev=20, azim=-60)``, the default camera distance and
box aspect, limits of +-0.5 and the axes' swap ``plot(x, z, y)``),
rasterises the bones itself (each bone in the colour matplotlib's cycle
gives its ``plot`` call) into two 240-pixel panels, and writes a GIF89a
with its own LZW encoder (``utils/image.py``).  Where ``ffmpeg`` is on the
PATH the raw frames are piped into it instead and the WAV muxed in, as
the JAX renderer does through matplotlib's ffmpeg writer.  The pixels are
the port's own, not matplotlib's: no titles, ticks or panes are drawn.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import time
import wave
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ha2g_torch.skeleton import SkeletonSpec
from ha2g_torch.utils.image import TAB10, draw_line, gif_bytes, rgb

ELEV, AZIM = 20.0, -60.0
# the axes' limits after the swap: x, then the pose's z, then its y
LIMITS = ((-0.5, 0.5), (0.5, -0.5), (0.5, -0.5))
DIST = 10.0              # matplotlib's camera distance (view_init)
# matplotlib's default box aspect: (4, 4, 3) scaled as Axes3D does it
BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * (
    1.8294640721620434 * 25 / 24 / np.linalg.norm([4.0, 4.0, 3.0]))
# the 2-D view limits of an Axes3D (set_top_view): x and y in
# [-0.95, 0.9] / dist
VIEW_LIMITS = (-0.95 / DIST, 0.9 / DIST)
PANEL_PX = 240           # a panel of the JAX package's 8 x 4 in figure
# palette indices: 0 white, 1 the panels' grey frame, 2 + i colour i of
# matplotlib's cycle
PALETTE = np.array([(255, 255, 255), (200, 200, 200)]
                   + [rgb(c) for c in TAB10], np.uint8)


def _write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """16-bit PCM mono WAV (soundfile is not needed)."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def projection_matrix(elev: float = ELEV, azim: float = AZIM,
                      limits=LIMITS) -> np.ndarray:
    """The 4 x 4 matrix of ``Axes3D.get_proj`` (matplotlib 3.10) for a
    perspective view, focal length 1, no roll, vertical axis z."""
    (x0, x1), (y0, y1), (z0, z1) = limits
    dx, dy, dz = (x1 - x0) / BOX_ASPECT[0], (y1 - y0) / BOX_ASPECT[1], \
        (z1 - z0) / BOX_ASPECT[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx],
                      [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz],
                      [0, 0, 0, 1]])
    R = 0.5 * BOX_ASPECT
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + DIST * ps
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(np.array([0.0, 0.0, 1.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -eye
    b = (-DIST + DIST) / (-DIST - DIST)
    c = -2 * (-DIST * DIST) / (-DIST - DIST)
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, b, c],
                      [0, 0, -1, 0]], dtype=np.float64)
    return np.dot(persp, np.dot(np.dot(rot, shift), world))


def project(pose: np.ndarray, M: Optional[np.ndarray] = None) -> np.ndarray:
    """Joint positions (..., n_joints, 3) -> their 2-D view coordinates
    (..., n_joints, 2) as the JAX renderer's axes place them: matplotlib
    plots (x, z, y) and projects with ``M``."""
    M = projection_matrix() if M is None else M
    p = np.asarray(pose, np.float64)
    vec = np.stack([p[..., 0], p[..., 2], p[..., 1], np.ones(p.shape[:-1])])
    out = np.tensordot(M, vec, axes=(1, 0))
    return np.stack([out[0] / out[3], out[1] / out[3]], axis=-1)


def _to_pixels(xy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lo, hi = VIEW_LIMITS
    scale = PANEL_PX / (hi - lo)
    return (xy[..., 0] - lo) * scale, (hi - xy[..., 1]) * scale


def _frame(panels, spec: SkeletonSpec) -> np.ndarray:
    """One (PANEL_PX, 2 * PANEL_PX) frame of ``PALETTE`` indices: each
    panel's bone b in colour b mod 10 of the cycle, on white, framed in
    grey."""
    img = np.zeros((PANEL_PX, 2 * PANEL_PX), np.uint8)
    for k, xy in enumerate(panels):
        view = img[:, k * PANEL_PX:(k + 1) * PANEL_PX]
        view[[0, -1], :] = 1
        view[:, [0, -1]] = 1
        if xy is None:
            continue
        x, y = _to_pixels(xy)
        for b, (a, c, _) in enumerate(spec.bones):
            draw_line(view, (x[a], y[a]), (x[c], y[c]), 2 + b % len(TAB10),
                      width=2)
    return img


def create_video_and_save(save_path: str, epoch: int, prefix: str,
                          iter_idx, target: Optional[np.ndarray],
                          output: np.ndarray, mean_data: np.ndarray,
                          title: str, spec: SkeletonSpec,
                          audio: Optional[np.ndarray] = None,
                          aux_str: Optional[str] = None, fps: int = 15,
                          delete_audio_file: bool = True) -> str:
    """Render (T, pose_dim) mean-subtracted direction-vector sequences
    (``target`` on the left, may be None; ``output`` on the right) to
    ``{save_path}/{prefix}_{epoch:03d}_{iter_idx}`` + ``.mp4`` (ffmpeg on
    the PATH; with ``audio`` muxed in) or ``.gif`` (without; the audio is
    then not written); -> the file's path.  ``title`` and ``aux_str`` go
    to the log, not into the frames."""
    t0 = time.time()
    Path(save_path).mkdir(parents=True, exist_ok=True)
    mean = np.asarray(mean_data, np.float32).reshape(-1)

    def positions(vec):
        if vec is None:
            return None
        v = torch.as_tensor(np.asarray(vec, np.float32) + mean)
        return spec.dir_vec_to_pose(v).numpy()

    out_pos, tgt_pos = positions(output), positions(target)
    M = projection_matrix()
    views = [None if p is None else project(p, M) for p in (tgt_pos, out_pos)]
    n_frames = max(len(out_pos), len(tgt_pos) if tgt_pos is not None else 0)
    frames = [_frame([None if v is None or i >= len(v) else v[i]
                      for v in views], spec) for i in range(n_frames)]

    stem = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}"
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        video_path = stem + ".gif"
        Path(video_path).write_bytes(gif_bytes(frames, PALETTE, 1000 // fps))
        if audio is not None:
            logging.warning("ffmpeg unavailable: skipping audio mux; wrote "
                            "%s", video_path)
    else:
        video_path = stem + ("_temp.mp4" if audio is not None else ".mp4")
        raw = PALETTE[np.stack(frames)]
        subprocess.run([ffmpeg, "-loglevel", "panic", "-y", "-f", "rawvideo",
                        "-pix_fmt", "rgb24", "-s",
                        f"{raw.shape[2]}x{raw.shape[1]}", "-r", str(fps),
                        "-i", "-", "-pix_fmt", "yuv420p", video_path],
                       input=raw.tobytes(), check=True)
        if audio is not None:
            audio_path = stem + ".wav"
            _write_wav(audio_path, np.asarray(audio, np.float32))
            merged = stem + ".mp4"
            subprocess.call([ffmpeg, "-loglevel", "panic", "-y", "-i",
                             video_path, "-i", audio_path, "-strict", "-2",
                             merged])
            if delete_audio_file:
                os.remove(audio_path)
            os.remove(video_path)
            video_path = merged
    logging.info("rendered %s (%s%s) in %.1fs", video_path, title,
                 f"; {aux_str}" if aux_str else "", time.time() - t0)
    return video_path
