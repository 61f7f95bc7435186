"""Raster images without an imaging library: line and dot drawing on
numpy arrays, a PNG writer and a GIF89a writer with its LZW encoder, all
on the standard library (``zlib``, ``struct``) and numpy.  The dataset QA
report's contact sheets (``dataset_pipeline/report.py``) and the skeleton
animations (``render.py``) draw with them; the JAX package draws both
with matplotlib, which the port does not use.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

# matplotlib's default colour cycle (tab10), the colours of successive
# ``plot`` calls on an axis
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


def rgb(color: str) -> tuple[int, int, int]:
    """'#rrggbb' -> (r, g, b)."""
    return tuple(int(color[i:i + 2], 16) for i in (1, 3, 5))


def draw_line(img: np.ndarray, p0, p1, value, width: int = 2) -> None:
    """Set the pixels of the segment p0 -> p1 ((x, y) in pixels, y down)
    to ``value``, ``width`` pixels thick; what falls outside is clipped."""
    (x0, y0), (x1, y1) = p0, p1
    if not np.isfinite([x0, y0, x1, y1]).all():
        return
    n = int(np.ceil(max(abs(x1 - x0), abs(y1 - y0)) * 2)) + 2
    t = np.linspace(0.0, 1.0, n)
    x = np.rint(x0 + t * (x1 - x0) - (width - 1) / 2).astype(np.int64)
    y = np.rint(y0 + t * (y1 - y0) - (width - 1) / 2).astype(np.int64)
    off = np.arange(width)
    xs = (x[:, None, None] + off[None, :, None]).repeat(width, 2).ravel()
    ys = (y[:, None, None] + off[None, None, :]).repeat(width, 1).ravel()
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = value


def draw_dots(img: np.ndarray, xs, ys, value, radius: int = 1) -> None:
    """Squares of side 2 * radius + 1 centred on each (x, y) pixel."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    ok = np.isfinite(xs) & np.isfinite(ys)
    off = np.arange(-radius, radius + 1)
    px = (np.rint(xs[ok])[:, None, None] + off[None, :, None])
    py = (np.rint(ys[ok])[:, None, None] + off[None, None, :])
    px = px.repeat(len(off), 2).ravel().astype(np.int64)
    py = py.repeat(len(off), 1).ravel().astype(np.int64)
    keep = (px >= 0) & (px < img.shape[1]) & (py >= 0) & (py < img.shape[0])
    img[py[keep], px[keep]] = value


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> a PNG file's bytes (8-bit truecolour, no
    filter)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a frame's palette indices, not empty
    (codes from min_code_size + 1 bits up to 12, packed least significant
    bit first; a clear code first and whenever the table is full, an end
    code last)."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = n_acc = 0

    def emit(code, size):
        nonlocal acc, n_acc
        acc |= code << n_acc
        n_acc += size
        while n_acc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_acc -= 8

    size = min_code_size + 1
    table: dict[int, int] = {}
    nxt = end + 1
    emit(clear, size)
    w = indices[0]
    for k in indices[1:]:
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, size)
        if nxt == 4096:
            emit(clear, size)
            table.clear()
            nxt, size = end + 1, min_code_size + 1
        else:
            table[key] = nxt
            if nxt == (1 << size) and size < 12:
                size += 1
            nxt += 1
        w = k
    emit(w, size)
    emit(end, size)
    if n_acc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def gif_bytes(frames: Sequence[np.ndarray], palette: np.ndarray,
              delay_ms: int, loop: int = 0) -> bytes:
    """An animated GIF89a: frames of (H, W) uint8 palette indices, a
    palette of up to 256 RGB rows, each frame shown ``delay_ms`` (GIF
    keeps hundredths of a second: delay_ms // 10), ``loop`` repeats (0:
    forever, the NETSCAPE2.0 extension)."""
    palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    h, w = frames[0].shape
    min_code = max(2, bits)
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | ((bits - 1) << 4)
                                  | (bits - 1), 0, 0), table.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
           + b"\x00"]
    for f in frames:
        if f.shape != (h, w):
            raise ValueError("every frame of a GIF has the first's size")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_ms // 10)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(bytes([min_code]) + _sub_blocks(lzw_encode(
            np.ascontiguousarray(f, np.uint8).tobytes(), min_code)))
    out.append(b"\x3b")
    return b"".join(out)
