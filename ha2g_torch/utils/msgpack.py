"""A msgpack decoder for the trees that ``flax.serialization.to_bytes``
writes (the JAX package's ``state.msgpack``), in pure Python: the card's
machine has neither flax nor msgpack.

It reads maps, arrays (as lists), str (as str), bin (as bytes), ints,
floats, nil and bool, and flax's two extension records:

* type 1, an ndarray: itself a msgpack ``(shape, dtype name, bytes)``,
  returned as a numpy array, or as a ``torch.bfloat16`` tensor for the
  dtype name ``bfloat16`` (numpy has no such dtype);
* type 3, a numpy scalar: the same record, returned as a numpy scalar (a
  0-d bfloat16 tensor for ``bfloat16``).

Flax writes an array over 2^30 bytes as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
{"0": flat chunk, ..}}``; ``unpackb`` joins it back into one array, as
``flax.serialization.msgpack_restore`` does.  Any other type code raises
a ValueError that names it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width formats, by type byte: (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# lengths of str (0xd9-0xdb), bin (0xc4-0xc6), array (0xdc-0xdd), map
# (0xde-0xdf) and ext (0xc7-0xc9), by type byte: (struct format, size)
_LENGTH = {0xd9: (">B", 1), 0xda: (">H", 2), 0xdb: (">I", 4),
           0xc4: (">B", 1), 0xc5: (">H", 2), 0xc6: (">I", 4),
           0xdc: (">H", 2), 0xdd: (">I", 4), 0xde: (">H", 2), 0xdf: (">I", 4),
           0xc7: (">B", 1), 0xc8: (">H", 2), 0xc9: (">I", 4)}
# fixext 1, 2, 4, 8, 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt_size) -> int:
        fmt, size = fmt_size
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:                       # positive fixint
            return b
        if b >= 0xe0:                       # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8f:               # fixmap
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:               # fixarray
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:               # fixstr
            return self.text(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in (0xd9, 0xda, 0xdb):
            return self.text(self.unpack(_LENGTH[b]))
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack(_LENGTH[b])))
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(_LENGTH[b]))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(_LENGTH[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack(_LENGTH[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray(payload: bytes):
    """flax's ndarray record -> a numpy array (a bfloat16 tensor for
    ``bfloat16``)."""
    shape, name, buf = unpackb(payload, join_chunks=False)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _join(tree):
    """Replace flax's chunked-array maps by the arrays they hold."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _join(v) for k, v in tree.items()}


def unpackb(data: bytes, join_chunks: bool = True) -> Any:
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the object")
    return _join(out) if join_chunks else out
