"""The pyarrow-0.14 legacy ``serialize`` / ``deserialize`` wire format in
pure Python and numpy (the counterpart of ha2g_tpu/data/pyarrow_legacy.py,
which sits on a modern pyarrow; this module needs no pyarrow at all).

The released TED datasets are lmdb stores whose values were written by
``pyarrow.serialize(record).to_buffer()`` under pyarrow 0.14 (reference
data_preprocessor.py:41-56 writes them, lmdb_data_loader.py:108-115 reads
them).  A value is laid out as (arrow 0.14 ``SerializedPyObject::WriteTo``):

  int32 num_tensors | int32 num_ndarrays | int32 num_buffers
  zero padding to 8
  an Arrow IPC stream, metadata V4: a Schema message and one RecordBatch
      message whose single column ("list") is a dense union of one row,
      the object; then the end-of-stream marker
  per ndarray: zero padding to 64, then a Tensor IPC message

Each IPC message is an envelope, a flatbuffer of metadata padded to 8, and
a body of buffers.  The envelope is an int32 metadata length before 0.15
("legacy") and the 0xFFFFFFFF continuation marker plus that length from
0.15 to 0.17; the reader takes both, the writer writes the legacy one
unless asked.  The flatbuffers are read and built here by hand (``_Table``,
``_Builder``) for the tables the format uses: Message, Schema, Field, the
``Type`` union (Null, Int, FloatingPoint, Binary, Utf8, Bool, List,
Struct_, Union), RecordBatch with its vectors of ``FieldNode`` and
``Buffer`` structs (16 bytes, 8-aligned), Tensor and TensorDim.

The object is a tree of dense unions (``SequenceBuilder``): each level
holds one child a kind, created in first-use order: bool "bools", int
"ints" (int64), str "strings" (utf8), bytes "bytes" (binary), np.float32
"floats" (float32), float "doubles" (float64), None "nones" (null), list /
tuple / set "lists" / "tuples" / "sets" (list<union>), dict "dicts"
(struct of keys and vals, two list<union> sharing offsets), ndarray
"ndarrays" (int32 index into the tensor section).  Buffers a node, in
order: a union's validity (metadata V4 only), type ids (int8) and offsets
(int32); none for null; validity and values for bool (bits), ints and
floats; validity, int32 offsets and data for utf8 / binary; validity and
offsets for a list; validity for a struct.  The reader dispatches on the
child's type and field name, as the 0.14 deserializer does
(deserialize.cc GetValue), so it takes any type-id numbering.
"""

from __future__ import annotations

import struct

import numpy as np

_ALIGN_STREAM = 8
_ALIGN_TENSOR = 64
_CONTINUATION = 0xFFFFFFFF

# MessageHeader and Type union tags (Message.fbs, Schema.fbs)
_SCHEMA, _RECORD_BATCH, _TENSOR = 1, 3, 4
_NULL, _INT, _FLOAT, _BINARY, _UTF8, _BOOL, _LIST, _STRUCT, _UNION = \
    1, 2, 3, 4, 5, 6, 12, 13, 14
_V4, _V5 = 3, 4                       # MetadataVersion
_DENSE = 1                            # UnionMode
_PRECISION = {np.dtype(np.float16): 0, np.dtype(np.float32): 1,
              np.dtype(np.float64): 2}


def _pad_to(n: int, align: int) -> int:
    return (-n) % align


# --------------------------------------------------------------------------
# flatbuffers
# --------------------------------------------------------------------------

class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: its vtable gives each
    field's offset in the table, 0 for a field left at its default."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        n_bytes, = struct.unpack_from("<H", buf, vt)
        self.fields = struct.unpack_from(f"<{(n_bytes - 4) // 2}H", buf,
                                         vt + 4)

    def _at(self, field: int) -> int:
        return self.fields[field] if field < len(self.fields) else 0

    def scalar(self, field: int, fmt: str, default=0):
        off = self._at(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] \
            if off else default

    def struct(self, field: int, fmt: str):
        return struct.unpack_from("<" + fmt, self.buf,
                                  self.pos + self._at(field))

    def _ref(self, field: int):
        off = self._at(field)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, field: int):
        at = self._ref(field)
        return None if at is None else _Table(self.buf, at)

    def string(self, field: int):
        at = self._ref(field)
        if at is None:
            return None
        n, = struct.unpack_from("<I", self.buf, at)
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8")

    def _vector(self, field: int):
        at = self._ref(field)
        if at is None:
            return 0, 0
        return struct.unpack_from("<I", self.buf, at)[0], at + 4

    def tables(self, field: int) -> list:
        n, at = self._vector(field)
        return [_Table(self.buf, at + 4 * i + struct.unpack_from(
            "<I", self.buf, at + 4 * i)[0]) for i in range(n)]

    def scalars(self, field: int, fmt: str) -> list:
        n, at = self._vector(field)
        return list(struct.unpack_from(f"<{n}{fmt}", self.buf, at))

    def structs(self, field: int, fmt: str) -> list:
        n, at = self._vector(field)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, at + size * i)
                for i in range(n)]


def _union(table: _Table, field: int):
    """A union field: its type tag (at ``field``) and value table."""
    return table.scalar(field, "B"), table.table(field + 1)


class _T:
    """A table to build: ``fields`` maps a field id to ``(fmt, value)``
    (a scalar, or with fmt ``"struct:<fmt>"`` an inline struct), a ``_T``,
    a ``str``, or a vector (``_V``)."""

    def __init__(self, **fields):
        self.fields = {int(k[1:]): v for k, v in fields.items()}


class _V:
    """A vector to build: of tables (``fmt`` None), of scalars (``fmt`` a
    struct code), or of structs (``fmt`` a struct format, each item a
    tuple)."""

    def __init__(self, items, fmt=None):
        self.items, self.fmt = list(items), fmt


def _inline(v):
    """A table's inline field -> (struct format, values, alignment)."""
    kind, value = v
    if kind.startswith("struct:"):
        return kind[7:], value, 8
    return kind, (value,), struct.calcsize("<" + kind)


class _Builder:
    """Writes front to back: the root offset, then each table after its
    vtable, each table's strings, tables and vectors after it (a flatbuffer
    offset points forward; the vtable's signed one points back).  Every
    scalar sits at a multiple of its size from the buffer's start, and
    8-byte vector items at a multiple of 8."""

    def __init__(self):
        self.buf = bytearray(4)

    def _align(self, n: int, extra: int = 0) -> None:
        """Pad so that ``len(buf) + extra`` is a multiple of ``n``."""
        self.buf += b"\0" * _pad_to(len(self.buf) + extra, n)

    def finish(self, root: _T) -> bytes:
        pos = self._table(root)
        struct.pack_into("<I", self.buf, 0, pos)
        self._align(8)
        return bytes(self.buf)

    def _table(self, t: _T) -> int:
        ids = sorted(t.fields)
        n = ids[-1] + 1 if ids else 0
        # the table's inline layout: soffset, then the fields in id order,
        # each aligned to its size (the table starts at a multiple of 8)
        layout, size = {}, 4
        for i in ids:
            v = t.fields[i]
            if isinstance(v, tuple):
                fmt, _, align = _inline(v)
                w = struct.calcsize("<" + fmt)
            else:
                w = align = 4
            size += _pad_to(size, align)
            layout[i] = size
            size += w
        vtable = struct.pack(f"<HH{n}H", 4 + 2 * n, size,
                             *[layout.get(i, 0) for i in range(n)])
        self._align(8, len(vtable))
        vt_pos = len(self.buf)
        self.buf += vtable
        pos = len(self.buf)
        self.buf += b"\0" * size
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        later = []
        for i in ids:
            v = t.fields[i]
            if isinstance(v, tuple):
                fmt, values, _ = _inline(v)
                struct.pack_into("<" + fmt, self.buf, pos + layout[i], *values)
            else:
                later.append((pos + layout[i], v))
        for at, v in later:
            self._patch(at, self._child(v))
        return pos

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def _child(self, v) -> int:
        if isinstance(v, _T):
            return self._table(v)
        if isinstance(v, str):
            data = v.encode("utf-8")
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos
        if v.fmt is None:                       # a vector of tables
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(v.items))
            self.buf += b"\0" * (4 * len(v.items))
            for k, item in enumerate(v.items):
                self._patch(pos + 4 + 4 * k, self._table(item))
            return pos
        size = struct.calcsize("<" + v.fmt)
        self._align(8 if size >= 8 else 4, 4)   # items 8-aligned
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(v.items))
        for item in v.items:
            self.buf += struct.pack("<" + v.fmt, *(
                item if isinstance(item, tuple) else (item,)))
        return pos


# --------------------------------------------------------------------------
# IPC messages
# --------------------------------------------------------------------------

def _message(header_type: int, header: _T, body_length: int,
             legacy: bool) -> bytes:
    """One message's envelope and metadata, padded so that its body
    starts at a multiple of 8 from the message's start."""
    meta = _Builder().finish(_T(f0=("h", _V4), f1=("B", header_type),
                               f2=header, f3=("q", body_length)))
    prefix = 4 if legacy else 8
    meta += b"\0" * _pad_to(prefix + len(meta), 8)
    head = struct.pack("<i", len(meta)) if legacy else \
        struct.pack("<Ii", _CONTINUATION, len(meta))
    return head + meta


def _read_message(buf, pos: int):
    """-> (Message table or None at end of stream, body start, position
    after the body)."""
    length, = struct.unpack_from("<I", buf, pos)
    pos += 4
    if length == _CONTINUATION:
        length, = struct.unpack_from("<I", buf, pos)
        pos += 4
    if length == 0:
        return None, pos, pos
    meta = buf[pos:pos + length]
    msg = _Table(meta, struct.unpack_from("<I", meta, 0)[0])
    body = pos + length
    return msg, body, body + msg.scalar(3, "q")


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

_SCALAR_KINDS = {"bools": (_BOOL, None), "ints": (_INT, np.int64),
                 "floats": (_FLOAT, np.float32),
                 "doubles": (_FLOAT, np.float64),
                 "ndarrays": (_INT, np.int32)}


def _type_table(tag: int, dtype=None) -> _T:
    if tag == _INT:
        return _T(f0=("i", 8 * dtype.itemsize),
                 f1=("?", dtype.kind == "i"))
    if tag == _FLOAT:
        return _T(f0=("h", _PRECISION[np.dtype(dtype)]))
    return _T()


class _Sequence:
    """One union level: children keyed by kind, created in first-use
    order, as arrow 0.14's SequenceBuilder assigns its tags."""

    def __init__(self, ndarrays: list):
        self.ndarrays = ndarrays
        self.type_ids: list[int] = []
        self.offsets: list[int] = []
        self.kinds: list[str] = []
        self.values: dict[str, list] = {}
        self.subs: dict[str, tuple[list[int], "_Sequence"]] = {}
        self.dicts = None

    def _push(self, kind: str, offset: int) -> None:
        if kind not in self.kinds:
            self.kinds.append(kind)
        self.type_ids.append(self.kinds.index(kind))
        self.offsets.append(offset)

    def _scalar(self, kind: str, value) -> None:
        values = self.values.setdefault(kind, [])
        self._push(kind, len(values))
        values.append(value)

    def append(self, obj) -> None:
        if obj is None:
            self._scalar("nones", None)
        elif isinstance(obj, (bool, np.bool_)):
            self._scalar("bools", bool(obj))
        elif isinstance(obj, (int, np.integer)):
            self._scalar("ints", int(obj))
        elif isinstance(obj, str):
            self._scalar("strings", obj)
        elif isinstance(obj, bytes):
            self._scalar("bytes", obj)
        elif isinstance(obj, np.float32):
            self._scalar("floats", float(obj))
        elif isinstance(obj, (float, np.floating)):
            self._scalar("doubles", float(obj))
        elif isinstance(obj, np.ndarray):
            if obj.dtype == object:
                raise TypeError("object ndarrays are not supported")
            self._scalar("ndarrays", len(self.ndarrays))
            self.ndarrays.append(obj)
        elif isinstance(obj, dict):
            if self.dicts is None:
                self.dicts = ([0], _Sequence(self.ndarrays),
                              _Sequence(self.ndarrays))
            offsets, keys, vals = self.dicts
            self._push("dicts", len(offsets) - 1)
            for k, v in obj.items():
                keys.append(k)
                vals.append(v)
            offsets.append(offsets[-1] + len(obj))
        elif isinstance(obj, (list, tuple, set)):
            kind = {list: "lists", tuple: "tuples", set: "sets"}.get(type(obj))
            if kind is None:
                raise TypeError(f"cannot serialize {type(obj)!r} in the "
                                "pyarrow-0.14 legacy format")
            if kind not in self.subs:
                self.subs[kind] = ([0], _Sequence(self.ndarrays))
            offsets, sub = self.subs[kind]
            self._push(kind, len(offsets) - 1)
            for item in obj:
                sub.append(item)
            offsets.append(offsets[-1] + len(obj))
        else:
            raise TypeError(f"cannot serialize {type(obj)!r} in the "
                            "pyarrow-0.14 legacy format")

    def emit(self, name: str, out: "_Body") -> _T:
        """Append this union's nodes and buffers (pre-order) to ``out``;
        -> its Field table."""
        kinds = self.kinds or ["nones"]         # a union has >= 1 child
        out.node(len(self.type_ids), 0)
        out.buffer(b"")                          # validity (V4)
        out.buffer(np.asarray(self.type_ids, np.int8).tobytes())
        out.buffer(np.asarray(self.offsets, np.int32).tobytes())
        children = [self._emit_child(kind, out) for kind in kinds]
        return _field(name, _UNION, _T(f0=("h", _DENSE), f1=_V(
            range(len(kinds)), "i")), children)

    def _emit_child(self, kind: str, out: "_Body") -> _T:
        values = self.values.get(kind, [])
        if kind == "nones":
            out.node(len(values), len(values))
            return _field(kind, _NULL, _T())
        if kind in ("strings", "bytes"):
            data = [v.encode("utf-8") for v in values] \
                if kind == "strings" else values
            out.node(len(data), 0)
            out.buffer(b"")
            out.buffer(np.concatenate(
                [[0], np.cumsum([len(d) for d in data])]).astype(
                    np.int32).tobytes())
            out.buffer(b"".join(data))
            return _field(kind, _UTF8 if kind == "strings" else _BINARY, _T())
        if kind in _SCALAR_KINDS:
            tag, dtype = _SCALAR_KINDS[kind]
            out.node(len(values), 0)
            out.buffer(b"")
            out.buffer(np.packbits(np.asarray(values, bool),
                                   bitorder="little").tobytes()
                       if tag == _BOOL else
                       np.asarray(values, dtype).tobytes())
            return _field(kind, tag, _type_table(tag, np.dtype(dtype)
                                                 if dtype else None))
        if kind == "dicts":
            offsets, keys, vals = self.dicts
            out.node(len(offsets) - 1, 0)
            out.buffer(b"")                      # the struct's validity
            children = [_emit_list(name, offsets, seq, out)
                        for name, seq in (("keys", keys), ("vals", vals))]
            return _field(kind, _STRUCT, _T(), children)
        offsets, sub = self.subs[kind]
        return _emit_list(kind, offsets, sub, out)


def _emit_list(name: str, offsets: list, sub: _Sequence, out) -> _T:
    out.node(len(offsets) - 1, 0)
    out.buffer(b"")
    out.buffer(np.asarray(offsets, np.int32).tobytes())
    return _field(name, _LIST, _T(), [sub.emit("item", out)])


def _field(name: str, tag: int, type_table: _T, children=()) -> _T:
    return _T(f0=name, f1=("?", True), f2=("B", tag), f3=type_table,
             f5=_V(children))


class _Body:
    """A record batch's field nodes and buffers; each buffer at a multiple
    of 8 in the body."""

    def __init__(self):
        self.nodes, self.buffers, self.data = [], [], bytearray()

    def node(self, length: int, null_count: int) -> None:
        self.nodes.append((length, null_count))

    def buffer(self, data: bytes) -> None:
        self.buffers.append((len(self.data), len(data)))
        self.data += data
        self.data += b"\0" * _pad_to(len(self.data), 8)


def _tensor_message(arr: np.ndarray, legacy: bool) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.bool_:                  # pyarrow keeps bools as uint8
        arr = arr.view(np.uint8)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    if arr.dtype.kind in "iu":
        tag, type_table = _INT, _type_table(_INT, arr.dtype)
    elif arr.dtype in _PRECISION:
        tag, type_table = _FLOAT, _type_table(_FLOAT, arr.dtype)
    else:
        raise TypeError(f"cannot serialize a {arr.dtype} ndarray")
    data = arr.tobytes()
    header = _T(f0=("B", tag), f1=type_table,
               f2=_V([_T(f0=("q", int(n))) for n in arr.shape]),
               f3=_V([int(s) for s in arr.strides], "q"),
               f4=("struct:qq", (0, len(data))))
    return _message(_TENSOR, header, len(data), legacy) + data


def serialize(obj, legacy_envelope: bool = True) -> bytes:
    """``pyarrow.serialize(obj).to_buffer()`` of pyarrow 0.14 (the legacy
    envelope, the released TED datasets) or, with ``legacy_envelope``
    False, of pyarrow 0.15-0.17 (the continuation-marker envelope)."""
    ndarrays: list[np.ndarray] = []
    top = _Sequence(ndarrays)
    top.append(obj)                  # the [value] wrapping: one row
    body = _Body()
    field = top.emit("list", body)

    out = bytearray(struct.pack("<iii", 0, len(ndarrays), 0))
    out += b"\0" * _pad_to(len(out), _ALIGN_STREAM)
    out += _message(_SCHEMA, _T(f0=("h", 0), f1=_V([field])), 0,
                    legacy_envelope)
    out += _message(_RECORD_BATCH, _T(
        f0=("q", 1), f1=_V(body.nodes, "qq"), f2=_V(body.buffers, "qq")),
        len(body.data), legacy_envelope)
    out += body.data
    out += struct.pack("<i", 0) if legacy_envelope else \
        struct.pack("<Ii", _CONTINUATION, 0)
    for arr in ndarrays:
        out += b"\0" * _pad_to(len(out), _ALIGN_TENSOR)
        out += _tensor_message(arr, legacy_envelope)
    return bytes(out)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

def _dtype(tag: int, t: _Table) -> np.dtype:
    if tag == _INT:
        bits, signed = t.scalar(0, "i"), t.scalar(1, "?", False)
        return np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
    if tag == _FLOAT:
        return np.dtype(["<f2", "<f4", "<f8"][t.scalar(0, "h")])
    raise ValueError(f"unsupported arrow type {tag} in a legacy value")


class _Column:
    """A decoded array of the record batch: ``get(i)`` -> its i-th value
    as the 0.14 deserializer returns it."""

    def __init__(self, field: _Table, batch: "_Batch"):
        self.name = field.string(0)
        self.tag, t = _union(field, 2)
        self.children = field.tables(5)
        length, null_count = batch.node()
        if self.tag == _NULL:                  # no buffers
            return
        if self.tag != _UNION or batch.version < _V5:
            batch.buffer()                      # validity, all valid
        if null_count:
            raise ValueError(f"nulls in the legacy child {self.name!r}")
        if self.tag == _UNION:
            if t.scalar(0, "h") != _DENSE:
                raise ValueError("a sparse union in a legacy value")
            ids = t.scalars(1, "i") or list(range(len(self.children)))
            self.type_ids = np.frombuffer(batch.buffer(), np.int8,
                                          length).tolist()
            self.offsets = np.frombuffer(batch.buffer(), "<i4",
                                         length).tolist()
            cols = [_Column(c, batch) for c in self.children]
            self.by_id = dict(zip(ids, cols))
        elif self.tag in (_UTF8, _BINARY):
            offs = np.frombuffer(batch.buffer(), "<i4", length + 1)
            data = batch.buffer()
            self.values = [bytes(data[a:b]) for a, b in
                           zip(offs[:-1].tolist(), offs[1:].tolist())]
            if self.tag == _UTF8:
                self.values = [v.decode("utf-8") for v in self.values]
        elif self.tag == _BOOL:
            bits = np.frombuffer(batch.buffer(), np.uint8)
            self.values = np.unpackbits(bits, bitorder="little")[
                :length].astype(bool).tolist()
        elif self.tag in (_INT, _FLOAT):
            dtype = _dtype(self.tag, t)
            values = np.frombuffer(batch.buffer(), dtype, length)
            self.values = list(values) if dtype == np.float32 else \
                values.tolist()
            self.int32 = dtype == np.int32
        elif self.tag == _LIST:
            self.offsets = np.frombuffer(batch.buffer(), "<i4",
                                         length + 1).tolist()
            self.child = _Column(self.children[0], batch)
        elif self.tag == _STRUCT:
            cols = [_Column(c, batch) for c in self.children]
            self.fields = {c.name: c for c in cols}
        else:
            raise ValueError(f"unsupported arrow type {self.tag} "
                             f"({self.name!r}) in a legacy value")

    def get(self, i: int, ndarrays: list):
        """GetValue (deserialize.cc) of a union's i-th slot."""
        child = self.by_id[self.type_ids[i]]
        off = self.offsets[i]
        tag = child.tag
        if tag == _NULL:
            return None
        if tag == _INT and child.int32:
            if child.name in ("ndarrays", "tensors"):
                return ndarrays[child.values[off]]
            raise ValueError(f"unsupported int32 union child {child.name!r}")
        if tag in (_BOOL, _INT, _UTF8, _BINARY, _FLOAT):
            return child.values[off]
        if tag == _LIST:
            sub = child.child
            items = [sub.get(j, ndarrays) for j in
                     range(child.offsets[off], child.offsets[off + 1])]
            if child.name == "tuples":
                return tuple(items)
            if child.name == "sets":
                return set(items)
            return items
        keys, vals = child.fields["keys"], child.fields["vals"]
        span = range(keys.offsets[off], keys.offsets[off + 1])
        return dict(zip([keys.child.get(j, ndarrays) for j in span],
                        [vals.child.get(j, ndarrays) for j in span]))


class _Batch:
    """The record batch's field nodes and buffers, taken in order."""

    def __init__(self, buf, batch: _Table, body: int, version: int):
        self.buf, self.body = buf, body
        self.nodes = iter(batch.structs(1, "qq"))
        self.buffers = iter(batch.structs(2, "qq"))
        self.version = version

    def node(self):
        return next(self.nodes)

    def buffer(self):
        off, n = next(self.buffers)
        return self.buf[self.body + off:self.body + off + n]


def _read_tensor(buf, pos: int):
    msg, body, end = _read_message(buf, pos)
    if msg is None or msg.scalar(1, "B") != _TENSOR:
        raise ValueError("malformed legacy value: a tensor message expected")
    t = msg.table(2)
    tag, type_table = _union(t, 0)
    dtype = _dtype(tag, type_table)
    shape = tuple(d.scalar(0, "q") for d in t.tables(2))
    strides = tuple(t.scalars(3, "q"))
    offset, length = t.struct(4, "qq")
    data = buf[body + offset:body + offset + length]
    arr = np.ndarray(shape, dtype, buffer=data,
                     strides=strides if strides else None)
    return np.array(arr), end


def deserialize(buf) -> object:
    """``pyarrow.deserialize(buf)`` of a legacy-serialized value, in either
    envelope."""
    buf = memoryview(buf).cast("B")
    num_tensors, num_ndarrays, num_buffers = struct.unpack_from("<iii", buf)
    if num_tensors or num_buffers:
        raise ValueError("pyarrow.Tensor / Buffer components are not used "
                         "by the reference datasets and are unsupported")
    pos = 12 + _pad_to(12, _ALIGN_STREAM)
    schema = batch = None
    while True:
        msg, body, end = _read_message(buf, pos)
        pos = end
        if msg is None:
            break
        kind = msg.scalar(1, "B")
        if kind == _SCHEMA:
            schema = msg.table(2)
        elif kind == _RECORD_BATCH:
            if batch is not None:
                raise ValueError("malformed legacy value: two batches")
            batch = (msg.table(2), body, msg.scalar(0, "h"))
    if schema is None or batch is None or batch[0].scalar(0, "q") != 1:
        raise ValueError("malformed legacy-serialized object")
    ndarrays = []
    for _ in range(num_ndarrays):
        pos += _pad_to(pos, _ALIGN_TENSOR)
        arr, pos = _read_tensor(buf, pos)
        ndarrays.append(arr)
    table, body, version = batch
    reader = _Batch(buf, table, body, version)
    column = _Column(schema.tables(1)[0], reader)
    return column.get(0, ndarrays)
