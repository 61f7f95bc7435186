"""The port's pure-Python pyarrow-0.14 codec (``arrow_legacy``, no
pyarrow) against the JAX package's (``pyarrow_legacy``, on a modern
pyarrow): the port reads the JAX package's bytes in both envelopes, the
JAX package (so pyarrow's own IPC reader and flatbuffer verifier) reads
the port's, a metadata-V5 stream written by pyarrow reads too, and the
wire layout, dtypes, float32 scalars and the refusal of object arrays
hold."""

import struct

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.data import pyarrow_legacy as jal
from tests.test_foreign_bytes import ADVERSARIAL, _random_obj, _req

from ha2g_torch.data import arrow_legacy as pal

RNG = np.random.default_rng(0)
TENSORS = {"a": RNG.normal(size=(7, 5)).astype(np.float32),
           "b": np.arange(11, dtype=np.int64),
           "c": [RNG.normal(size=(2, 3, 4)).astype(np.float16),
                 np.asarray(3.25, np.float64).reshape(())],
           "d": np.asarray([], np.int32), "e": np.zeros((2, 0, 3)),
           "f": np.array([True, False, True]),
           "g": (RNG.normal(size=(6, 6)) * 9).astype(np.int16)[::2, ::3],
           "u": np.arange(300, dtype=np.uint16)}
OBJECTS = list(ADVERSARIAL) + [
    None, True, -3, "héllo", b"raw", 2.5, np.float32(1.25), [], {}, (),
    set(), {1, 2}, [[1, [2, [3, None]]]], TENSORS,
    {"vid": "v0", "clips": [{"words": [["hi", 0.1, 0.4]] * 5,
                             "skeletons_3d": np.ones((9, 10, 3), np.float32),
                             "start_frame_no": 3, "end_time": 4.5}]}]
IDS = [f"obj{i}" for i in range(len(OBJECTS))]


def _assert_same(got, want):
    """Equal values of equal types, ndarrays with equal dtypes and
    shapes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert type(got) is dict and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert type(got) is type(want) and got == want, (got, want)


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("obj", OBJECTS, ids=IDS)
def test_port_reads_jax_bytes(obj, legacy):
    buf = jal.serialize(obj, legacy_envelope=legacy)
    _assert_same(pal.deserialize(buf), jal.deserialize(buf))


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("obj", OBJECTS, ids=IDS)
def test_jax_reads_port_bytes(obj, legacy):
    buf = pal.serialize(obj, legacy_envelope=legacy)
    want = jal.deserialize(jal.serialize(obj, legacy_envelope=legacy))
    _assert_same(jal.deserialize(buf), want)
    _assert_same(pal.deserialize(buf), want)
    _req(pal.deserialize(buf), obj)


@pytest.mark.parametrize("seed", range(6))
def test_random_nested_objects_both_ways(seed):
    rng = np.random.default_rng(seed)
    obj = [_random_obj(rng) for _ in range(4)]
    legacy = bool(seed % 2)
    _req(jal.deserialize(pal.serialize(obj, legacy_envelope=legacy)), obj)
    _req(pal.deserialize(jal.serialize(obj, legacy_envelope=legacy)), obj)


_LEAVES = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 63 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=8)
           | st.binary(max_size=8)
           | st.floats(width=32, allow_nan=False).map(np.float32)
           | st.lists(st.integers(-100, 100), max_size=5).map(
               lambda v: np.asarray(v, np.int32)))
_OBJS = st.recursive(_LEAVES, lambda kids: (
    st.lists(kids, max_size=4) | st.lists(kids, max_size=4).map(tuple)
    | st.dictionaries(st.text(max_size=4), kids, max_size=4)), max_leaves=20)


@settings(max_examples=60, deadline=None, database=None)
@given(obj=_OBJS, legacy=st.booleans())
def test_round_trip_property(obj, legacy):
    buf = pal.serialize(obj, legacy_envelope=legacy)
    _req(pal.deserialize(buf), obj)
    _req(jal.deserialize(buf), obj)


def test_wire_layout():
    """Three int32 counts, the stream at 8 in the legacy envelope, each
    tensor message at a multiple of 64; the continuation marker in the
    0.15 envelope."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = pal.serialize({"x": arr, "y": [arr, arr]})
    assert struct.unpack_from("<iii", buf) == (0, 3, 0)
    assert buf[12:16] == b"\0" * 4 and buf[16:20] != b"\xff" * 4
    reader = pa.BufferReader(buf[16:])
    list(pa.ipc.open_stream(reader))        # through the end marker
    pos = 16 + reader.tell()
    for _ in range(3):
        pos += (-pos) % 64
        assert buf[pos:pos + 4] != b"\xff" * 4
        src = pa.BufferReader(buf[pos:])
        np.testing.assert_array_equal(pa.ipc.read_tensor(src).to_numpy(),
                                      arr)
        pos += src.tell()
    modern = pal.serialize({"x": arr}, legacy_envelope=False)
    assert modern[16:20] == b"\xff" * 4


def test_reads_a_metadata_v5_stream():
    """Metadata V5 drops a union's validity buffer: a stream pyarrow writes
    in V5 reads as the V4 one does."""
    obj = {"a": [1, None, "s", (2.5, np.float32(1.5))], "b": {True: b"x"}}
    builder = jal._SequenceBuilder([])
    builder.append(obj)
    batch = pa.record_batch([builder.finish()], names=["list"])
    sink = pa.BufferOutputStream()
    opts = pa.ipc.IpcWriteOptions(metadata_version=pa.ipc.MetadataVersion.V5)
    with pa.ipc.new_stream(sink, batch.schema, options=opts) as writer:
        writer.write_batch(batch)
    buf = struct.pack("<iii", 0, 0, 0) + b"\0" * 4 + \
        sink.getvalue().to_pybytes()
    _assert_same(pal.deserialize(buf), jal.deserialize(buf))
    _req(pal.deserialize(buf), obj)


def test_dtypes_and_float32_scalars_are_kept():
    for dtype in (np.float16, np.float32, np.float64, np.int8, np.int16,
                  np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                  np.uint64):
        arr = np.arange(6, dtype=dtype).reshape(2, 3)
        got = pal.deserialize(pal.serialize(arr))
        assert got.dtype == dtype and got.shape == (2, 3)
        np.testing.assert_array_equal(got, arr)
        assert got.flags.writeable
    # a big-endian array is written little-endian (the JAX package hands
    # its bytes to pyarrow as they are), so pyarrow reads its values too
    big = np.arange(6, dtype=">i4")
    for read in (pal.deserialize, jal.deserialize):
        got = read(pal.serialize(big))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, big)
    got = pal.deserialize(pal.serialize([np.float32(1.25), 1.25]))
    assert type(got[0]) is np.float32 and type(got[1]) is float


def test_object_arrays_and_unknown_types_are_refused():
    with pytest.raises(TypeError):
        pal.serialize(np.array([object()]))
    with pytest.raises(TypeError):
        pal.serialize(frozenset([1]))
    with pytest.raises(TypeError):
        pal.serialize(np.zeros(2, np.complex64))
