"""The port's pure-Python LMDB writer and reader against the JAX
package's: given the same records the two writers write the same bytes,
and the port reads what the JAX writer wrote, in the structural cases a
foreign writer (liblmdb) produces: a B-tree of depth 3 or more, values
over 3 or more overflow pages, a live meta page in either slot, and pages
out of key order."""

import struct

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.data import lmdb_mini as jlm

from ha2g_torch.data import lmdb_mini as plm


def _records(kind: str) -> dict:
    rng = np.random.default_rng({"small": 0, "overflow": 1, "deep": 2,
                                 "boundary": 3, "fuzz": 4}[kind])
    if kind == "small":
        return {b"a": b"1", b"b": b"", b"k" * 40: b"v" * 100}
    if kind == "overflow":        # branches and chains of 1-5 pages
        sizes = [3 * plm.PAGE - 200, 3 * plm.PAGE + 123, 4 * plm.PAGE + 1,
                 17, plm.NODEMAX - 20, 5 * plm.PAGE]
        return {f"{i:010d}".encode(): rng.bytes(sizes[i % 6] + i)
                for i in range(60)}
    if kind == "deep":            # two branch levels above the leaves
        return {f"key-{i:06d}".encode(): rng.bytes(300) for i in range(2500)}
    if kind == "boundary":        # the largest in-page value and the next
        key = b"0000000001"
        n = plm.NODEMAX - 8 - len(key)
        return {key: b"x" * n, b"0000000002": b"y" * (n + 1)}
    return {rng.bytes(int(rng.integers(1, 60))): rng.bytes(int(rng.choice(
        [0, 3, 200, 1900, 2100, 5000, 13000]))) for _ in range(300)}


def test_constants_equal_jax():
    for name in ("PAGE", "HDR", "MAGIC", "P_BRANCH", "P_LEAF", "P_OVERFLOW",
                 "P_META", "F_BIGDATA", "P_INVALID", "NODEMAX"):
        assert getattr(plm, name) == getattr(jlm, name), name
    assert plm.NODEMAX == 2040


@pytest.mark.parametrize("kind", ["empty", "small", "overflow", "deep",
                                  "boundary", "fuzz"])
def test_writer_is_byte_identical_to_jax(tmp_path, kind):
    records = {} if kind == "empty" else _records(kind)
    jpath = jlm.write_lmdb(tmp_path / "jax", records)
    ppath = plm.write_lmdb(tmp_path / "port", records)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert (tmp_path / "port" / "lock.mdb").exists()
    # and without a subdirectory
    single = plm.write_lmdb(tmp_path / "one.mdb", records, subdir=False)
    assert single.read_bytes() == jpath.read_bytes()


def _read(path) -> dict:
    r = plm.MiniLmdbReader(path)
    try:
        items = [(k, bytes(v)) for k, v in r.items()]
        assert [k for k, _ in items] == sorted(k for k, _ in items)
        assert r.stat()["entries"] == len(items)
        return dict(items)
    finally:
        r.close()


@pytest.mark.parametrize("kind", ["overflow", "deep", "fuzz"])
def test_reader_reads_jax_files(tmp_path, kind):
    records = _records(kind)
    path = jlm.write_lmdb(tmp_path / kind, records)
    r = plm.MiniLmdbReader(path)
    meta = dict(r.meta)
    some = next(iter(records))
    assert bytes(r.get(some)) == records[some]
    r.close()
    if kind == "deep":
        assert meta["depth"] >= 3, meta
    if kind == "overflow":
        assert max(len(v) for v in records.values()) >= 4 * plm.PAGE
    assert _read(path) == records


def test_reader_takes_the_meta_with_the_larger_txnid(tmp_path):
    """liblmdb alternates between the two meta pages a commit."""
    records = {b"a": b"1", b"b": b"2"}
    path = jlm.write_lmdb(tmp_path / "meta", records)
    raw = bytearray(path.read_bytes())
    meta0 = plm.HDR

    def patch(txnid, root=None, entries=None):
        struct.pack_into("<Q", raw, meta0 + 128, txnid)
        if root is not None:
            struct.pack_into("<Q", raw, meta0 + 72 + 40, root)
            struct.pack_into("<Q", raw, meta0 + 72 + 32, entries)
        path.write_bytes(bytes(raw))

    patch(2, plm.P_INVALID, 0)      # meta 0 live: a later, emptied tree
    assert _read(path) == {}
    patch(0)                        # meta 0 stale again: meta 1's records
    assert _read(path) == records


def _fragment(raw: bytes) -> bytes:
    """The page units of a data file (single pages, whole overflow chains)
    in reverse order, every page pointer moved with them: pages in
    allocation order, as an incrementally written file has them."""
    P = plm.PAGE
    units, pg = [], 2
    while pg < len(raw) // P:
        flags, = struct.unpack_from("<H", raw, pg * P + 10)
        n = struct.unpack_from("<I", raw, pg * P + 12)[0] \
            if flags & plm.P_OVERFLOW else 1
        units.append((pg, n))
        pg += n
    moved, pos = {}, 2
    for first, n in reversed(units):
        moved[first] = pos
        pos += n
    out = bytearray(len(raw))
    out[:2 * P] = raw[:2 * P]
    for first, n in units:
        out[moved[first] * P:(moved[first] + n) * P] = \
            raw[first * P:(first + n) * P]
    for first, _ in units:
        base = moved[first] * P
        struct.pack_into("<Q", out, base, moved[first])
        flags, lower = struct.unpack_from("<HH", out, base + 10)
        if flags & plm.P_OVERFLOW:
            continue
        for i in range((lower - plm.HDR) >> 1):
            node = base + struct.unpack_from("<H", out,
                                             base + plm.HDR + 2 * i)[0]
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", out, node)
            if flags & plm.P_BRANCH:
                child = moved[lo | (hi << 16) | (nflags << 32)]
                struct.pack_into("<HHH", out, node, child & 0xFFFF,
                                 (child >> 16) & 0xFFFF, child >> 32)
            elif nflags & plm.F_BIGDATA:
                ov, = struct.unpack_from("<Q", out, node + 8 + ksize)
                struct.pack_into("<Q", out, node + 8 + ksize, moved[ov])
    for meta in (0, 1):
        at = meta * P + plm.HDR + 72 + 40
        root, = struct.unpack_from("<Q", out, at)
        if root != plm.P_INVALID:
            struct.pack_into("<Q", out, at, moved[root])
    return bytes(out)


def test_reader_reads_fragmented_page_order(tmp_path):
    rng = np.random.default_rng(5)
    records = {f"frag-{i:04d}".encode(): rng.bytes(
        [10, 500, plm.NODEMAX + 100, 2 * plm.PAGE + 7][i % 4])
        for i in range(400)}
    raw = jlm.write_lmdb(tmp_path / "frag", records).read_bytes()
    frag = tmp_path / "frag.mdb"
    frag.write_bytes(_fragment(raw))
    assert frag.read_bytes() != raw
    r = jlm.MiniLmdbReader(frag)         # the fragmented file is sound
    assert r.meta["depth"] >= 2
    assert {k: bytes(v) for k, v in r.items()} == records
    r.close()
    assert _read(frag) == records
