"""A pure-Python LMDB reader and writer (the port of
ha2g_tpu/data/lmdb_mini.py: the same constants, and given the same
records the writer writes the same bytes).

The released TED Gesture / TED Expressive datasets are LMDB environments
(reference lmdb_data_loader.py:93-115 opens them read-only with the
`lmdb` package, which neither machine of the port has).  LMDB's on-disk
format is stable ("MDB_DATA_VERSION 1", unchanged since 2011), so this
module reads and writes it from the liblmdb structures (lmdb.h / mdb.c):

page = 4096 bytes, header 16 bytes:
  0  uint64 mp_pgno
  8  uint16 mp_pad
  10 uint16 mp_flags        (1=BRANCH 2=LEAF 4=OVERFLOW 8=META 0x20=LEAF2)
  12 uint16 mp_lower | uint32 mp_pages (OVERFLOW pages: chain length)
  14 uint16 mp_upper
  16 uint16 mp_ptrs[]       (node offsets from page start)

meta page (pages 0 and 1) carries MDB_meta at offset 16:
  0  uint32 mm_magic = 0xBEEFC0DE      4  uint32 mm_version = 1
  8  uint64 mm_address                 16 uint64 mm_mapsize
  24 MDB_db mm_dbs[2] (FREE, MAIN), each 48 bytes:
     0 uint32 md_pad, 4 uint16 md_flags, 6 uint16 md_depth,
     8/16/24 uint64 branch/leaf/overflow pages, 32 uint64 md_entries,
     40 uint64 md_root (0xFFFF.. = empty)
  120 uint64 mm_last_pg               128 uint64 mm_txnid
the live meta is the one with the larger txnid.

node (at each mp_ptrs offset):
  0 uint16 mn_lo, 2 uint16 mn_hi, 4 uint16 mn_flags, 6 uint16 mn_ksize,
  8 key bytes, then data.
  leaf:   datasize = lo | hi<<16; flag F_BIGDATA(0x01): the data is a
          uint64 overflow pgno, the value lives at overflow_page+16,
          contiguous across mp_pages pages.
  branch: child pgno = lo | hi<<16 | flags<<32.

Writer: nodes are 2-byte aligned (sizes rounded up to even); a leaf node
moves to overflow pages when 8+klen+dlen exceeds nodemax =
((4096-16)/2) & ~1 = 2040 (mdb.c me_nodemax); overflow page count =
OVPAGES(sz) = (15+sz)//4096 + 1.  Keys sort ascending (memcmp).  DUPSORT,
LEAF2 and sub-databases are not implemented: the reference datasets use
none of them.
"""

from __future__ import annotations

import struct
from pathlib import Path

PAGE = 4096
HDR = 16
MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x1, 0x2, 0x4, 0x8, 0x20
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x1, 0x2, 0x4
P_INVALID = 0xFFFFFFFFFFFFFFFF
NODEMAX = ((PAGE - HDR) // 2) & ~1  # 2040


def _data_path(path: str | Path) -> Path:
    p = Path(path)
    return p / "data.mdb" if p.is_dir() else p


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class MiniLmdbReader:
    """Read-only cursor over an LMDB environment's main database."""

    def __init__(self, path: str | Path):
        import mmap
        # memory-map: the released TED environments are tens of GB and
        # must not be materialized in RAM
        self._f = open(_data_path(path), "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.buf = memoryview(self._mm)
        metas = [self._read_meta(0), self._read_meta(1)]
        self.meta = max(metas, key=lambda m: m["txnid"])

    def close(self):
        self.buf.release()
        self._mm.close()
        self._f.close()

    def _read_meta(self, pgno: int) -> dict:
        off = pgno * PAGE + HDR
        magic, version = struct.unpack_from("<II", self.buf, off)
        if magic != MAGIC:
            raise ValueError(f"not an LMDB data file (magic {magic:#x})")
        if version != 1:
            raise ValueError(f"unsupported LMDB data version {version}")
        main_off = off + 24 + 48  # mm_dbs[1]
        (md_pad, md_flags, md_depth, branch_pages, leaf_pages,
         overflow_pages, entries, root) = struct.unpack_from(
            "<IHHQQQQQ", self.buf, main_off)
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, off + 120)
        if md_flags & ~0x08:  # MDB_INTEGERKEY(0x08) tolerated, rest not
            raise ValueError(f"unsupported main-db flags {md_flags:#x}")
        return {"entries": entries, "root": root, "txnid": txnid,
                "depth": md_depth, "last_pg": last_pg}

    # -- page decoding ----------------------------------------------------
    def _page(self, pgno: int):
        off = pgno * PAGE
        flags, = struct.unpack_from("<H", self.buf, off + 10)
        return off, flags

    def _nodes(self, off: int):
        lower, = struct.unpack_from("<H", self.buf, off + 12)
        n = (lower - HDR) >> 1
        for i in range(n):
            ptr, = struct.unpack_from("<H", self.buf, off + HDR + 2 * i)
            yield off + ptr

    def _leaf_value(self, node_off: int, ksize: int) -> memoryview:
        lo, hi, flags = struct.unpack_from("<HHH", self.buf, node_off)
        size = lo | (hi << 16)
        data_off = node_off + 8 + ksize
        if flags & (F_SUBDATA | F_DUPDATA):
            raise ValueError("DUPSORT/sub-database values not supported")
        if flags & F_BIGDATA:
            ov_pgno, = struct.unpack_from("<Q", self.buf, data_off)
            start = ov_pgno * PAGE + HDR
            return self.buf[start:start + size]
        return self.buf[data_off:data_off + size]

    def items(self, root: int | None = None):
        """Yield (key, value) over the main DB in key order."""
        root = self.meta["root"] if root is None else root
        if root == P_INVALID:
            return
        stack = [root]
        while stack:
            pgno = stack.pop()
            off, flags = self._page(pgno)
            if flags & P_LEAF2:
                raise ValueError("LEAF2 (fixed-size key) pages unsupported")
            if flags & P_BRANCH:
                # push children in reverse so traversal stays in key order
                children = []
                for node_off in self._nodes(off):
                    lo, hi, nflags = struct.unpack_from("<HHH", self.buf,
                                                        node_off)
                    children.append(lo | (hi << 16) | (nflags << 32))
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                for node_off in self._nodes(off):
                    ksize, = struct.unpack_from("<H", self.buf, node_off + 6)
                    key = bytes(self.buf[node_off + 8:node_off + 8 + ksize])
                    yield key, self._leaf_value(node_off, ksize)
            else:
                raise ValueError(f"unexpected page flags {flags:#x} "
                                 f"at page {pgno}")

    def stat(self) -> dict:
        return {"entries": self.meta["entries"]}

    def get(self, key: bytes):
        for k, v in self.items():
            if k == key:
                return v
        return None


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _even(n: int) -> int:
    return n + (n & 1)


class _PageBuilder:
    def __init__(self):
        self.pages: list[bytearray] = [bytearray(PAGE), bytearray(PAGE)]

    def alloc(self) -> int:
        self.pages.append(bytearray(PAGE))
        return len(self.pages) - 1

    def node_page(self, pgno: int, flags: int,
                  nodes: list[bytes]):
        """Fill a BRANCH/LEAF page with pre-rendered node blobs."""
        page = self.pages[pgno]
        lower, upper = HDR + 2 * len(nodes), PAGE
        assert lower <= upper
        for i, blob in enumerate(nodes):
            upper -= _even(len(blob))
            struct.pack_into("<H", page, HDR + 2 * i, upper)
            page[upper:upper + len(blob)] = blob
        struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)


def write_lmdb(path: str | Path, records: dict[bytes, bytes],
               subdir: bool = True):
    """Write an LMDB environment holding `records` in the main database.

    Produces the exact on-disk layout liblmdb writes for a fresh
    single-transaction bulk load, readable by the real `lmdb` package and
    by MiniLmdbReader.  Returns the data file path."""
    p = Path(path)
    if subdir:
        p.mkdir(parents=True, exist_ok=True)
    out = _data_path(p) if subdir else p
    items = sorted(records.items())
    b = _PageBuilder()

    n_overflow = 0
    # ---- leaves (+ overflow chains) --------------------------------------
    leaves: list[tuple[bytes, int]] = []  # (first key, pgno)
    cur_nodes: list[bytes] = []
    cur_first: bytes | None = None
    cur_lower, cur_upper = HDR, PAGE

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_lower, cur_upper
        if cur_nodes:
            pgno = b.alloc()
            b.node_page(pgno, P_LEAF, cur_nodes)
            leaves.append((cur_first, pgno))
        cur_nodes, cur_first = [], None
        cur_lower, cur_upper = HDR, PAGE

    for key, value in items:
        assert len(key) <= 511, "LMDB max key size"
        if 8 + len(key) + len(value) > NODEMAX:
            # OVPAGES(size): header on the first page only, value bytes
            # contiguous across the chain
            n_pages = (HDR - 1 + len(value)) // PAGE + 1
            first = b.alloc()
            for _ in range(n_pages - 1):
                b.alloc()
            n_overflow += n_pages
            struct.pack_into("<QHHI", b.pages[first], 0, first, 0,
                             P_OVERFLOW, n_pages)
            pos = 0  # next value byte to place; page `first` starts at +16
            for i in range(n_pages):
                dst = b.pages[first + i]
                start = HDR if i == 0 else 0
                take = min(PAGE - start, len(value) - pos)
                dst[start:start + take] = value[pos:pos + take]
                pos += take
            node = (struct.pack("<HHHH", len(value) & 0xFFFF,
                                len(value) >> 16, F_BIGDATA, len(key))
                    + key + struct.pack("<Q", first))
        else:
            node = (struct.pack("<HHHH", len(value) & 0xFFFF,
                                len(value) >> 16, 0, len(key))
                    + key + value)
        need = _even(len(node))
        if cur_lower + 2 + need > cur_upper:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(node)
        cur_lower += 2
        cur_upper -= need
    flush_leaf()

    # ---- branch levels ----------------------------------------------------
    n_branch = 0
    level = leaves
    depth = 1 if leaves else 0
    while len(level) > 1:
        next_level: list[tuple[bytes, int]] = []
        group: list[bytes] = []
        group_first: bytes | None = None
        lower, upper = HDR, PAGE

        def flush_branch():
            nonlocal group, group_first, lower, upper, n_branch
            if group:
                pgno = b.alloc()
                # node 0's key is never consulted on branch pages
                # (mdb.c mdb_node_search starts at 1); store it empty
                group[0] = group[0][:6] + struct.pack("<H", 0)
                b.node_page(pgno, P_BRANCH, group)
                n_branch += 1
                next_level.append((group_first, pgno))
            group, group_first = [], None
            lower, upper = HDR, PAGE

        for first_key, child in level:
            blob = struct.pack("<HHHH", child & 0xFFFF,
                               (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF,
                               len(first_key)) + first_key
            need = _even(len(blob))
            if lower + 2 + need > upper:
                flush_branch()
            if group_first is None:
                group_first = first_key
            group.append(blob)
            lower += 2
            upper -= need
        flush_branch()
        level = next_level
        depth += 1

    root = level[0][1] if level else P_INVALID
    last_pg = len(b.pages) - 1

    # ---- meta pages --------------------------------------------------------
    def meta_page(pgno: int, txnid: int, main_root: int, main_depth: int,
                  entries: int):
        page = b.pages[pgno]
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
        o = HDR
        struct.pack_into("<II", page, o, MAGIC, 1)
        struct.pack_into("<QQ", page, o + 8, 0, max((last_pg + 1) * PAGE,
                                                    1 << 20))
        free_db = struct.pack("<IHHQQQQQ", 0, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, main_depth, n_branch,
                              len(leaves), n_overflow, entries, main_root)
        page[o + 24:o + 72] = free_db
        page[o + 72:o + 120] = main_db
        struct.pack_into("<QQ", page, o + 120, last_pg, txnid)

    meta_page(0, 0, P_INVALID, 0, 0)
    meta_page(1, 1, root, depth if items else 0, len(items))

    out.write_bytes(b"".join(bytes(pg) for pg in b.pages))
    if subdir:
        (p / "lock.mdb").write_bytes(b"")
    return out
