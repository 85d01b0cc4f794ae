"""Dependency-free LMDB read/write: the `lmdb` IO backend's format code.

Port of `image_restoration_tpu/utils/lmdb_util.py:56-374`, pure Python over
`mmap` and `struct` (the `lmdb` C binding is not a dependency):

  * ``LmdbReader`` mmaps ``data.mdb``, picks the live meta page (higher
    txnid of pages 0/1), and walks the main-DB B-tree: branch pages hold
    48-bit child pgnos split across (mn_lo, mn_hi, mn_flags); leaf nodes
    hold inline values or, with F_BIGDATA, an 8-byte overflow pgno whose
    P_OVERFLOW pages carry the value. Reads are lock-free on the mmap: the
    datasets only read finished databases.
  * ``LmdbWriter`` emits a valid single-snapshot database (sorted keys,
    bottom-up B-tree, overflow pages for big values, both meta pages) that
    the C lmdb accepts and that ``LmdbReader`` round-trips.
  * ``make_lmdb_from_imgs`` builds ``<name>.lmdb/`` from an image folder
    (the reference's ``basicsr/utils/lmdb_util.py:9-153`` layout).

Layout constants follow lmdb.h / mdb.c (64-bit, little-endian, 4K pages).
"""

from __future__ import annotations

import mmap
import os
import struct
from os import path as osp
from typing import Dict, Iterable, List, Optional, Tuple

PAGESIZE = 4096
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# leaf-node flags
F_BIGDATA = 0x01

_PGHDR = struct.Struct("<QHHHH")     # pgno, pad, flags, pb_lower, pb_upper
_NODEHDR = struct.Struct("<HHHH")    # mn_lo, mn_hi, mn_flags, mn_ksize
_META_BODY = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")     # pad, flags, depth, branch, leaf,
#                                      overflow, entries, root
_META_TAIL = struct.Struct("<QQ")    # last_pg, txnid
P_INVALID = 0xFFFFFFFFFFFFFFFF


class LmdbReader:
    """Read-only LMDB environment over mmap (main DB, default comparator)."""

    def __init__(self, path: str):
        # accept either the .lmdb dir (reference layout) or data.mdb itself
        if osp.isdir(path):
            path = osp.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        self._db = meta0 if meta0[1] >= meta1[1] else meta1
        self.entries = self._db[0][6]
        self._root = self._db[0][7]

    def _read_meta(self, pageno: int):
        off = pageno * PAGESIZE
        flags = _PGHDR.unpack_from(self._mm, off)[2]
        if not flags & P_META:
            raise ValueError(f"page {pageno} is not a meta page")
        body = off + _PGHDR.size
        magic, version, _, _ = _META_BODY.unpack_from(self._mm, body)
        if magic != MDB_MAGIC:
            raise ValueError("not an LMDB file (bad magic)")
        if version != MDB_DATA_VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        main_db = _DB.unpack_from(self._mm, body + _META_BODY.size +
                                  _DB.size)  # dbs[1] == MAIN_DBI
        txnid = _META_TAIL.unpack_from(
            self._mm, body + _META_BODY.size + 2 * _DB.size)[1]
        return main_db, txnid

    # ---------------------------------------------------------- tree walk

    def _page(self, pgno: int) -> int:
        return pgno * PAGESIZE

    def _nodes(self, pg_off: int) -> List[int]:
        lower = _PGHDR.unpack_from(self._mm, pg_off)[3]
        nkeys = (lower - _PGHDR.size) // 2
        return [pg_off + struct.unpack_from("<H", self._mm,
                                            pg_off + _PGHDR.size + 2 * i)[0]
                for i in range(nkeys)]

    def _node_key(self, node_off: int) -> bytes:
        ksize = _NODEHDR.unpack_from(self._mm, node_off)[3]
        start = node_off + _NODEHDR.size
        return self._mm[start:start + ksize]

    def _leaf_value(self, node_off: int) -> bytes:
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._mm, node_off)
        dsize = lo | (hi << 16)
        dstart = node_off + _NODEHDR.size + ksize
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._mm, dstart)
            data_off = self._page(ovpg) + _PGHDR.size
            return self._mm[data_off:data_off + dsize]
        return self._mm[dstart:dstart + dsize]

    def get(self, key) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("ascii")
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            pg_off = self._page(pgno)
            flags = _PGHDR.unpack_from(self._mm, pg_off)[2]
            nodes = self._nodes(pg_off)
            if flags & P_BRANCH:
                # rightmost child whose separator key <= key
                # (node 0 has an empty key = leftmost child)
                lo_i, hi_i, child = 1, len(nodes) - 1, 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    if self._node_key(nodes[mid]) <= key:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                n = nodes[child]
                lo, hi, nflags, _ = _NODEHDR.unpack_from(self._mm, n)
                pgno = lo | (hi << 16) | (nflags << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, len(nodes) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._node_key(nodes[mid])
                    if k == key:
                        return self._leaf_value(nodes[mid])
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def keys(self) -> Iterable[bytes]:
        """In-order key iteration (cursor walk)."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            pg_off = self._page(stack.pop())
            flags = _PGHDR.unpack_from(self._mm, pg_off)[2]
            nodes = self._nodes(pg_off)
            if flags & P_BRANCH:
                for n in reversed(nodes):
                    lo, hi, nflags, _ = _NODEHDR.unpack_from(self._mm, n)
                    stack.append(lo | (hi << 16) | (nflags << 32))
            else:
                for n in nodes:
                    yield self._node_key(n)

    def close(self):
        self._mm.close()
        self._f.close()


# ------------------------------------------------------------------ writer


def _leaf_node(key: bytes, value: bytes, ov_pgno: Optional[int]) -> bytes:
    if ov_pgno is None:
        hdr = _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16, 0,
                            len(key))
        return hdr + key + value
    hdr = _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16, F_BIGDATA,
                        len(key))
    return hdr + key + struct.pack("<Q", ov_pgno)


def _branch_node(key: bytes, child: int) -> bytes:
    return _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                         (child >> 32) & 0xFFFF, len(key)) + key


def _pack_page(pgno: int, flags: int, node_blobs: List[bytes]) -> bytes:
    ptrs_end = _PGHDR.size + 2 * len(node_blobs)
    upper = PAGESIZE
    offsets = []
    body = {}
    for blob in node_blobs:
        size = len(blob) + (len(blob) & 1)  # 2-byte node alignment
        upper -= size
        offsets.append(upper)
        body[upper] = blob
    if upper < ptrs_end:
        raise ValueError("page overflow")
    page = bytearray(PAGESIZE)
    _PGHDR.pack_into(page, 0, pgno, 0, flags, ptrs_end, upper)
    for i, off in enumerate(offsets):
        struct.pack_into("<H", page, _PGHDR.size + 2 * i, off)
    for off, blob in body.items():
        page[off:off + len(blob)] = blob
    return bytes(page)


class LmdbWriter:
    """One-shot sorted bulk writer producing a valid data.mdb."""

    def __init__(self, lmdb_dir: str, map_size: Optional[int] = None):
        os.makedirs(lmdb_dir, exist_ok=True)
        self.path = osp.join(lmdb_dir, "data.mdb")
        self._items: List[Tuple[bytes, bytes]] = []

    def put(self, key, value: bytes):
        if isinstance(key, str):
            key = key.encode("ascii")
        self._items.append((key, bytes(value)))

    def commit(self):
        items = sorted(self._items)
        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0/1 are meta
        n_overflow = 0

        # values too big to inline go to overflow page runs
        nodemax = (PAGESIZE - _PGHDR.size) // 2 - 8
        processed = []
        for key, value in items:
            inline = _NODEHDR.size + len(key) + len(value) <= nodemax
            if inline:
                processed.append((key, value, None))
            else:
                npg = -(-(_PGHDR.size + len(value)) // PAGESIZE)
                blob = bytearray(npg * PAGESIZE)
                _PGHDR.pack_into(blob, 0, next_pg, 0, P_OVERFLOW, npg & 0xFFFF,
                                 (npg >> 16) & 0xFFFF)
                blob[_PGHDR.size:_PGHDR.size + len(value)] = value
                for i in range(npg):
                    pages[next_pg + i] = bytes(
                        blob[i * PAGESIZE:(i + 1) * PAGESIZE])
                processed.append((key, value, next_pg))
                next_pg += npg
                n_overflow += npg

        # leaf pages: greedy fill
        leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        n_leaf = 0
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_used = _PGHDR.size

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_used, next_pg, n_leaf
            if not cur_nodes:
                return
            pages[next_pg] = _pack_page(next_pg, P_LEAF, cur_nodes)
            leaves.append((cur_first, next_pg))
            next_pg += 1
            n_leaf += 1
            cur_nodes, cur_first, cur_used = [], None, _PGHDR.size

        for key, value, ovpg in processed:
            blob = _leaf_node(key, value, ovpg)
            need = 2 + len(blob) + (len(blob) & 1)
            if cur_nodes and cur_used + need > PAGESIZE:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(blob)
            cur_used += need
        flush_leaf()

        # branch levels, bottom-up
        level = leaves
        depth = 1
        n_branch = 0
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            cur_nodes, cur_first, cur_used = [], None, _PGHDR.size
            first_in_page = True

            def flush_branch():
                nonlocal cur_nodes, cur_first, cur_used, next_pg, \
                    n_branch, first_in_page
                if not cur_nodes:
                    return
                pages[next_pg] = _pack_page(next_pg, P_BRANCH, cur_nodes)
                nxt.append((cur_first, next_pg))
                next_pg += 1
                n_branch += 1
                cur_nodes, cur_first, cur_used = [], None, _PGHDR.size
                first_in_page = True

            for first_key, child in level:
                key = b"" if first_in_page else first_key
                blob = _branch_node(key, child)
                need = 2 + len(blob) + (len(blob) & 1)
                if cur_nodes and cur_used + need > PAGESIZE:
                    flush_branch()
                    key = b""
                    blob = _branch_node(key, child)
                    need = 2 + len(blob) + (len(blob) & 1)
                if cur_first is None:
                    cur_first = first_key
                cur_nodes.append(blob)
                cur_used += need
                first_in_page = False
            flush_branch()
            level = nxt

        root = level[0][1] if level else P_INVALID
        if not items:
            depth = 0
        last_pg = next_pg - 1 if next_pg > 2 else 1

        def meta(pgno: int, txnid: int) -> bytes:
            page = bytearray(PAGESIZE)
            _PGHDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            off = _PGHDR.size
            _META_BODY.pack_into(page, off, MDB_MAGIC, MDB_DATA_VERSION, 0,
                                 max((last_pg + 1) * PAGESIZE, 1 << 20))
            off += _META_BODY.size
            # FREE_DBI: empty
            _DB.pack_into(page, off, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
            off += _DB.size
            # MAIN_DBI
            _DB.pack_into(page, off, 0, 0, depth, n_branch, n_leaf,
                          n_overflow, len(items), root)
            off += _DB.size
            _META_TAIL.pack_into(page, off, last_pg, txnid)
            return bytes(page)

        with open(self.path, "wb") as f:
            f.write(meta(0, 0))
            f.write(meta(1, 1))
            for pgno in range(2, next_pg):
                f.write(pages[pgno])


def make_lmdb_from_imgs(data_path: str, lmdb_path: str, img_path_list,
                        keys, compress_level: int = 1):
    """Build `<name>.lmdb/` with data.mdb + meta_info.txt (ref
    lmdb_util.py:9-153). Values are cv2-encoded PNG buffers; keys are the
    image stems, meta lines are `key (h,w,c) compress_level`. The images
    are read and encoded on a thread pool (cv2 releases the interpreter
    lock), in order, so the database is the same as one built serially."""
    import concurrent.futures

    import cv2

    def encode(rel):
        img = cv2.imread(osp.join(data_path, rel), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(osp.join(data_path, rel))
        ok, buf = cv2.imencode(
            ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        if not ok:
            raise ValueError(f"png encode failed for {rel}")
        c = 1 if img.ndim == 2 else img.shape[2]
        return img.shape[:2], c, buf.tobytes()

    writer = LmdbWriter(lmdb_path)
    meta_lines = []
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        for key, ((h, w), c, value) in zip(keys, pool.map(encode,
                                                          img_path_list)):
            writer.put(key, value)
            meta_lines.append(f"{key}.png ({h},{w},{c}) {compress_level}")
    writer.commit()
    with open(osp.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.write("\n".join(meta_lines) + "\n")
    return len(meta_lines)
