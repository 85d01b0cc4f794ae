"""File IO backends: the datasets read image bytes through `FileClient`.

Port of `image_restoration_tpu/utils/file_client.py:25-273`:

  * 'disk': plain files;
  * 'lmdb': `<name>.lmdb/data.mdb` databases, read by the dependency-free
    mmap reader of `utils/lmdb_util.py`, so reference-prepared datasets
    load as they are;
  * 'pak': the packed-record store (one blob `x.pak` + a binary index
    `x.pak.idx`), read by the native reader (`native/pakio.py`, built with
    the host's C++ compiler at first use); only where no compiler is found
    does it read with Python, and it logs which reader it took;
  * 'memcached': a client of the standard memcached text protocol over
    stdlib sockets, one `host:port` per line of `server_list_cfg`, several
    servers sharded by md5(key). The reference's proprietary `mc` binding,
    which JAX tries first, is not ported.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import struct
from os import path as osp
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

_MAGIC = b"IRPK"


def write_pak(records, pak_path: str) -> None:
    """records: iterable of (key: str, data: bytes). Writes .pak + .pak.idx."""
    index = []
    with open(pak_path, "wb") as blob:
        offset = 0
        for key, data in records:
            blob.write(data)
            index.append((key, offset, len(data)))
            offset += len(data)
    with open(pak_path + ".idx", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(index)))
        for key, off, length in index:
            kb = key.encode("utf-8")
            f.write(struct.pack("<I", len(kb)))
            f.write(kb)
            f.write(struct.pack("<QQ", off, length))


def read_pak_index(pak_path: str) -> Dict[str, Tuple[int, int]]:
    """{key: (offset, length)} from `pak_path`.idx."""
    index = {}
    with open(pak_path + ".idx", "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"bad pak index magic in {pak_path}.idx")
        (count,) = struct.unpack("<Q", f.read(8))
        for _ in range(count):
            (klen,) = struct.unpack("<I", f.read(4))
            key = f.read(klen).decode("utf-8")
            off, length = struct.unpack("<QQ", f.read(16))
            index[key] = (off, length)
    return index


def make_pak_from_folder(folder: str, pak_path: str,
                         suffix=("png", "jpg", "jpeg", "bmp")) -> int:
    """Pack every image under `folder` (keys: the sorted relative paths,
    values: the files' bytes); returns the count."""
    from .misc import scandir
    paths = sorted(scandir(folder, suffix=suffix, recursive=True))

    def gen():
        for rel in paths:
            with open(osp.join(folder, rel), "rb") as f:
                yield rel, f.read()

    write_pak(gen(), pak_path)
    return len(paths)


class _PakBackend:
    """Random reads of a `.pak` by key; `reader` says which reader serves
    them: "native" or, without a C++ compiler, "python"."""

    def __init__(self, pak_path: str):
        from ..native.pakio import CompilerNotFound, NativePakReader
        self.pak_path = pak_path
        self.index = read_pak_index(pak_path)
        self._native = self._fd = None
        try:
            self._native = NativePakReader(pak_path)
            self.reader = "native"
        except CompilerNotFound as e:
            self._fd = os.open(pak_path, os.O_RDONLY)
            self.reader = "python"
            log.warning("pak %s: %s; reading with Python", pak_path, e)
        log.info("pak %s: %s reader, %d records", pak_path, self.reader,
                 len(self.index))

    def get(self, key: str) -> bytes:
        off, length = self.index[key]
        if self._native is not None:
            return self._native.read(off, length)
        data = os.pread(self._fd, length, off)
        if len(data) != length:
            raise OSError(f"short read of {key!r} in {self.pak_path}")
        return data

    def keys(self):
        return self.index.keys()

    def close(self):
        if self._native is not None:
            self._native.close()
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class _LmdbBackend:
    """LMDB reads, one reader per database; `client_keys` names each of
    `db_paths` (default: one database named 'default')."""

    def __init__(self, db_paths, client_keys="default"):
        from .lmdb_util import LmdbReader
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, (str, bytes, os.PathLike)):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError("client_keys and db_paths must have the same "
                             "length")
        self._dbs = {k: LmdbReader(str(p))
                     for k, p in zip(client_keys, db_paths)}

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        value = self._dbs[client_key].get(str(filepath))
        if value is None:
            raise KeyError(f"key {filepath!r} not found in lmdb "
                           f"'{client_key}'")
        return value

    def keys(self, client_key: str = "default"):
        return [k.decode("ascii") for k in self._dbs[client_key].keys()]

    def close(self):
        for db in self._dbs.values():
            db.close()


class _MemcachedBackend:
    """Memcached reads over the text protocol (``get <key>`` →
    ``VALUE <key> <flags> <bytes>\\r\\n<data>\\r\\nEND\\r\\n``); one
    connection per server, reconnected once on a stale socket."""

    def __init__(self, server_list_cfg: str):
        with open(server_list_cfg) as f:
            servers = [ln.strip() for ln in f if ln.strip() and ":" in ln]
        if not servers:
            raise ValueError(f"{server_list_cfg} names no host:port server")
        self._servers = servers
        self._socks = [None] * len(servers)

    def _sock(self, idx):
        if self._socks[idx] is None:
            host, _, port = self._servers[idx].rpartition(":")
            s = socket.create_connection((host, int(port)), timeout=30)
            self._socks[idx] = (s, s.makefile("rb"))
        return self._socks[idx]

    def _shard(self, key: str) -> int:
        if len(self._servers) == 1:
            return 0
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:4],
                              "big") % len(self._servers)

    def get(self, filepath: str) -> bytes:
        key = str(filepath)
        idx = self._shard(key)
        for attempt in range(2):
            sock, rfile = self._sock(idx)
            try:
                sock.sendall(f"get {key}\r\n".encode())
                header = rfile.readline()
            except OSError:
                self._close(idx)
                if attempt:
                    raise
                continue
            if header.startswith(b"END"):
                raise KeyError(f"key {key!r} not found in memcached")
            if not header.startswith(b"VALUE "):
                self._close(idx)
                raise ConnectionError(
                    f"memcached protocol error: {header[:80]!r}")
            data = rfile.read(int(header.split()[3]))
            rfile.read(2)            # the value's trailing \r\n
            tail = rfile.readline()  # END\r\n
            if not tail.startswith(b"END"):
                self._close(idx)
                raise ConnectionError(
                    f"memcached protocol error: {tail[:80]!r}")
            return data
        raise ConnectionError(f"memcached server {self._servers[idx]} "
                              "closed the connection")

    def _close(self, idx):
        if self._socks[idx] is not None:
            sock, rfile = self._socks[idx]
            rfile.close()
            sock.close()
            self._socks[idx] = None

    def close(self):
        for i in range(len(self._socks)):
            self._close(i)


class FileClient:
    """One interface over the backends: `get(path_or_key)` → bytes.

    lmdb takes its store as `db_paths`, pak as `pak_path`; memcached
    takes `server_list_cfg` (other keys of a config's io_backend, such as
    the `mc` binding's `client_cfg`, are not read)."""

    def __init__(self, backend: str = "disk", **kwargs):
        self.backend = backend
        if backend == "disk":
            self._client = None
        elif backend == "memcached":
            self._client = _MemcachedBackend(kwargs["server_list_cfg"])
        elif backend == "lmdb":
            self._client = _LmdbBackend(kwargs["db_paths"],
                                        kwargs.get("client_keys", "default"))
        elif backend == "pak":
            self._client = _PakBackend(kwargs["pak_path"])
        else:
            raise ValueError(f"unsupported file backend {backend!r}")

    def get(self, filepath: str, client_key: Optional[str] = None) -> bytes:
        if self.backend == "disk":
            with open(filepath, "rb") as f:
                return f.read()
        if self.backend == "lmdb" and client_key is not None:
            return self._client.get(filepath, client_key)
        return self._client.get(filepath)

    def keys(self):
        """The keys of an lmdb or pak store."""
        return self._client.keys()

    def close(self):
        if self._client is not None:
            self._client.close()
