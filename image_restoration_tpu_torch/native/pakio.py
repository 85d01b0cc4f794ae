"""ctypes binding for the native pak reader (`src/pakio.cpp`).

Port of `image_restoration_tpu/native/pakio.py:22-89`. The shared library
is built at first use with the host's C++ compiler (`$CXX`, else `g++`)
from the port's own copy of the source, into
`image_restoration_tpu_torch/_build/` (ignored by git) under a name that
carries a hash of the source and flags, so an edited source is rebuilt.
Nothing here runs at import time. `utils/file_client._PakBackend` falls
back to Python reads only when no compiler is found
(`CompilerNotFound`); any other failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "pakio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


class CompilerNotFound(RuntimeError):
    """No C++ compiler to build the native reader with."""


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise CompilerNotFound(
            f"no C++ compiler ({os.environ.get('CXX', 'g++')}) on PATH to "
            f"build {SRC.name}")
    return cxx


def library_path() -> Path:
    """The built library, compiling it first if it is not on disk."""
    text = SRC.read_bytes()
    digest = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libpakio_{digest[:16]}.so"
    if so.exists():
        return so
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SRC} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            lib.pak_open.restype = ctypes.c_void_p
            lib.pak_open.argtypes = [ctypes.c_char_p]
            lib.pak_size.restype = ctypes.c_int64
            lib.pak_size.argtypes = [ctypes.c_void_p]
            lib.pak_read.restype = ctypes.c_int64
            lib.pak_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_void_p]
            lib.pak_read_batch.restype = ctypes.c_int
            lib.pak_read_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.pak_close.restype = None
            lib.pak_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativePakReader:
    """mmap-backed reader of one `.pak` blob with threaded batch reads."""

    def __init__(self, pak_path: str, workers: int = 4):
        self._lib = _load()
        self._handle = self._lib.pak_open(os.fsencode(pak_path))
        if not self._handle:
            raise OSError(f"pak_open failed for {pak_path}")
        self.workers = workers
        self.size = self._lib.pak_size(self._handle)

    def _check(self, offset: int, length: int):
        if offset < 0 or length < 0 or offset + length > self.size:
            raise ValueError(f"record {offset}+{length} lies outside the "
                             f"{self.size}-byte blob")

    def read(self, offset: int, length: int) -> bytes:
        self._check(offset, length)
        buf = np.empty(length, np.uint8)
        got = self._lib.pak_read(self._handle, offset, length,
                                 buf.ctypes.data_as(ctypes.c_void_p))
        if got != length:
            raise OSError(f"pak_read failed at {offset}+{length}")
        return buf.tobytes()

    def read_batch(self, offsets, lengths) -> list:
        """The records at `offsets`/`lengths`, read by the library's thread
        pool into one buffer."""
        offsets = np.ascontiguousarray(offsets, np.uint64)
        lengths = np.ascontiguousarray(lengths, np.uint64)
        for o, n in zip(offsets.tolist(), lengths.tolist()):
            self._check(o, n)
        dst_offsets = np.zeros_like(lengths)
        np.cumsum(lengths[:-1], out=dst_offsets[1:])
        buf = np.empty(int(lengths.sum()), np.uint8)
        rc = self._lib.pak_read_batch(
            self._handle, len(offsets),
            offsets.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
            buf.ctypes.data_as(ctypes.c_void_p),
            dst_offsets.ctypes.data_as(ctypes.c_void_p), self.workers)
        if rc != 0:
            raise OSError("pak_read_batch failed")
        return [buf[o:o + n].tobytes()
                for o, n in zip(dst_offsets.tolist(), lengths.tolist())]

    def close(self):
        if self._handle:
            self._lib.pak_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
