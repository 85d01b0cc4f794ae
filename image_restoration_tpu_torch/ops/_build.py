"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for sm_90a into a shared library, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>_<hash>.so csrc/<name>.cu

The build runs at first use, from the sources in the package alone, into
`image_restoration_tpu_torch/_build/` (ignored by git); the file name carries
a hash of the source and flags, so an edited source is rebuilt. Nothing here
runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_built: dict = {}


@dataclass(frozen=True)
class Build:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already on disk
    log: str        # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/ at first use on a CUDA machine")


def _compile(name: str) -> Build:
    src = CSRC_DIR / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if so.exists():
        return Build(name, so, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return Build(name, so, seconds, proc.stdout + proc.stderr)


def build_all(names) -> list:
    """Compile the named kernels, one nvcc per source, all started together.

    Returns their `Build` records in the order given. Already-built
    libraries are reused.
    """
    names = list(names)
    with _lock:
        todo = [n for n in names if n not in _built]
        with concurrent.futures.ThreadPoolExecutor(max(1, len(todo))) as ex:
            for n, b in zip(todo, ex.map(_compile, todo)):
                _built[n] = b
        return [_built[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    (b,) = build_all([name])
    return ctypes.CDLL(str(b.path))
