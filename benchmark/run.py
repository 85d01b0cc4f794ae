#!/usr/bin/env python3
"""Run one cell of the benchmark of image_restoration_tpu_torch.

    python3 benchmark/run.py --workload ocr256.batch32 --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout on a machine with an NVIDIA GPU. Prints the
numbers compared beside their limits as the last lines on standard error
and one JSON object as the last line on standard output. Exits non-zero,
printing no result, without a CUDA device, and if JAX or the JAX package
was loaded into this process by the time the window closed.

Kernel and compile caches stay inside the checkout at fixed paths
(`image_restoration_tpu_torch/_build/`, where the port builds its kernels,
and `.bench_cache/`), so only a checkout's first run builds.
"""

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_start_monotonic() -> float:
    """When this process started, on `time.monotonic`'s clock."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    started_since_boot = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - started_since_boot
    return time.monotonic() - age


def main(argv=None) -> int:
    started = process_start_monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell

    spec = cell.Spec(args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell.run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   started)
    found = cell.forbidden_modules()
    if found:
        print(f"refused: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    cell.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
