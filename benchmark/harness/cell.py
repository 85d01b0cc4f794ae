"""One run of one cell: find its pieces by name, build the system, time the
window, read the trace, check the answers, print the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`:

    benchmark/configs/<config>.json     sizes, precision, program kind
    benchmark/reference/<config>.py     the plain reference (`schema`, ...)
    benchmark/counts/<config>.py        frozen operations and bytes
    benchmark/programs/<program>.py     the config's `"program"`:
        `build(spec, params, seed, device)` → the system under test, and
        `reference(spec, params, seed, device, control)` → the same
        entry computed by the reference module
    benchmark/traffic/<traffic>.json    the mix: its `"driver"` and
                                        parameters
    benchmark/drivers/<driver>.py       `Driver`, the loop that drives
                                        the mix (harness/loop.py)
    benchmark/limits/<workload>.json    the limit of each number compared
    benchmark/metrics/<metric>.py       `read(rec)` → value or None

so a later change adds a cell, a mix, a loop kind, a program kind or a
metric by adding files and entries. Nothing here imports JAX or the JAX
package; the result is refused (exit 3) if the process holds either once
the window has closed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import torch

from .trace import Tracer
from .weights import draw_params

BENCH_DIR = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "image_restoration_tpu")
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAKS = {"tf32_flops": 495e12, "bf16_flops": 989e12, "int8_ops": 1979e12,
         "hbm_bytes": 3.35e12}


class Spec:
    """The pieces of one workload, resolved by name under `bench_dir`
    (the `benchmark/` folder) and `bench_dir/../BENCHMARK.json`."""

    def __init__(self, workload: str, bench_dir: Path = BENCH_DIR):
        self.bench_dir = Path(bench_dir)
        doc = json.loads((self.bench_dir.parent / "BENCHMARK.json")
                         .read_text())
        cells = {w["name"]: w for w in doc["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.cell = cells[workload]
        cfg_entry = next(c for c in doc["configs"]
                         if c["name"] == self.cell["config"])
        self.config = json.loads(
            (self.bench_dir.parent / cfg_entry["file"]).read_text())
        self.traffic = self._json("traffic", self.cell["traffic"])
        self.limits = self._json("limits", workload)["limits"]
        self.reference = self._module("reference", self.cell["config"])
        self.counts = self._module("counts", self.cell["config"])
        self.program = self._module("programs", self.config["program"])
        self.driver = self._module("drivers", self.traffic["driver"]).Driver

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in doc["end_to_end"] if mine(m)]
        self.per_layer = [m for m in doc["per_layer"] if mine(m)]

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench_dir / kind / f"{name}.json")
                          .read_text())

    def _module(self, kind: str, name: str) -> ModuleType:
        return load_module(self.bench_dir / kind / f"{name}.py",
                           f"benchmark.{kind}.{name}")

    def metric_reader(self, name: str) -> Callable[[dict], Optional[float]]:
        return self._module("metrics", name).read


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file `path` as module `name` (once per process)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def build(spec: Spec, seed: int, device):
    """(params, program): the weights drawn from the seed on `device` by the
    reference's `schema`, and the system under test built from them by the
    configuration's program kind."""
    params = draw_params(spec.reference.schema(spec.config["network"]),
                         seed, device)
    return params, spec.program.build(spec, params, seed, device)


def reference(spec: Spec, params, seed: int, device, control: bool = False):
    """The plain reference in the program's shape, from the same weights;
    `control=True` runs it in the precision below the configuration's
    (`config["control"]`)."""
    return spec.program.reference(spec, params, seed, device, control)


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(spec: Spec, seed: int, seconds: float, trace: bool, device,
        started: float, substitute: Optional[Callable] = None) -> dict:
    """One run; returns the result object (not yet printed).

    `started` is the process's start on `time.monotonic`'s clock.
    `substitute` returns a program that replaces the system under test before
    set-up (the control, and the faults of the tests); it is called as
    `substitute(program, params)`."""
    device = torch.device(device)
    marks = [("interpreter and imports", time.monotonic())]
    params, program = build(spec, seed, device)
    if substitute is not None:
        program = substitute(program, params)
    marks.append(("device, weights and program", time.monotonic()))
    driver = spec.driver(program, spec.traffic, seed, device, seconds)
    marks.append(("inputs", time.monotonic()))
    tracer = Tracer(device) if trace else None
    driver.setup(tracer)
    marks.append(("warm-up", time.monotonic()))
    rec = driver.window(seconds, tracer, started)
    info = device_info(device)
    times = [started] + [t for _, t in marks]
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, _), a, b in zip(marks, times,
                                                            times[1:])),
        file=sys.stderr, flush=True)
    for err in rec.get("errors", [])[:5]:
        print(f"failed call: {err}", file=sys.stderr, flush=True)
    if tracer is not None:
        rec.update(tracer.reduce())
    driver.close()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    numbers = driver.check(reference(spec, params, seed, device))
    del params
    # a missing or unreadable answer has no number (JSON null) and fails
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": spec.limits[k]} for k, v in numbers.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    rec.update(counts=spec.counts, peaks=PEAKS, config=spec.config)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = spec.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        info["busy_s"] = rec["busy_s"]
        info["window_s"] = rec["window_s"]
    out = {"correct": bool(ok and rec["failed"] == 0 and checks),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": info}
    if trace:
        out["breakdown"] = rec["breakdown"]
    out["checks"] = checks
    return out


def report(out: dict) -> None:
    """Each number compared beside its limit as the last lines on stderr,
    then the result as the last line on stdout."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
