"""What the benchmark may import: nothing under `benchmark/` imports JAX or
the JAX package, and the references import nothing of the port. Module
names are compared by their whole top-level name (the part before the
first dot): `image_restoration_tpu_torch` begins with the JAX package's
name and is not it."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "image_restoration_tpu"}
PORT = "image_restoration_tpu_torch"


def _imported(path: Path) -> set:
    """Top-level names of every absolute import in the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _relative_imports(path: Path) -> list:
    return [n for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.ImportFrom) and n.level > 0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def test_the_comparison_is_by_whole_top_level_name():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("image_restoration_tpu")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert PORT not in _imported(path)
    assert not _relative_imports(path)  # each reference stands alone


def test_a_run_loads_no_jax():
    """Import what a run imports (the harness, every program kind, driver,
    reader, reference and count, and the port's modules that the programs
    use) in a fresh interpreter, then look at sys.modules."""
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness import cell, readings
import image_restoration_tpu_torch.infer
import image_restoration_tpu_torch.serve.engine_restorer
import image_restoration_tpu_torch.serve.sr_engine
for w in {[w["name"] for w in doc["workloads"]]!r}:
    spec = cell.Spec(w)
    for m in spec.end_to_end + spec.per_layer:
        spec.metric_reader(m["name"])
print(cell.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
