"""BENCHMARK.json against the contract's form, and the harness finding a
new configuration, traffic mix, metric, loop kind and program kind by
name, with no file edited."""

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from benchmark.harness import cell

BENCH = Path(cell.BENCH_DIR)
ROOT = BENCH.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics(doc):
    return doc["end_to_end"] + doc["per_layer"]


def test_top_level_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert isinstance(DOC["run_seconds"], int)
    assert len(DOC["command"]) <= 32
    for word in DOC["command"]:
        assert not word.startswith("/") and ".." not in word
    n = len(DOC["workloads"])
    assert 1 <= n <= 24 and 1 <= len(DOC["configs"]) <= 24
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_allowed_keys_and_names():
    doc = DOC
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    for entry in doc["configs"] + doc["workloads"] + _metrics(doc):
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
    for m in _metrics(doc):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in _metrics(doc)]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks():
    doc = DOC
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in doc["end_to_end"]}
    assert e2e["setup_s"] == cells
    for c in cells:
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(c in m.get("workloads", cells) for m in doc["per_layer"])
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]]
    layers = {}
    for m in doc["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in DOC["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(workload):
    spec = cell.Spec(workload)
    assert callable(spec.driver)
    assert callable(spec.program.build) and callable(spec.program.reference)
    assert hasattr(spec.reference, "schema")
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert spec.limits


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_traffic_and_metric_need_no_edit(tmp_path):
    """Copies of existing kinds: a config, a mix and a metric added as
    files and entries are what a run finds."""
    bench, before = _copy(tmp_path)
    src = json.loads((bench / "configs" / "gfpgan_ocr_256.json").read_text())
    src["name"] = "gfpgan_ocr_256_copy"
    (bench / "configs" / "gfpgan_ocr_256_copy.json").write_text(
        json.dumps(src))
    for kind in ("reference", "counts"):
        shutil.copy(bench / kind / "gfpgan_ocr_256.py",
                    bench / kind / "gfpgan_ocr_256_copy.py")
    (bench / "traffic" / "batch8.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "batch32.json").read_text()),
             batch=8)))
    (bench / "limits" / "copy.batch8.json").write_text(json.dumps(
        {"limits": {"image_mean_lsb": 1.0}}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return rec['calls'] / rec['elapsed_s']\n")
    _add_entries(tmp_path, "gfpgan_ocr_256_copy", "copy.batch8", "batch8",
                 "calls_per_s")

    spec = cell.Spec("copy.batch8", bench_dir=bench)
    assert spec.traffic["batch"] == 8
    assert spec.config["name"] == "gfpgan_ocr_256_copy"
    assert [m["name"] for m in spec.per_layer] == ["calls_per_s"]
    assert spec.metric_reader("calls_per_s")(
        {"calls": 6, "elapsed_s": 2.0}) == 3.0
    assert spec.reference.__file__.endswith("gfpgan_ocr_256_copy.py")
    assert _unchanged(bench, before)


# a program kind, a loop kind, a configuration and its reference that the
# benchmark does not have: a colour inverter answered one image a call
NEW_PROGRAM = """
import numpy as np


class Inverter:
    def __init__(self, levels):
        self.levels = levels

    def __call__(self, img):
        return (self.levels - img.astype(np.int16)).astype(np.uint8)


def build(spec, params, seed, device):
    return Inverter(spec.config["network"]["levels"])


def reference(spec, params, seed, device, control=False):
    return lambda img: spec.reference.invert(img, spec.config["network"])
"""
NEW_REFERENCE = """
def schema(network):
    return []


def invert(img, network):
    return (network["levels"] - img.astype("int16")).astype("uint8")
"""
NEW_DRIVER = """
import numpy as np

from benchmark.harness.compare import worst_block_mean
from benchmark.harness.loop import ClosedLoop


class Driver(ClosedLoop):
    def __init__(self, program, traffic, seed, device, seconds):
        super().__init__(program, traffic, seed, device, seconds)
        traffic.setdefault("answers_per_call", 1)
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 256, (traffic["pool"], 8, 8, 3),
                                 dtype=np.uint8)

    def _call(self, i):
        k = i % len(self.imgs)
        return (k, self.program(self.imgs[k])), 1

    def check(self, reference):
        worst = 0.0
        for k, out in self.keep.items:
            worst = max(worst, worst_block_mean(out, reference(self.imgs[k]),
                                                8))
        return {"image_mean_lsb": worst}
"""


def test_a_new_program_kind_and_loop_kind_need_no_edit(tmp_path):
    """A program kind and a loop kind the benchmark lacks, added as files
    beside a new configuration and mix, are found by name and run: the
    run is correct, and a broken program under them is not."""
    bench, before = _copy(tmp_path)
    (bench / "programs" / "inverter.py").write_text(NEW_PROGRAM)
    (bench / "drivers" / "one_by_one.py").write_text(NEW_DRIVER)
    (bench / "reference" / "invert8.py").write_text(NEW_REFERENCE)
    (bench / "counts" / "invert8.py").write_text("")
    (bench / "configs" / "invert8.json").write_text(json.dumps(
        {"name": "invert8", "program": "inverter",
         "network": {"levels": 255}}))
    (bench / "traffic" / "one_by_one.json").write_text(json.dumps(
        {"driver": "one_by_one", "pool": 4, "keep": 2, "warmup_calls": 1,
         "trace_after": 0.3, "trace_seconds": 0.1}))
    (bench / "limits" / "invert8.one.json").write_text(json.dumps(
        {"limits": {"image_mean_lsb": 0.0}}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return rec['calls'] / rec['elapsed_s']\n")
    _add_entries(tmp_path, "invert8", "invert8.one", "one_by_one",
                 "calls_per_s")

    spec = cell.Spec("invert8.one", bench_dir=bench)
    assert spec.program.__file__.endswith("inverter.py")
    out = cell.run(spec, 2 ** 35 + 1, 0.2, False, "cpu", time.monotonic())
    assert out["correct"] and out["attempted"] > 0, out

    def off_by_one(program, params):
        return lambda img: program(img) ^ 1

    out = cell.run(spec, 2 ** 35 + 1, 0.2, False, "cpu", time.monotonic(),
                   substitute=off_by_one)
    assert not out["correct"]
    assert _unchanged(bench, before)


def _copy(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    return bench, _digest(bench)


def _unchanged(bench, before):
    after = _digest(bench)
    return {k: v for k, v in after.items() if k in before} == before


def _add_entries(root, config, workload, traffic, metric):
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": config, "source": "x",
                           "file": f"benchmark/configs/{config}.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": workload, "config": config,
                             "traffic": traffic, "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": metric, "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "setup_s",
                             "workloads": [workload]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
