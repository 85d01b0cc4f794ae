"""`correct` comes out false when the timed path is broken underneath, and
when the control (the reference one precision below the configuration's)
stands in the program's place.

The CPU tests skip the harness's look for a chip and drive the rest of a
run (`cell.run`) at the sizes of `tiny.py`. The card-only tests
(marker `cuda`) do the same at each cell's own size:

    python -m pytest -m cuda benchmark/tests
"""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, readings

from .tiny import control_spec, tiny_spec

CELLS = ["ocr256.batch32", "srx4.wide", "srx4.small"]
SEED = 2 ** 34 + 21


def half_batch(program, params):
    """Half of each batch computed, the rest answered by their mean."""
    if hasattr(program, "restore_batch_u8"):
        inner = program.restore_batch_u8

        def restore(imgs):
            n = len(imgs)
            if n < 2:
                return inner(imgs)
            out = inner(imgs[:n // 2])
            mean = out.mean(0, keepdims=True).round().astype(np.uint8)
            return np.concatenate([out, np.repeat(mean, n - n // 2, 0)])

        program.restore_batch_u8 = restore
        return program
    inner_serve = program.serve

    def serve(x):
        n = x.shape[0]
        out = inner_serve(x[:n // 2])
        mean = out.float().mean(0, keepdim=True).round().to(out.dtype)
        return torch.cat([out, mean.expand(n - n // 2, *out.shape[1:])])

    program.serve = serve
    return program


class _Altered:
    """An SR engine whose answer is altered where it is produced."""

    def __init__(self, engine):
        self.engine = engine

    def __call__(self, img):
        out = self.engine(img)
        out[: out.shape[0] // 4, : out.shape[1] // 4] //= 2
        return out

    def __getattr__(self, name):
        return getattr(self.engine, name)


def altered_answer(program, params):
    """The first answer of every call altered where it is produced."""
    if hasattr(program, "restore_batch_u8"):
        inner = program.restore_batch_u8

        def restore(imgs):
            out = inner(imgs)
            out[0] = 255 - out[0]
            return out

        program.restore_batch_u8 = restore
        return program
    return _Altered(program)


def _run(spec, substitute=None, device="cpu", seconds=0.6, seed=SEED):
    return cell.run(spec, seed, seconds, False, device, time.monotonic(),
                    substitute=substitute)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = _run(tiny_spec(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [half_batch, altered_answer],
                         ids=["half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out = _run(tiny_spec(workload), substitute=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    spec = control_spec(workload)
    out = _run(spec, substitute=readings.control(spec, SEED, "cpu"),
               seconds=1.0)
    assert not out["correct"], out["checks"]


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's CUDA "
                    "kernels at their own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_at_the_cells_size_is_correct_on_the_card(cuda, workload):
    out = _run(cell.Spec(workload), device=cuda, seconds=3.0)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_at_the_cells_size_is_not_correct_on_the_card(
        cuda, workload):
    spec = cell.Spec(workload)
    out = _run(spec, substitute=readings.control(spec, SEED, cuda),
               device=cuda, seconds=3.0)
    assert not out["correct"], out["checks"]
