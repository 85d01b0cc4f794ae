"""The int8 RRDBNet ×4 engine (RealESRGAN_x4plus's network) on the SR
engine path: `build_graph(model="RRDBNet")` served by `EngineRestorer`,
held to the benchmark's plain reference (`benchmark/reference/
rrdbnet_x4plus_int8.py`) and limit (`benchmark/limits/rrdb_x4.wide.json`)
through the cell's own build (`benchmark/programs/sr_engine.py`), at the
published widths (64/32) and 4 blocks, tile 32, halo 4, batch 2, on one
ragged photo on the CPU. Not 2 blocks: the int4 control's gap grows with
depth (its rounding adds up over the dense blocks), and at 2 it read
0.158-0.202 levels over 5 seeds of this photo, on the cell's 0.16."""

from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.compare import worst_block_mean
from benchmark.harness.weights import draw_params, smooth_images
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.ops import rrdb_quant as tq
from image_restoration_tpu_torch.serve.sr_engine import build_graph
from image_restoration_tpu_torch.utils import profiler


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NB = 4
SEED = 2 ** 35 + 7
# 30 × 70: a 1 × 3 grid of 32² tiles, so the second call of 2 holds one
# zero tile
H, W = 30, 70


def _spec():
    spec = cell.Spec("rrdb_x4.wide")
    spec.config["network"].update(num_block=NB)
    spec.config["engine"].update(tile=32, halo=4, batch=2)
    spec.config["calibration"].update(height=32, width=32)
    return spec


@pytest.fixture(scope="module")
def served():
    """One photo through the engine, its K2 launches (the RRDB stage op's
    calls, counted on the CPU where the op runs its plain version, by
    stage), the recorder's spans and counters, and the reference's answers
    at int8 and at the int4 control."""
    spec = _spec()
    dev = torch.device("cpu")
    params, engine = cell.build(spec, SEED, dev)
    img = smooth_images(1, H, W, SEED, "pool", dev, cell=16)[0].numpy()
    calls = []
    inner = tq.int8_conv3x3_rrdb_stage

    def counted(*a, **k):
        calls.append(k["stage"])
        return inner(*a, **k)

    profiler.reset()
    with mock.patch.object(tq, "int8_conv3x3_rrdb_stage", counted):
        out = engine(img)
    snap = profiler.snapshot()
    refs = {bits: cell.reference(spec, params, SEED, dev,
                                 control=bits == 4)(img) for bits in (8, 4)}
    return dict(spec=spec, engine=engine, out=out, launches=calls,
                snap=snap, refs=refs, params=params)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4_control"])
def test_engine_against_the_reference(served, bits):
    """The engine's answer lies within the cell's limit of the reference
    at int8; the reference at int4 (the control) lies beyond it."""
    limit = served["spec"].limits["block_mean_lsb"]
    out, want = served["out"], served["refs"][bits]
    assert out.shape == want.shape == (4 * H, 4 * W, 3)
    assert out.dtype == want.dtype == np.uint8
    gap = worst_block_mean(out, want, 64)
    if bits == 8:
        assert gap <= limit
    else:
        assert gap > limit
    assert 10.0 < out.std() and 0 < out.min() and out.max() < 255


def test_launches_spans_and_tile_counter(served):
    """Two engine calls of 2 tiles: 15 K2 launches per block and call, each
    an RRDB stage op call (stages 0–4 of each dense block), and every stage
    conv counted as run with the fused epilogue; `rrdb.tiles` counts every
    tile handed to the forward, the zero one too; the spans sit inside the
    tiler's `tiler.run`."""
    assert served["launches"] == [0, 1, 2, 3, 4] * (2 * 3 * NB)
    counters = served["snap"]["counters"]
    assert counters["rrdb.fused_stages"] == counters["rrdb.stages"] \
        == 2 * 15 * NB
    assert counters["rrdb.tiles"] == counters["tiler.tiles"] == 4
    assert counters["tiler.pad_tiles"] == 1
    names = {r[3]: r for r in served["snap"]["spans"]}
    for name in ("rrdb.head", "rrdb.body", "rrdb.tail"):
        assert name in names
    by_id = {r[0]: r for r in served["snap"]["spans"]}
    for rec in served["snap"]["spans"]:
        if rec[3].startswith("rrdb."):
            assert by_id[rec[1]][3] == "tiler.run"
    calls = profiler.calls("engine_restorer.call")
    assert len(calls) == 1 and calls[0]["rrdb.body"] > 0


def test_reference_float_forward_equals_the_arch():
    """The reference's plain float forward, the one its calibration runs,
    against the port's `RRDBNet` on the same weights: within 1e-5."""
    spec = _spec()
    net = spec.config["network"]
    p = draw_params(spec.reference.schema(net), 5, "cpu")
    arch = build_network(dict(type="RRDBNet", num_feat=64, num_block=NB,
                              num_grow_ch=32, scale=4))
    arch.load_state_dict(p, strict=True)
    x = smooth_images(2, 12, 16, 5, "x", "cpu").float() / 255.0
    with torch.no_grad():
        want = arch(x)
    got = spec.reference.forward(p, net, x)
    assert got.shape == want.shape == (2, 48, 64, 3)
    assert (got - want).abs().max().item() <= 1e-5


SMALL = dict(num_feat=8, num_conv=2, upscale=4, tile=8, halo=2, batch=2,
             device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(model="RRDBNet", int8=False), "int8 only"),
    (dict(model="RRDBNet", qat_ckpt="ckpt.pth"), "qat_ckpt"),
    (dict(model="RRDBNet", num_feat=32, num_block=1), "num_feat 64"),
    (dict(model="RRDBNet", num_block=1, num_grow_ch=16), "num_grow_ch 32"),
    (dict(model="RRDBNet", num_block=1, upscale=2), "upscale 4"),
    (dict(model="EDSR"), "unknown model"),
    (dict(num_block=2), "RRDBNet's"),
], ids=["bf16", "qat", "feat", "grow", "upscale", "model", "srvgg_blocks"])
def test_unsupported_combinations_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        build_graph(**dict(SMALL, **kw))


def test_build_graph_without_model_is_srvgg():
    """No `model`: the SRVGGNetCompact engine as before, the same meta and
    the same answer as `model="SRVGGNetCompact"`."""
    x = torch.from_numpy(smooth_images(2, 12, 12, 3, "x", "cpu").numpy())
    g0, m0 = build_graph(**SMALL)
    g1, m1 = build_graph(model="SRVGGNetCompact", **SMALL)
    assert m0 == m1
    assert m0 == {"model": "SRVGGNetCompact", "num_feat": 8, "num_conv": 2,
                  "upscale": 4, "tile": 8, "halo": 2, "batch": 2,
                  "mode": "int8", "io": "u8", "input_shape": [2, 12, 12, 3],
                  "input_dtype": "uint8", "qat": False,
                  "platforms": ["cpu"], "device": "cpu"}
    with torch.inference_mode():
        assert torch.equal(g0(x), g1(x))


def test_rrdb_meta(served):
    assert {k: served["engine"].meta[k] for k in (
        "model", "num_feat", "num_block", "num_grow_ch", "upscale", "tile",
        "halo", "batch", "mode", "io")} == {
        "model": "RRDBNet", "num_feat": 64, "num_block": NB,
        "num_grow_ch": 32, "upscale": 4, "tile": 32, "halo": 4, "batch": 2,
        "mode": "int8", "io": "u8"}
