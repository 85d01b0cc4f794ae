"""The frozen counts, counted again."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cell
from benchmark.harness.weights import draw_params

SPEC_GFP = cell.Spec("ocr256.batch32")
SPEC_SR = cell.Spec("srx4.wide")


def test_gfpgan_flops_per_image_recounted_from_the_reference():
    ref, net = SPEC_GFP.reference, SPEC_GFP.config["network"]
    p = draw_params(ref.schema(net), 0, "cpu")
    for batch in (1, 2):
        x = torch.zeros(batch, 3, 256, 256)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref.forward(p, net, x)
        assert fc.get_total_flops() == batch * \
            SPEC_GFP.counts.FLOPS_PER_IMAGE
    assert SPEC_GFP.counts.FLOPS_PER_IMAGE == 34_636_928_000


def test_k1_sites_are_the_forwards_fused_activations():
    """The 39 sites the counts list are the reference's fused bias +
    LeakyReLU calls, shape for shape, at the published widths."""
    ref, net = SPEC_GFP.reference, SPEC_GFP.config["network"]
    seen = []
    inner = ref.fused_lrelu

    def record(x, bias):
        seen.append((x.shape[2], x.shape[3], x.shape[1]))
        return inner(x, bias)

    p = draw_params(ref.schema(net), 0, "cpu")
    ref.fused_lrelu = record
    try:
        with torch.no_grad():
            ref.forward(p, net, torch.zeros(1, 3, 256, 256))
    finally:
        ref.fused_lrelu = inner
    sites = SPEC_GFP.counts.k1_sites(net)
    assert len(sites) == 39
    assert sorted(seen) == sorted(sites)
    # x and y in float32 for 16 images plus 39 biases: PR 7's 0.6268 ms
    nbytes = SPEC_GFP.counts.k1_bytes(net, 16, 1)
    assert abs(nbytes / 3.35e12 * 1e3 - 0.6268) < 1e-4


def test_sr_ops_per_tile():
    net, eng = SPEC_SR.config["network"], SPEC_SR.config["engine"]
    c = SPEC_SR.counts
    assert c.ops_per_tile(net, eng) == 674_113_093_632
    # the formula against the flop counter on the reference's float convs
    # at a small tile
    small = dict(tile=24, halo=4)
    ref = SPEC_SR.reference
    p = draw_params(ref.schema(net), 0, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.calibrate(p, net, torch.zeros(1, 32, 32, 3))
    assert fc.get_total_flops() == c.ops_per_tile(net, small)
    assert c.bytes_per_tile(net, eng) == 528 * 528 * 4275
