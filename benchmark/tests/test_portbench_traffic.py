"""The generators: a seed repeats its inputs and weights, and the sample
of answers that is checked is a seeded uniform one; the mfu readers take
the trace's device time."""

import numpy as np
import torch

from benchmark.harness.loop import Reservoir
from benchmark.harness.weights import draw_params, smooth_images, sub_seed


def test_inputs_and_weights_repeat_for_a_seed():
    x = smooth_images(2, 16, 24, 2 ** 33 + 7, "pool", "cpu")
    y = smooth_images(2, 16, 24, 2 ** 33 + 7, "pool", "cpu")
    z = smooth_images(2, 16, 24, 2 ** 33 + 8, "pool", "cpu")
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert x.dtype == torch.uint8 and x.shape == (2, 16, 24, 3)
    schema = [("a", (3, 4), 0.0, 1.0), ("b", (5,), 1.0, 0.1)]
    p, q = draw_params(schema, 9, "cpu"), draw_params(schema, 9, "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert sub_seed(1, "x") != sub_seed(1, "y")


def test_reservoir_keeps_a_seeded_uniform_sample():
    def sample(seed):
        r = Reservoir(3, seed)
        for i in range(1000):
            r.offer(i)
        return r.items

    assert sample(4) == sample(4) and sample(4) != sample(5)
    assert len(sample(4)) == 3
    hits = np.zeros(10)
    for s in range(1000):
        r = Reservoir(1, s)
        for i in range(10):
            r.offer(i)
        hits[r.items[0]] += 1
    assert hits.min() > 60 and hits.max() < 140  # 100 each expected



def test_the_mfu_readers_take_device_busy_time():
    """Work of the traced calls over the trace's busy device seconds: the
    host's length of the traced stretch does not enter."""
    from benchmark.harness.cell import PEAKS, Spec

    spec = Spec("srx4.small")
    rec = {"traced": {"answers": 30, "real_tiles": 60}, "busy_s": 0.5,
           "window_s": 9.0, "elapsed_s": 30.0, "counts": spec.counts,
           "peaks": PEAKS, "config": spec.config}
    ops = spec.counts.ops_per_tile(spec.config["network"],
                                   spec.config["engine"])
    got = spec.metric_reader("sr_mfu")(rec)
    assert abs(got - 100 * ops * 120 / PEAKS["int8_ops"]) < 1e-9
    rec["window_s"] = 1.0
    assert spec.metric_reader("sr_mfu")(rec) == got
    assert spec.metric_reader("sr_mfu")(dict(rec, traced=None)) is None
    assert spec.metric_reader("sr_mfu")(dict(rec, busy_s=0.0)) is None
