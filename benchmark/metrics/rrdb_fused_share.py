"""The share of the RRDB forward's stage convs that ran with the dense
block's glue (slice sums, LeakyReLU, requantization, residuals, block
carry) folded into kernel K2's epilogue: 100 · `rrdb.fused_stages` /
`rrdb.stages`, the forward's own counters (`ops/rrdb_quant.py`) over the
run. A program that does not count its stage convs, and the control, read
nothing."""

from benchmark.harness.spans import counters


def read(rec):
    c = counters()
    stages = c.get("rrdb.stages", 0)
    if not stages:
        return None
    return 100.0 * c.get("rrdb.fused_stages", 0) / stages
