"""Frozen counts of the int8 SRVGGNetCompact ×4 engine at the
configuration's widths, per tile of (tile + 2·halo)² pixels.

These count the model the configuration states, not the packed form the
engine runs: one image per tile, 3 input channels, int8 activations in and
out of every conv, int8 weights read once per engine call. The engine's
block-diagonal pack 2 doubles the MACs it issues and pads the first
layer's 6 channels to 32; none of that is counted.
"""

from __future__ import annotations


def _convs(net: dict) -> list:
    """(Cin, Cout) of every conv: body 0, body 1 … num_conv, conv_last."""
    nf, r = net["num_feat"], net["upscale"]
    return ([(3, nf)] + [(nf, nf)] * net["num_conv"]
            + [(nf, 3 * r * r)])


def side(engine: dict) -> int:
    return engine["tile"] + 2 * engine["halo"]


def ops_per_tile(net: dict, engine: dict) -> int:
    """2 · MACs of one tile: 674,113,093,632 at tile 512, halo 8."""
    return 2 * 9 * side(engine) ** 2 * sum(ci * co for ci, co in _convs(net))


def bytes_per_tile(net: dict, engine: dict) -> int:
    """int8 activations read and written by every conv of one tile."""
    return side(engine) ** 2 * sum(ci + co for ci, co in _convs(net))


def weight_bytes(net: dict) -> int:
    """int8 weights and bfloat16 epilogue vectors of every conv."""
    return sum(9 * ci * co + 3 * 2 * co for ci, co in _convs(net))


def k2_least_s(net: dict, engine: dict, tiles: int, calls: int,
               peaks: dict) -> float:
    """The least time of the int8 convs of `tiles` tiles in `calls`
    engine calls: the larger of operations over the int8 peak and bytes
    over HBM's bandwidth."""
    ops = tiles * ops_per_tile(net, engine)
    nbytes = tiles * bytes_per_tile(net, engine) + calls * weight_bytes(net)
    return max(ops / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])
