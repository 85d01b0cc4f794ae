"""Frozen counts of the int8 RRDBNet ×4 engine (RealESRGAN_x4plus) at the
configuration's widths, per tile of (tile + 2·halo)² input pixels.

The body is counted as the engine runs it, the widened form: per dense
block five stage convs, 64 → 192 and 32 → 160, 128, 96, 64 (the 15 convs of
the published dense block regrouped by input; the multiply-adds are the
same set), 15 launches of kernel K2 per RRDB block, 345 at 23 blocks: int8
in, int32 sums, bfloat16 out. The six head and tail convs are bfloat16:
conv_first and conv_body at the tile's size, conv_up1 at twice it,
conv_up2, conv_hr and conv_last at four times. Operations are 2 · MACs.
"""

from __future__ import annotations


def side(engine: dict) -> int:
    return engine["tile"] + 2 * engine["halo"]


def stages(net: dict) -> list:
    """(Cin, Cout) of the five widened stage convs of a dense block."""
    nf, gc = net["num_feat"], net["num_grow_ch"]
    return [(nf, 4 * gc + nf)] + [(gc, (4 - s) * gc + nf)
                                  for s in range(1, 5)]


def head_tail(net: dict) -> list:
    """(Cin, Cout, area factor) of the six bfloat16 convs."""
    nf = net["num_feat"]
    return [(3, nf, 1), (nf, nf, 1), (nf, nf, 4), (nf, nf, 16),
            (nf, nf, 16), (nf, 3, 16)]


def int8_macs_per_pixel(net: dict) -> int:
    """16,533,504 at the published widths and depth."""
    per_block = 3 * sum(9 * ci * co for ci, co in stages(net))
    return net["num_block"] * per_block


def bf16_macs_per_pixel(net: dict) -> int:
    """1,393,344 at the published widths."""
    return sum(9 * ci * co * a for ci, co, a in head_tail(net))


def int8_ops_per_tile(net: dict, engine: dict) -> int:
    """2 · int8 MACs of one tile: 9,785,718,079,488 at tile 512, halo
    16."""
    return 2 * int8_macs_per_pixel(net) * side(engine) ** 2


def bf16_flops_per_tile(net: dict, engine: dict) -> int:
    """2 · bfloat16 MACs of one tile: 824,681,299,968 at tile 512, halo
    16."""
    return 2 * bf16_macs_per_pixel(net) * side(engine) ** 2


def least_s_per_tile(net: dict, engine: dict, peaks: dict) -> float:
    """The model's least time for one tile: the int8 operations at the
    dense int8 peak plus the bfloat16 ones at the dense bfloat16 peak."""
    return (int8_ops_per_tile(net, engine) / peaks["int8_ops"]
            + bf16_flops_per_tile(net, engine) / peaks["bf16_flops"])


def k2_launch_least_s(cin: int, cout: int, pixels: int,
                      peaks: dict, bias: bool) -> float:
    """One K2 launch over `pixels` output pixels: the larger of its
    operations at the int8 peak and its bytes (int8 in, bfloat16 out, int8
    weights, bfloat16 dequantization vector and bias) at HBM's bandwidth."""
    ops = 2 * 9 * cin * cout * pixels
    nbytes = (pixels * (cin + 2 * cout) + 9 * cin * cout
              + 2 * cout * (2 if bias else 1))
    return max(ops / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])


def k2_least_s(net: dict, engine: dict, tiles: int, calls: int,
               peaks: dict) -> float:
    """K2's least time over `calls` engine calls that ran `tiles` tiles in
    all (an equal share a call): every launch's least time, summed."""
    if not calls:
        return 0.0
    pixels = tiles * side(engine) ** 2 / calls
    per_block = sum(k2_launch_least_s(ci, co, pixels, peaks, s == 0)
                    for s, (ci, co) in enumerate(stages(net)))
    return calls * 3 * net["num_block"] * per_block
