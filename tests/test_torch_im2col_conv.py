"""Kernel K3's plain version (`conv3x3_im2col_plain`) against the Pallas
kernel `conv3x3_im2col` in interpret mode, the wrapper's dispatch and checks,
the CUDA kernel's walk emulated block by block, and the probe entry point's
control flow on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.ops.pallas.im2col_conv import (
    conv3x3_im2col as pallas_conv3x3_im2col)
from image_restoration_tpu_torch.ops.im2col_conv import (
    conv3x3_im2col, conv3x3_im2col_plain)
from image_restoration_tpu_torch.scripts import probe_conv


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cin,cout,bh", [(64, 192, 4), (32, 160, 8),
                                         (32, 64, 8)])
def test_plain_f32_matches_pallas_interpret(rng, cin, cout, bh):
    """The widened stage channel shapes at the JAX test's size and
    tolerance (`tests/test_ops.py:278-293`), float32 in and out."""
    x = rng.standard_normal((2, 18, 26, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(w), bh=bh, out_dtype=jnp.float32,
        interpret=True))
    for fn in (conv3x3_im2col_plain, conv3x3_im2col):  # CPU → plain
        got = fn(_t(x), _t(w), bh=bh, out_dtype=torch.float32)
        assert got.shape == (2, 16, 24, cout) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_bf16_out_matches_pallas_interpret(rng):
    """bf16 in and out, as the probe runs it: within one bf16 ulp of the
    Pallas value, plus 1e-5 of max|ref| where a sum cancels to near zero
    (both sum the same float32 products, in another order)."""
    cin, cout = 64, 192
    x = jnp.asarray(rng.standard_normal((1, 10, 18, cin)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((3, 3, cin, cout)) * 0.1,
                    jnp.bfloat16)
    want = np.asarray(pallas_conv3x3_im2col(x, w, bh=4, interpret=True),
                      np.float32)
    got = conv3x3_im2col_plain(_t(np.asarray(x, np.float32)).bfloat16(),
                               _t(np.asarray(w, np.float32)).bfloat16(),
                               bh=4)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 8, 16, cout)
    err = np.abs(got.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(err <= ulp + 1e-5 * np.abs(want).max())
    assert (err > 0).mean() < 0.01  # rounding flips only


def test_wrapper_dispatch_and_checks(rng):
    """CPU tensors take the plain version and count no launch; a meta
    tensor, a Cin mismatch, H % bh != 0 and an unsupported out_dtype raise,
    as `int8_conv3x3_requant` does for K2."""
    x = _t(rng.standard_normal((1, 10, 7, 32)).astype(np.float32))
    w = _t(rng.standard_normal((3, 3, 32, 16)).astype(np.float32))
    before = conv3x3_im2col.launches
    out = conv3x3_im2col(x, w)
    assert out.shape == (1, 8, 5, 16) and out.dtype == torch.bfloat16
    assert torch.equal(out, conv3x3_im2col_plain(x, w))
    assert conv3x3_im2col.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_im2col(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="input channels"):
        conv3x3_im2col(x, w[:, :, :16])
    with pytest.raises(ValueError, match="must divide by bh"):
        conv3x3_im2col(x, w, bh=3)
    with pytest.raises(ValueError, match="out_dtype"):
        conv3x3_im2col(x, w, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        conv3x3_im2col(x[0], w)


# K3's walk (csrc/conv3x3_im2col.cu), emulated on the CPU. These constants
# must equal the .cu's; test_k3_constants_match_source reads them there.
K3_TH, K3_PART_W, K3_WGS = 8, 8, 3
K3_SLAB_COLS = K3_PART_W + 2
K3_SLAB_PIX = (K3_TH + 2) * K3_SLAB_COLS
K3_PLANE = 1664             # bytes per chunk plane of a slab
K3_W_BOX_ROWS = 144         # k rows of a weight box
K3_MAX_CIN, K3_MAX_NT, K3_MAX_BUFS = 128, 160, 2
K3_MAX_SMEM = 232448


def _k3_smem(nt, cin, bufs):
    return (9 * cin * nt * 2 + K3_WGS * bufs * (cin // 8) * K3_PLANE
            + K3_WGS * K3_TH * K3_PART_W * (2 * nt + 16)
            + (K3_WGS * bufs + 1) * 8)


def _k3_nt(cin, cout):
    """(NT, slab buffers) as `pick_nt` chooses them: two buffers where
    they fit, else one; the widest NT (160, 128, ..., 32) whose slice fits,
    narrowed to split Cout evenly."""
    for bufs in range(K3_MAX_BUFS, 0, -1):
        for fit in range(K3_MAX_NT, 0, -32):
            if _k3_smem(fit, cin, bufs) <= K3_MAX_SMEM:
                slices = -(-cout // fit)
                return -(-(-(-cout // slices)) // 32) * 32, bufs
    raise AssertionError("no NT fits")


def _swizzle64(addr):
    """The byte address a 64-byte swizzle puts `addr` at: its 16-byte chunk
    (bits 4-5) XOR bits 7-8."""
    return addr ^ ((addr >> 7 & 3) << 4)


def _desc_read(mem, start, lbo, sbo, rows, k_major):
    """The (rows, 16) operand of one k16 wgmma step, read from `mem` (shared
    memory as a flat bf16 array) through a descriptor, all offsets in bytes.
    K-major without swizzle (A): core matrices of 8 rows x 8 k, `sbo` apart
    along M and `lbo` apart along K. N-major with a 64-byte swizzle (B, read
    transposed): atoms of 8 k rows x 32 channels, a k row 64 bytes, atoms
    `lbo` apart along N and `sbo` apart along K."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    if k_major:
        off = start + r // 8 * sbo + r % 8 * 16 + k // 8 * lbo + k % 8 * 2
    else:
        off = _swizzle64(start + r // 32 * lbo + r % 32 * 2 + k // 8 * sbo
                         + k % 8 * 64)
    return mem[off // 2]


def _k3_walk(x_padded, weight, grid):
    """K3's walk over x_padded (N, H+2, W+2, Cin) for a persistent grid of
    at most `grid` blocks, float32 out: the weight slice and the slabs laid
    out in shared memory as the kernel lays them, every wgmma operand read
    back through its descriptor. Each output value is written exactly
    once."""
    n, hp, wp, cin0 = x_padded.shape
    h, w = hp - 2, wp - 2
    cout = weight.shape[3]
    cin, cout_w = -(-cin0 // 16) * 16, -(-cout // 8) * 8
    x = torch.nn.functional.pad(x_padded.float(), (0, cin - cin0))
    wmat = torch.nn.functional.pad(
        weight.float(), (0, cout_w - cout, 0, cin - cin0)).reshape(-1, cout_w)
    nt, _ = _k3_nt(cin, cout)
    slices = -(-cout // nt)
    tw = K3_WGS * K3_PART_W
    tiles_x = -(-w // tw)
    tiles_img = -(-h // K3_TH) * tiles_x
    tiles_sp = n * tiles_img
    per_slice = max(1, min(grid // slices, tiles_sp))
    chunks = cin // 8
    out = torch.full((n, h, w, cout), float("nan"))
    writes = torch.zeros((n, h, w, cout), dtype=torch.int32)
    for b in range(per_slice * slices):
        co0 = b % slices * nt
        # the slice by TMA: boxes of 32 channels x 144 k rows, each row of
        # 64 bytes at [j][k] with a 64-byte swizzle, zero past Cout_w
        s_w = torch.zeros(9 * cin * nt)
        for j in range(nt // 32):
            for k0 in range(0, 9 * cin, K3_W_BOX_ROWS):
                kr = torch.arange(k0, k0 + K3_W_BOX_ROWS)[:, None]
                ch = torch.arange(32)[None, :]
                src = torch.zeros(K3_W_BOX_ROWS, 32)
                cols = min(32, max(0, cout_w - co0 - 32 * j))
                src[:, :cols] = wmat[k0:k0 + K3_W_BOX_ROWS,
                                     co0 + 32 * j:co0 + 32 * j + cols]
                dst = _swizzle64((j * 9 * cin + kr) * 64 + ch * 2)
                s_w[dst // 2] = src
        for r in range(b // slices, tiles_sp, per_slice):
            img, rr = divmod(r, tiles_img)
            for wg in range(K3_WGS):
                y0 = rr // tiles_x * K3_TH
                x0 = rr % tiles_x * tw + wg * K3_PART_W
                p = torch.arange(K3_SLAB_PIX)
                iy, ix = y0 + p // K3_SLAB_COLS, x0 + p % K3_SLAB_COLS
                ok = (iy < hp) & (ix < wp)
                pix = torch.zeros(K3_SLAB_PIX, cin)
                pix[ok] = x[img, iy[ok], ix[ok]]
                slab = torch.zeros(chunks, K3_PLANE // 2)  # [chunk][row][col][8]
                slab[:, :K3_SLAB_PIX * 8] = pix.reshape(
                    K3_SLAB_PIX, chunks, 8).transpose(0, 1).reshape(chunks, -1)
                slab = slab.reshape(-1)
                acc = torch.zeros(K3_TH * K3_PART_W, nt)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    for s in range(cin // 16):
                        a = _desc_read(slab, (dy * K3_SLAB_COLS + dx) * 16
                                       + 2 * s * K3_PLANE, K3_PLANE,
                                       K3_SLAB_COLS * 16, K3_TH * K3_PART_W,
                                       True)
                        bt = _desc_read(s_w, (tap * cin + 16 * s) * 64,
                                        9 * cin * 64, 512, nt, False)
                        acc += a @ bt.t()
                rows, cols = min(K3_TH, h - y0), min(K3_PART_W, w - x0)
                keep = min(nt, cout - co0)
                if rows <= 0 or cols <= 0:
                    continue
                res = acc.reshape(K3_TH, K3_PART_W, nt)[:rows, :cols, :keep]
                out[img, y0:y0 + rows, x0:x0 + cols, co0:co0 + keep] = res
                writes[img, y0:y0 + rows, x0:x0 + cols, co0:co0 + keep] += 1
    assert bool((writes == 1).all())
    return out


def test_k3_constants_match_source():
    """The walk's constants are the kernel's."""
    import re
    from pathlib import Path
    import image_restoration_tpu_torch
    src = (Path(image_restoration_tpu_torch.__file__).parent / "csrc"
           / "conv3x3_im2col.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert (const("kWgs"), const("kTH"), const("kPartW")) == (
        K3_WGS, K3_TH, K3_PART_W)
    assert (const("kPlane"), const("kWBoxRows"), const("kMaxCin"),
            const("kMaxNT"), const("kMaxBufs"), const("kMaxSmem")) == (
        K3_PLANE, K3_W_BOX_ROWS, K3_MAX_CIN, K3_MAX_NT, K3_MAX_BUFS,
        K3_MAX_SMEM)


@pytest.mark.parametrize("n,h,w,cin,cout,grid,nt,bufs", [
    (1, 9, 30, 32, 160, 132, 160, 2),  # Cin 32: NT = Cout, one slice
    (2, 10, 26, 64, 192, 4, 96, 2),    # Cin 64 -> 192: two slices of 96
    (1, 6, 17, 128, 70, 7, 32, 1),     # Cin 128: three slices, one buffer
    (2, 11, 30, 24, 36, 3, 64, 2),     # ragged H, W, Cin (padded to 32), Cout
    (1, 1, 528, 32, 64, 132, 64, 2),   # H = 1 at the probe's width
    (3, 9, 27, 10, 40, 2, 64, 2),      # tiles that cross images, Cin 10 -> 16
    (1, 9, 30, 32, 192, 132, 96, 2),   # Cin 32 -> 192: two slices of 96
])
def test_k3_tiled_walk_matches_plain(rng, n, h, w, cin, cout, grid, nt,
                                     bufs):
    """K3's walk (persistent tile order, NT from the shared-memory budget,
    each warpgroup's 8 × 8 part and 10 × 10 slab, Cin padded to 16, k16
    steps per tap through the descriptors, masking at H, W and Cout) equals
    the plain version within the float32 tolerance of the card-only test:
    1e-5 of max|plain|."""
    assert _k3_nt(-(-cin // 16) * 16, cout) == (nt, bufs)
    x = _t(rng.standard_normal((n, h + 2, w + 2, cin)).astype(
        np.float32)).bfloat16()
    wt = _t(rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32) * 0.1).bfloat16()
    got = _k3_walk(x, wt, grid)
    want = conv3x3_im2col_plain(x, wt, bh=1, out_dtype=torch.float32)
    assert got.shape == want.shape
    tol = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_probe_stage_runs_on_cpu(rng, capsys):
    """One probe stage on a 16² bf16 tensor on the CPU (plain version, host
    clock): within its 2e-2 gate, both rates printed."""
    for name, cin, cout, bh in probe_conv.SHAPES:
        x = _t(rng.random((1, 18, 18, cin), np.float32)).bfloat16()
        w = _t(rng.random((3, 3, cin, cout), np.float32) - 0.5).bfloat16()
        row = probe_conv.probe_stage(name, x, w, bh)
        assert (row["cin"], row["cout"], row["size"]) == (cin, cout, 16)
        assert row["rel_err"] < 2e-2
    assert "cpu-bf16" in capsys.readouterr().out
