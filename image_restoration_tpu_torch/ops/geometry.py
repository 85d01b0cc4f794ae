"""Device-side image geometry: homography, perspective warp, polygon masks,
crop-resize — the product pipeline's cv2 host stages as tensor ops.

Port of `image_restoration_tpu/ops/geometry.py:29-256`. The JAX functions
are single-image and batched with `vmap`; these take a leading batch dim N
(`...` where it costs nothing). The 3×3 inverse and the square→quad
homography stay closed-form, as in JAX, so the numbers follow JAX's rather
than LAPACK's; everything is float32.

Conventions (matched to OpenCV):
  * resize: half-pixel centers, bilinear, taps clamped to the crop
    (cv2.resize INTER_LINEAR; cv2's uint8 path rounds through fixed-point
    weights, so uint8 outputs can differ by ~1 LSB from this float path).
  * warp_perspective: dst(x) = src(H⁻¹ x), bilinear, BORDER_CONSTANT 0.
  * quad_mask: even-odd inside test at pixel centers (cv2.fillPoly up to
    edge-pixel rounding); quad_mask_aa dilates it by 1.5 px
    (cv2.drawContours LINE_AA followed by `mask > 0`).
"""

from __future__ import annotations

import torch

from ..utils.device import DeviceConstants


def homography_from_points(src: torch.Tensor, dst: torch.Tensor):
    """(..., 4, 2) src → dst points: the 8-dof homography (..., 3, 3);
    cv2.getPerspectiveTransform equivalent (a float32 solve)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    row_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    row_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([row_u, row_v], -2).flatten(-3, -2)   # (..., 8, 8)
    b = torch.stack([u, v], -1).flatten(-2)               # (..., 8)
    h8 = torch.linalg.solve(a, b)
    return torch.cat([h8, torch.ones_like(h8[..., :1])], -1).unflatten(
        -1, (3, 3))


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def homography_square_to_quad(t: float, quad: torch.Tensor) -> torch.Tensor:
    """Closed-form homography (..., 3, 3) mapping the square
    [(0,0),(t,0),(t,t),(0,t)] to `quad` (..., 4, 2) in the same vertex order
    (TL, TR, BR, BL); equals homography_from_points(square, quad) without
    the 8×8 solve. Degenerate quads give non-finite entries."""
    q = quad.float()
    x0, y0 = q[..., 0, 0], q[..., 0, 1]
    x1, y1 = q[..., 1, 0], q[..., 1, 1]
    x2, y2 = q[..., 2, 0], q[..., 2, 1]
    x3, y3 = q[..., 3, 0], q[..., 3, 1]
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    sx, sy = x0 - x1 + x2 - x3, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    m_unit = torch.stack([torch.stack([a, b, x0], -1),
                          torch.stack([d, e, y0], -1),
                          torch.stack([g, h, torch.ones_like(g)], -1)], -2)
    # a product, as in JAX: a non-finite entry spreads along its row
    return m_unit @ _unit_scale(float(t), q.device)


# diag(1/t, 1/t, 1) on a device: the unit square → the t × t canvas
_unit_scale = DeviceConstants(lambda t, device: torch.diag(torch.tensor(
    [1.0 / t, 1.0 / t, 1.0], dtype=torch.float32, device=device)))


def _pixel_grid(h: int, w: int, device):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return gy, gx


def warp_perspective(img: torch.Tensor, h_mat: torch.Tensor) -> torch.Tensor:
    """Bilinear inverse warp of (N, H, W, C) by homographies (N, 3, 3)
    (dst → src through H⁻¹, like cv2.warpPerspective; border 0)."""
    n, hh, ww, c = img.shape
    hi = inv3x3(h_mat)
    gy, gx = _pixel_grid(hh, ww, img.device)
    # (x, y, 1) @ hi.T, term by term
    px, py, wz = (gx * hi[:, j, 0, None, None] + gy * hi[:, j, 1, None, None]
                  + hi[:, j, 2, None, None] for j in range(3))
    den = torch.clamp(wz.abs(), min=1e-8)
    sx = px / den * torch.sign(wz)
    sy = py / den * torch.sign(wz)

    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = img.reshape(n, hh * ww, c)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi <= hh - 1) & (xi >= 0) & (xi <= ww - 1)
        yc = torch.clamp(yi, 0, hh - 1).long()
        xc = torch.clamp(xi, 0, ww - 1).long()
        idx = (yc * ww + xc).reshape(n, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(n, hh, ww, c)
        return vals * inside[..., None].to(img.dtype)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
            v10 * (1 - wx) * wy + v11 * wx * wy)


def _edges(quad: torch.Tensor):
    """(N, 4, 1, 1) x and y of each vertex and of the next one."""
    q = quad.float()
    nxt = torch.roll(q, -1, dims=-2)
    return (q[..., 0, None, None], q[..., 1, None, None],
            nxt[..., 0, None, None], nxt[..., 1, None, None])


def quad_mask(quad: torch.Tensor, hw) -> torch.Tensor:
    """(N, 4, 2) quads (vertices in polygon order, any winding, convex or
    self-intersecting) → (N, H, W) float 0/1 inside masks at pixel centers.

    Even-odd ray casting, cv2.fillPoly's fill rule for the arbitrary quads
    a detector can emit (a bowtie is filled, not emptied)."""
    h, w = hw
    gy, gx = _pixel_grid(h, w, quad.device)
    x_i, y_i, x_j, y_j = _edges(quad)
    # a horizontal ray to +x from each pixel center crosses an edge iff the
    # endpoints straddle the scanline and the crossing lies to the right
    straddle = (y_i > gy) != (y_j > gy)
    dy = y_j - y_i
    denom = torch.where(dy.abs() < 1e-12, torch.full_like(dy, 1e-12), dy)
    x_cross = (x_j - x_i) * (gy - y_i) / denom + x_i
    hits = straddle & (gx < x_cross)
    return (hits.sum(dim=-3) % 2 == 1).float()


def quad_mask_aa(quad: torch.Tensor, hw, radius: float = 1.5) -> torch.Tensor:
    """quad_mask dilated by `radius` px: the twin of cv2.drawContours
    (filled, LINE_AA) followed by `mask > 0`, which keeps every pixel the
    anti-aliased edge ink touches (~1.5 px outside the polygon)."""
    h, w = hw
    inside = quad_mask(quad, hw)
    gy, gx = _pixel_grid(h, w, quad.device)
    ax, ay, bx, by = _edges(quad)
    abx, aby = bx - ax, by - ay
    ap_x, ap_y = gx - ax, gy - ay
    denom = abx ** 2 + aby ** 2 + 1e-12
    t = torch.clamp((ap_x * abx + ap_y * aby) / denom, 0.0, 1.0)
    dx = ap_x - t * abx
    dy = ap_y - t * aby
    dist = torch.sqrt(dx * dx + dy * dy).amin(dim=-3)
    return torch.maximum(inside, (dist <= radius).float())


def bbox_of_quad(quad: torch.Tensor, hw):
    """cv2.boundingRect on integer points: x0 = min, w = max - min + 1,
    clamped into the (H, W) image as the host path clamps. Returns float32
    (x0, y0, w, h), each (N,)."""
    h, w = hw
    q = torch.round(quad.float())
    x0 = torch.clamp(q[..., 0].amin(-1), min=0.0)
    y0 = torch.clamp(q[..., 1].amin(-1), min=0.0)
    bw = torch.clamp(q[..., 0].amax(-1) - x0 + 1.0, min=1.0)
    bh = torch.clamp(q[..., 1].amax(-1) - y0 + 1.0, min=1.0)
    bw = torch.minimum(bw, w - x0)
    bh = torch.minimum(bh, h - y0)
    return x0, y0, bw, bh


def _axis_coords(x0, extent, n_dst: int, out_extent: float):
    """(N, n_dst) source coordinates for resizing the [x0, x0+extent) crop
    to out_extent pixels (half-pixel convention), clamped to the crop."""
    i = torch.arange(n_dst, dtype=torch.float32, device=x0.device)
    s = (i + 0.5) * (extent / out_extent)[:, None] - 0.5 + x0[:, None]
    return torch.minimum(torch.maximum(s, x0[:, None]),
                         (x0 + extent - 1.0)[:, None])


def crop_resize(img: torch.Tensor, bbox, out_hw) -> torch.Tensor:
    """Crop (x0, y0, w, h) from (N, H, W, C) and resize bilinearly to
    out_hw: `cv2.resize(img[y0:y0+h, x0:x0+w], out_hw)` per image."""
    x0, y0, bw, bh = bbox
    oh, ow = out_hw
    sx = _axis_coords(x0, bw, ow, float(ow))
    sy = _axis_coords(y0, bh, oh, float(oh))
    return _bilinear_grid(img, sy, sx, (y0, y0 + bh - 1.0),
                          (x0, x0 + bw - 1.0))


def _bilinear_grid(img, sy, sx, y_range, x_range):
    """Separable bilinear gather at the (sy × sx) grid of each image, taps
    clamped to [y_range] × [x_range] (each bound (N,): the crop)."""
    n, _, w, c = img.shape
    oh, ow = sy.shape[1], sx.shape[1]
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0f, sx - x0f

    def cl(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo[:, None]),
                             hi[:, None]).long()

    yl, yh = cl(y0f, *y_range), cl(y0f + 1, *y_range)
    xl, xh = cl(x0f, *x_range), cl(x0f + 1, *x_range)

    def rows(yi):
        return torch.gather(img, 1, yi[:, :, None, None].expand(-1, -1, w, c))

    def cols(r, xi):
        return torch.gather(r, 2, xi[:, None, :, None].expand(-1, oh, -1, c))

    wx_, wy_ = wx[:, None, :, None], wy[:, :, None, None]
    top, bot = rows(yl), rows(yh)
    top = cols(top, xl) * (1 - wx_) + cols(top, xh) * wx_
    bot = cols(bot, xl) * (1 - wx_) + cols(bot, xh) * wx_
    return top * (1 - wy_) + bot * wy_


def pad_resize(img: torch.Tensor, bbox, out_hw) -> torch.Tensor:
    """Aspect-preserving resize of each (x0, y0, w, h) crop into an out_hw
    canvas, centered, zero fill: the device twin of
    serve/pipeline.resize_with_padding (scale = min(T/w, T/h, 1), floored
    size, //2 offsets)."""
    x0, y0, bw, bh = bbox
    oh, ow = out_hw
    scale = torch.clamp(torch.minimum(ow / bw, oh / bh), max=1.0)
    nw = torch.clamp(torch.floor(bw * scale), min=1.0)
    nh = torch.clamp(torch.floor(bh * scale), min=1.0)
    px = torch.floor((ow - nw) / 2.0)[:, None]
    py = torch.floor((oh - nh) / 2.0)[:, None]
    j = torch.arange(ow, dtype=torch.float32, device=img.device)[None]
    i = torch.arange(oh, dtype=torch.float32, device=img.device)[None]
    sx = (j - px + 0.5) * (bw / nw)[:, None] - 0.5 + x0[:, None]
    sx = torch.minimum(torch.maximum(sx, x0[:, None]), (x0 + bw - 1.0)[:, None])
    sy = (i - py + 0.5) * (bh / nh)[:, None] - 0.5 + y0[:, None]
    sy = torch.minimum(torch.maximum(sy, y0[:, None]), (y0 + bh - 1.0)[:, None])
    out = _bilinear_grid(img, sy, sx, (y0, y0 + bh - 1.0),
                         (x0, x0 + bw - 1.0))
    placed = ((j[:, None, :] >= px[:, :, None])
              & (j[:, None, :] < (px + nw[:, None])[:, :, None])
              & (i[:, :, None] >= py[:, :, None])
              & (i[:, :, None] < (py + nh[:, None])[:, :, None]))
    return out * placed[..., None].to(out.dtype)
