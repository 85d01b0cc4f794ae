"""Box and landmark coding, IoU, matching and NMS.

Port of `image_restoration_tpu/detect/box_utils.py`. `point_form`,
`intersect`/`jaccard` (:20-41), `encode`/`encode_landm` (:44-58),
`decode`/`decode_landm` (:61-74), `match` (:77-106) and `nms`, the twin of
`nms_jax` (:108-128), take any leading batch dims, so one call covers a
whole detector batch on the device. `py_cpu_nms` (:131-149) is the host NMS
of the eval scripts, copied.
"""

from __future__ import annotations

import numpy as np
import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (x1, y1, x2, y2)."""
    return torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], -1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """(..., A, 4), (..., B, 4) corner boxes → (..., A, B) intersections."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    inter = torch.clamp(max_xy - min_xy, min=0.0)
    return inter[..., 0] * inter[..., 1]


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """(..., A, B) IoU of corner boxes. A zero-area pair gives 0/0 = NaN,
    which compares False against any threshold, as in JAX."""
    inter = intersect(box_a, box_b)
    area_a = ((box_a[..., 2] - box_a[..., 0]) *
              (box_a[..., 3] - box_a[..., 1]))[..., :, None]
    area_b = ((box_b[..., 2] - box_b[..., 0]) *
              (box_b[..., 3] - box_b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter)


def encode(matched: torch.Tensor, priors: torch.Tensor,
           variances) -> torch.Tensor:
    """(..., P, 4) corner boxes matched per prior → loc targets
    (ref box_utils.py:156-183)."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(torch.clamp(g_wh, min=1e-8)) / variances[1]
    return torch.cat([g_cxcy, g_wh], -1)


def encode_landm(matched: torch.Tensor, priors: torch.Tensor,
                 variances) -> torch.Tensor:
    """(..., P, 10) landmark targets (ref :186-206)."""
    matched = matched.reshape(*matched.shape[:-1], 5, 2)
    g_cxcy = matched - priors[..., None, :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., None, 2:])
    return g_cxcy.reshape(*g_cxcy.shape[:-2], 10)


def decode(loc: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    """(..., P, 4) loc predictions → corner boxes (ref box_utils.py:209-230)."""
    boxes = torch.cat([
        priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:],
        priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])], -1)
    return torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], -1)


def decode_landm(pre: torch.Tensor, priors: torch.Tensor,
                 variances) -> torch.Tensor:
    """(..., P, 10) landmark predictions → absolute coords (ref :233-248)."""
    pre = pre.reshape(*pre.shape[:-1], 5, 2)
    landms = priors[..., None, :2] + pre * variances[0] * priors[..., None, 2:]
    return landms.reshape(*landms.shape[:-2], 10)


def match(truths: torch.Tensor, labels: torch.Tensor, landms: torch.Tensor,
          priors: torch.Tensor, variances, threshold: float):
    """SSD matching (ref box_utils.py:96-153), batched.

    truths (..., M, 4) corner ground truths, labels (..., M) (rows with
    label ≤ 0 are padding), landms (..., M, 10), priors (P, 4). Returns
    (loc_t (..., P, 4), conf (..., P), landm_t (..., P, 10)).

    Each prior takes its best-overlapping truth; then each truth in row
    order writes its own best prior, as JAX's in-order scatter
    (`.at[best_prior_idx].set`) does: a matchable truth (a valid row whose
    best overlap is at least 0.2) claims the prior with overlap 2, any
    other row writes back the prior's own best truth and overlap. So the
    last row whose best prior it is decides, and a later unmatchable row (a
    speck, or a padding row at prior 0) undoes an earlier claim of the same
    prior, as in JAX; the reference's loop instead hands the prior to the
    later row with overlap 2. The rule is computed explicitly, since
    scatters with repeated indices have no order on the GPU.
    """
    pf = point_form(priors)
    valid = labels > 0
    overlaps = jaccard(truths, pf) * valid[..., None]       # (..., M, P)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    best_prior_overlap = overlaps.amax(dim=-1)                 # (..., M)
    best_prior_idx = overlaps.argmax(dim=-1)
    best_truth_overlap = overlaps.amax(dim=-2)                 # (..., P)
    best_truth_idx = overlaps.argmax(dim=-2)
    gt_ok = valid & (best_prior_overlap >= 0.2)
    m, p = overlaps.shape[-2], overlaps.shape[-1]
    rows = torch.arange(m, device=truths.device)
    hits = best_prior_idx[..., None] == torch.arange(
        p, device=truths.device)                              # (..., M, P)
    last = torch.where(hits, rows[:, None], -1).amax(dim=-2)  # (..., P)
    forced = (last >= 0) & torch.gather(gt_ok, -1, last.clamp(min=0))
    best_truth_overlap = torch.where(
        forced, torch.full_like(best_truth_overlap, 2.0), best_truth_overlap)
    best_truth_idx = torch.where(forced, last, best_truth_idx)

    def gather(t):
        return torch.gather(t, -2, best_truth_idx[..., None].expand(
            *best_truth_idx.shape, t.shape[-1]))

    conf = torch.gather(labels, -1, best_truth_idx)
    conf = torch.where(best_truth_overlap < threshold,
                       torch.zeros_like(conf), conf)
    loc_t = encode(gather(truths), priors, variances)
    landm_t = encode_landm(gather(landms), priors, variances)
    return loc_t, conf, landm_t


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.6,
        top_k: int = 200, score_threshold: float = 0.0):
    """Greedy NMS over fixed-size outputs, on the tensors' device.

    boxes (..., P, 4) corner; scores (..., P). Returns (keep_boxes (..., k, 4),
    keep_scores (..., k), keep (..., k) bool, order (..., k)) with
    k = min(top_k, P), sorted by score; suppressed and below-threshold
    entries have keep False. Equal scores keep the lower index first, as
    `jax.lax.top_k` does (a stable descending sort; `torch.topk` promises no
    order among ties). The greedy loop is sequential over k, once per call
    for the whole batch: a few small launches per step, host-bound.
    """
    k = min(top_k, boxes.shape[-2])
    top_scores, order = torch.sort(scores, dim=-1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[..., :k], order[..., :k]
    top_boxes = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    idx = torch.arange(k, device=boxes.device)
    # suppress j > i when iou > threshold and i is kept
    sup = (jaccard(top_boxes, top_boxes) > iou_threshold) & \
        (idx[None, :] > idx[:, None])
    keep = torch.ones(top_scores.shape, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep = keep & ~(sup[..., i, :] & keep[..., i:i + 1])
    keep = keep & (top_scores > score_threshold)
    return top_boxes, top_scores, keep, order


def py_cpu_nms(dets: np.ndarray, thresh: float) -> list:
    """Host NMS (ref utils/nms/py_cpu_nms.py:10) for eval scripts."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], \
        dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep
