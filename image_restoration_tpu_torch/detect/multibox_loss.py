"""MultiBox loss: SSD matching, smooth-L1 box and landmark losses, and
cross-entropy confidence with 7:1 hard-negative mining.

Port of `image_restoration_tpu/detect/multibox_loss.py:25-93` (parity with
Plate_Detect/Retina-License-Plate/layers/modules/multibox_loss.py:9-125).
JAX vmaps the per-image matching; here `match` runs batched over B in one
call. The positive and negative counts are masked reductions, so the loss
never waits on the host. In a `torch.distributed` world the normalizers
count the global batch's positives.

Targets are a padded (B, M, 15) tensor: 4 corner bbox coordinates and 10
landmark coordinates in [0, 1], then the label (1 = plate with landmarks,
−1 = plate without, 0 = padding).
"""

from __future__ import annotations

import torch

from ..utils.dist_util import all_reduce_sum, get_dist_info, in_world
from .box_utils import jaccard, match, point_form


def _normalizer(mask: torch.Tensor) -> torch.Tensor:
    """max(count, 1) of the set entries of `mask`; in a world, the global
    batch's count over the world size, so the world's mean of the ranks'
    losses is the global batch's loss."""
    if not in_world():
        return torch.clamp(mask.sum(), min=1)
    return torch.clamp(all_reduce_sum(mask.sum().float()), min=1) / \
        get_dist_info()[1]


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def match_targets(targets: torch.Tensor, priors: torch.Tensor,
                  variances=(0.1, 0.2), overlap_thresh: float = 0.35):
    """(loc_t (B, P, 4), conf_t (B, P), landm_t (B, P, 10)) for (B, M, 15)
    targets: `match` with every object row valid, then the matched truth's
    sign put back on conf_t (−1: a plate whose landmarks take no loss).

    The sign comes from each prior's best-overlapping truth before `match`
    forces the truths' best priors, as JAX reads it."""
    truths, landms, labels = targets[..., :4], targets[..., 4:14], \
        targets[..., 14]
    obj = torch.sign(labels)                                  # 1, −1 or 0
    loc_t, conf_t, landm_t = match(truths, obj.abs(), landms, priors,
                                   variances, overlap_thresh)
    overlaps = jaccard(truths, point_form(priors)) * (obj != 0)[..., None]
    signed = torch.gather(obj, -1, overlaps.argmax(dim=-2))
    conf_t = torch.where(conf_t > 0, signed, torch.zeros_like(signed))
    return loc_t, conf_t, landm_t


def multibox_loss(predictions, priors: torch.Tensor, targets: torch.Tensor,
                  variances=(0.1, 0.2), overlap_thresh: float = 0.35,
                  neg_pos_ratio: int = 7):
    """(loss_loc, loss_conf, loss_landm) scalars.

    predictions: (loc (B, P, 4), conf (B, P, 2), landm (B, P, 10)) raw
    logits; targets (B, M, 15) as documented above.
    """
    loc_data, conf_data, landm_data = predictions
    num_priors = loc_data.shape[1]
    with torch.no_grad():
        loc_t, conf_t, landm_t = match_targets(targets, priors, variances,
                                               overlap_thresh)

    # landmark loss: positives with landmarks (conf_t == 1)
    pos1 = conf_t > 0
    n1 = _normalizer(pos1).to(landm_data.dtype)
    loss_landm = (smooth_l1(landm_data - landm_t) * pos1[..., None]).sum() / n1

    # localization loss: every object (conf_t != 0)
    pos = conf_t != 0
    n = _normalizer(pos).to(loc_data.dtype)
    loss_loc = (smooth_l1(loc_data - loc_t) * pos[..., None]).sum() / n

    # confidence loss with hard-negative mining; −1 labels train class 1
    cls_target = pos.long()[..., None]
    ce = -torch.gather(torch.log_softmax(conf_data, dim=-1), -1,
                       cls_target)[..., 0]                    # (B, P)
    with torch.no_grad():
        # mining score: logsumexp − true-class logit (ref :103-109)
        mining = torch.logsumexp(conf_data, dim=-1) - \
            torch.gather(conf_data, -1, cls_target)[..., 0]
        mining = torch.where(pos, torch.full_like(mining, -float("inf")),
                             mining)
        # jnp.argsort is stable: equal scores keep their prior order
        order = torch.argsort(-mining, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        num_neg = torch.clamp(neg_pos_ratio * pos.sum(dim=1, keepdim=True),
                              0, num_priors - 1)
        neg = ranks < num_neg
    loss_conf = (ce * (pos | neg)).sum() / n
    return loss_loc, loss_conf, loss_landm
