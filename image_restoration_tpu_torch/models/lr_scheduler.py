"""Learning-rate schedules as closed-form functions of the update count.

Port of `image_restoration_tpu/models/lr_scheduler.py`. The trainer's
optimizer sets its lr to `schedule(count)` before each update, where count
is the number of updates made so far, as optax evaluates a schedule at the
count before the update.

  * MultiStepRestartLR: lr(it) = base · w_r · gamma^k, r the last restart
    ≤ it (weight w_r), k the milestones in (r, it] with multiplicity.
  * CosineAnnealingRestartLR: the period is the first i with
    it ≤ cumulative[i]; past the last period the lr holds at eta_min.
"""

from __future__ import annotations

import math
from typing import Sequence


def multistep_restart_lr(base_lr: float, milestones: Sequence[int],
                         gamma: float = 0.1, restarts: Sequence[int] = (0,),
                         restart_weights: Sequence[float] = (1,),
                         warmup_iter: int = -1):
    milestones = list(milestones)
    restarts = list(restarts)
    restart_weights = list(restart_weights)
    assert len(restarts) == len(restart_weights), \
        "restarts and their weights do not match."
    if 0 not in restarts:
        restarts = [0] + restarts
        restart_weights = [1.0] + restart_weights

    def schedule(count) -> float:
        it = float(count)
        w, r_eff = float(restart_weights[0]), float(restarts[0])
        for r, rw in zip(restarts[1:], restart_weights[1:]):
            if it >= r:
                w, r_eff = float(rw), float(r)
        k = sum(1 for m in milestones if it >= m and m > r_eff)
        lr = base_lr * w * gamma ** k
        if warmup_iter > 0 and it < warmup_iter:
            lr = base_lr * (it + 1) / warmup_iter
        return lr

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0):
    assert len(periods) == len(restart_weights), \
        "periods and restart_weights should have the same length."
    cumulative = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(count) -> float:
        it = float(count)
        idx = min(sum(1 for c in cumulative if it > c), len(periods) - 1)
        nearest = 0.0 if idx == 0 else float(cumulative[idx - 1])
        t = min(max((it - nearest) / periods[idx], 0.0), 1.0)
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * \
            (1 + math.cos(math.pi * t))

    return schedule


def build_schedule(train_opt: dict, base_lr: float):
    """From the YAML `scheduler:` block (MultiStepLR, MultiStepRestartLR,
    CosineAnnealingRestartLR, or none: a constant)."""
    sched = dict(train_opt.get("scheduler", {}) or {})
    stype = sched.pop("type", None)
    warmup = train_opt.get("warmup_iter", -1)
    if stype in ("MultiStepLR", "MultiStepRestartLR"):
        return multistep_restart_lr(
            base_lr, sched.get("milestones", []),
            sched.get("gamma", 0.1), sched.get("restarts", (0,)),
            sched.get("restart_weights", (1,)), warmup)
    if stype == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(
            base_lr, sched["periods"], sched.get("restart_weights", (1,)),
            sched.get("eta_min", 0.0))
    if stype is None:
        return lambda count: float(base_lr)
    raise ValueError(f"unknown scheduler type {stype}")
