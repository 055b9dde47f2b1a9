"""Learning-rate schedules as plain functions ``step -> lr``.

Counterpart of ``lowlight_image_enhancement_tpu/training/schedules.py``
(reference ``models/lr_scheduler.py:12-189``, stock cosine of
``base_model.py:97-101``): true cosine annealing, cosine with restarts,
multi-step (with restarts), linear decay, the reference's ``VibrateLR``,
and linear warmup. ``step`` is the number of optimizer updates already
applied.
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Callable, Mapping, Optional, Sequence

Schedule = Callable[[int], float]


def true_cosine_annealing(base_lr: float, T_max: int,
                          eta_min: float = 0.0) -> Schedule:
    def schedule(step):
        t = min(step, T_max)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * t / T_max))

    return schedule


def cosine_annealing_restart(base_lr: float, periods: Sequence[int],
                             restart_weights: Optional[Sequence[float]] = None,
                             eta_min: float = 0.0) -> Schedule:
    restart_weights = list(restart_weights or [1.0] * len(periods))
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights must match")
    starts = [0]
    for p in periods[:-1]:
        starts.append(starts[-1] + p)

    def schedule(step):
        idx = min(max(bisect.bisect_right(starts, step) - 1, 0),
                  len(periods) - 1)
        t = step - starts[idx]
        period = periods[idx]
        return eta_min + 0.5 * restart_weights[idx] * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * min(t, period) / period))

    return schedule


def multistep_restart(base_lr: float, milestones: Sequence[int],
                      gamma: float = 0.1, restarts: Sequence[int] = (0,),
                      restart_weights: Sequence[float] = (1.0,)) -> Schedule:
    milestones = sorted(milestones)
    restarts = list(restarts)

    def schedule(step):
        ridx = bisect.bisect_right(restarts, step) - 1
        w = (restart_weights[min(ridx, len(restart_weights) - 1)]
             if ridx >= 0 else 1.0)
        return base_lr * w * gamma ** bisect.bisect_right(milestones, step)

    return schedule


def linear_decay(base_lr: float, total_iter: int) -> Schedule:
    def schedule(step):
        return base_lr * (1.0 - min(step, total_iter) / total_iter)

    return schedule


def vibrate(base_lr: float, total_iter: int) -> Schedule:
    """Reference ``VibrateLR``: a triangle of period ``total_iter / 80``
    under an envelope ``max(0.1 - 0.25 * progress, 0.01)``."""
    period = max(total_iter // 80, 2)
    half = max(period // 2, 1)

    def schedule(step):
        envelope = max(0.1 - 0.25 * step / total_iter, 0.01)
        th = step % period
        tri = th / half if th < half else 2.0 - th / half
        return base_lr * envelope * tri

    return schedule


def with_warmup(schedule: Schedule, warmup_iter: int) -> Schedule:
    """Linear warmup from 0 over ``warmup_iter`` steps (<= 0: none)."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step):
        return schedule(step) * min(step / warmup_iter, 1.0)

    return warmed


def make_schedule(opt: Mapping[str, Any], base_lr: float,
                  warmup_iter: int = -1) -> Schedule:
    """A schedule from a ``train.scheduler`` block (``type`` + kwargs)."""
    opt = dict(opt)
    stype = opt.pop("type")
    if stype in ("TrueCosineAnnealingLR", "CosineAnnealingLR"):
        sched = true_cosine_annealing(base_lr, T_max=opt["T_max"],
                                      eta_min=opt.get("eta_min", 0.0))
    elif stype == "CosineAnnealingRestartLR":
        sched = cosine_annealing_restart(
            base_lr, periods=opt["periods"],
            restart_weights=opt.get("restart_weights"),
            eta_min=opt.get("eta_min", 0.0))
    elif stype == "MultiStepLR":
        sched = multistep_restart(base_lr, milestones=opt["milestones"],
                                  gamma=opt.get("gamma", 0.1))
    elif stype == "MultiStepRestartLR":
        sched = multistep_restart(
            base_lr, milestones=opt["milestones"],
            gamma=opt.get("gamma", 0.1), restarts=opt.get("restarts", (0,)),
            restart_weights=opt.get("restart_weights", (1.0,)))
    elif stype == "LinearLR":
        sched = linear_decay(base_lr, total_iter=opt["total_iter"])
    elif stype == "VibrateLR":
        sched = vibrate(base_lr, total_iter=opt["total_iter"])
    else:
        raise ValueError(f"unknown scheduler type {stype!r}")
    return with_warmup(sched, warmup_iter)
