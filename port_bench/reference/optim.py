"""Plain optimizer of the NewBP recipe: global-norm clip, then AdamW.

``optax.chain(clip_by_global_norm(max_norm), adamw(lr))`` written out:
the clip scales every gradient by ``max_norm / |g|`` when ``|g| >=
max_norm``; AdamW keeps ``m``, ``v``, adds ``eps`` outside the square
root and decays every parameter; the learning rate is read at the number
of updates already applied, from the true cosine annealing schedule,
times ``min(updates / warmup_iter, 1)`` where the recipe warms up.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch


def cosine_lr(step: int, base: float, t_max: int, eta_min: float) -> float:
    t = min(step, t_max)
    return eta_min + 0.5 * (base - eta_min) * (1.0 + math.cos(
        math.pi * t / t_max))


class AdamWClip:
    """State over a list of fp32 parameters, updated in place."""

    def __init__(self, params: List[torch.Tensor], train_opt: Mapping):
        optim = train_opt["optim_g"]
        if optim.get("type", "AdamW") != "AdamW":
            raise ValueError("the reference optimizer is AdamW")
        sched = train_opt["scheduler"]
        if sched["type"] not in ("TrueCosineAnnealingLR",
                                 "CosineAnnealingLR"):
            raise ValueError("the reference schedule is cosine annealing")
        if int(train_opt.get("accum_steps", 1)) != 1:
            raise ValueError("no gradient accumulation in the reference")
        self.warmup = int(train_opt.get("warmup_iter", -1))
        self.params = params
        self.lr = float(optim["lr"])
        self.b1, self.b2 = (float(b) for b in optim.get("betas",
                                                        (0.9, 0.999)))
        self.wd = float(optim.get("weight_decay", 0.01))
        self.t_max = int(sched["T_max"])
        self.eta_min = float(sched.get("eta_min", 0.0))
        self.max_norm = 0.01 if train_opt.get("use_grad_clip", True) \
            else None
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    def rate(self, updates: int) -> float:
        """The learning rate of the update after ``updates`` updates."""
        lr = cosine_lr(updates, self.lr, self.t_max, self.eta_min)
        return lr * min(updates / self.warmup, 1.0) if self.warmup > 0 \
            else lr

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        grads = [g.float().clone() for g in grads]
        if self.max_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if float(norm) >= self.max_norm:
                for g in grads:
                    g.mul_(self.max_norm / norm)
        lr = self.rate(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + 1e-8) + self.wd * p
            p.add_(u, alpha=-lr)
        return grads
