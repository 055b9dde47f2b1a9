"""Batch-level training augmentations: mixup.

Counterpart of ``lowlight_image_enhancement_tpu/training/augment.py``
(reference hook ``train.mixup``, ``image_restoration_model.py:250-252``):
pairs within the batch are convex-combined with one Beta-distributed
coefficient, identically for every image entry and ``expo_ratio``, so the
lq/gt/short_raw/long_raw relations of the physics terms hold.

The draws come from an explicit ``torch.Generator`` (the JAX version
folds the step into a ``PRNGKey``): given the same coefficient and
permutation the arithmetic is the JAX function's, the draws themselves
differ.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

_IMAGE_KEYS = ("lq", "gt", "short_raw", "long_raw", "short_obs")


def mixup_draw(n: int, alpha: float, generator: torch.Generator):
    """``(lam, perm)``: ``lam ~ Beta(alpha, alpha)`` and a random
    permutation of ``n``, both from ``generator`` (on the host)."""
    g1 = torch._standard_gamma(torch.full((2,), float(alpha)),
                               generator=generator)
    lam = float(g1[0] / (g1[0] + g1[1]))
    perm = torch.randperm(n, generator=generator)
    return lam, perm


def mixup_batch(batch: Mapping[str, torch.Tensor], alpha: float = 1.2,
                generator: Optional[torch.Generator] = None,
                lam: Optional[float] = None,
                perm: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Mixup over the batch axis: every image entry and ``expo_ratio``
    becomes ``lam * v + (1 - lam) * v[perm]``. ``lam`` and ``perm`` are
    drawn from ``generator`` unless given."""
    out = dict(batch)
    n = batch["lq"].shape[0]
    if lam is None or perm is None:
        lam, perm = mixup_draw(n, alpha, generator)
    for key in _IMAGE_KEYS + ("expo_ratio",):
        if key in out:
            v = out[key]
            out[key] = lam * v + (1.0 - lam) * v[perm.to(v.device)]
    return out
