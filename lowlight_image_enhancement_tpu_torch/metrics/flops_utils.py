"""FLOPs accounting with ``torch.utils.flop_counter.FlopCounterMode``.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/flops_utils.py``
(reference ``metrics/flops_utils.py:181-370``, fvcore-based), with its
conventions:

- ``fvcore_fma1``: a multiply-add counts 1 (fvcore's; equal to MACs);
- ``macs``: the same;
- ``flops_2xmac``: 2 per multiply-add.

``FlopCounterMode`` counts the products (convolutions, ``mm``, ``bmm``,
``addmm``, attention) at 2 per multiply-add, so ``fvcore_fma1`` is half
its total. It counts what runs through PyTorch's dispatcher only: the
fused NAFBlock's registered ops (``llie_torch::nafblock_a``,
``nafblock_b``) carry FLOP formulas equal to their plain versions'
products, but the other hand-written kernels are ctypes calls it cannot
see, so the count is taken on the plain path. ``count`` refuses CUDA
tensors; pass CPU tensors, or meta tensors (``model.to("meta")``, no
arithmetic at all), on which every wrapper runs its plain version. The JAX count (XLA's cost
analysis) also includes elementwise work, so it is larger than this one
for the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_CONVENTIONS = {"fvcore_fma1", "macs", "flops_2xmac"}


@dataclasses.dataclass
class FLOPsResult:
    """``total`` in the requested convention; ``metadata`` echoes the
    measurement contract; ``raw_cost`` holds the counter's FLOPs
    (2 per multiply-add) by operator."""

    total: float
    convention: str
    per_sample: Optional[float]
    metadata: Dict[str, Any]
    raw_cost: Dict[str, float]

    def total_g(self) -> float:
        return self.total / 1e9

    def total_m(self) -> float:
        return self.total / 1e6


class FLOPsCounter:
    """FLOPs of ``fn(*args)`` on the plain path::

        counter = FLOPsCounter(convention="fvcore_fma1")
        res = counter.count(model, torch.empty(1, 3, 64, 64, device="meta"))
    """

    def __init__(self, convention: str = "fvcore_fma1"):
        if convention not in _CONVENTIONS:
            raise ValueError(
                f"convention must be one of {sorted(_CONVENTIONS)}")
        self.convention = convention

    def count(self, fn: Callable[..., Any], *args,
              per_sample_batch: Optional[int] = None,
              **kwargs) -> FLOPsResult:
        devices = {t.device.type for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
        if "cuda" in devices:
            raise ValueError(
                "count_flops runs on the plain path: pass CPU or meta "
                "tensors (FlopCounterMode cannot see the hand-written "
                "kernels that CUDA tensors reach)")
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args, **kwargs)
        flops = float(counter.get_total_flops())
        total = flops / 2.0 if self.convention != "flops_2xmac" else flops
        return FLOPsResult(
            total=total,
            convention=self.convention,
            per_sample=total / per_sample_batch if per_sample_batch
            else None,
            metadata={
                "backend": ("torch.utils.flop_counter on the plain path ("
                            + ", ".join(sorted(devices)) + " tensors)"),
                "convention": self.convention,
                "note": ("the counter reports 2*MAC; fvcore_fma1 = "
                         "counter/2; products only, no elementwise work"),
            },
            raw_cost={str(op): float(n) for op, n in
                      counter.get_flop_counts()["Global"].items()},
        )


def count_flops(fn: Callable[..., Any], *args,
                convention: str = "fvcore_fma1", **kwargs
                ) -> Dict[str, float]:
    """Legacy convenience API in M/G units (reference ``count_flops``)."""
    res = FLOPsCounter(convention=convention).count(fn, *args, **kwargs)
    return {
        "flops": res.total,
        "flops_M": res.total_m(),
        "flops_G": res.total_g(),
        "convention": convention,
    }
