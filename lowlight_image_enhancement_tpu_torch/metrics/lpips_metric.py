"""LPIPS evaluator classes (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/lpips_metric.py``
(reference ``metrics/lpips_metric.py:34-365``): :class:`LPIPSMetric`
(``alex``/``vgg`` backbone, a frozen model cached per net, weights and
device, automatic range mapping of [0, 255] / [0, 1] to [-1, 1], gray
promoted to 3 channels, ``resize`` / ``center_crop`` align policies, a
result dict carrying net/version/policy and ``pretrained``),
:class:`LPIPSEvaluator` (the legacy float API) and :func:`evaluate_pairs`.
The model runs on ``device`` (``"cuda"`` by default); inputs are moved
there. Weights as in :func:`...models.lpips.load_lpips`; without them the
metric runs with deterministic random features and says so
(``pretrained: False``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array
from lowlight_image_enhancement_tpu_torch.metrics.ssim import align_pair
from lowlight_image_enhancement_tpu_torch.models.lpips import load_lpips


def _to_minus1_1(x: torch.Tensor) -> torch.Tensor:
    """Automatic range mapping (reference ``_to_minus1_1:262-273``)."""
    lo, hi = float(x.min()), float(x.max())
    if lo < -0.01:  # already [-1, 1]
        return x
    if hi > 2.0:  # [0, 255]
        return x / 127.5 - 1.0
    return x * 2.0 - 1.0  # [0, 1]


def _gray_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


_CACHE: Dict[tuple, tuple] = {}


def lpips_model(net: str, spatial: bool = False,
                weights_path: Optional[str] = None, device: Any = "cuda"):
    """``(module on device, pretrained)``, built once per (net, spatial,
    weights, device) and kept in ``_CACHE``."""
    dev = resolve_device(device)
    key = (net, spatial, weights_path, str(dev))
    if key not in _CACHE:
        module, pretrained = load_lpips(net=net, spatial=spatial,
                                        weights_path=weights_path)
        _CACHE[key] = (module.to(dev).eval(), pretrained)
    return _CACHE[key]


class LPIPSMetric:
    """Configurable LPIPS evaluator over NCHW batches."""

    def __init__(self, net: str = "alex", version: str = "0.1",
                 align_policy: str = "error",
                 weights_path: Optional[str] = None, device: Any = "cuda"):
        if version != "0.1":
            raise ValueError("only LPIPS version 0.1 is supported")
        self.net = net
        self.version = version
        self.align_policy = align_policy
        self.device = resolve_device(device)
        self.model, self.pretrained = lpips_model(
            net, weights_path=weights_path, device=self.device)

    @torch.no_grad()
    def per_image(self, pred: torch.Tensor,
                  target: torch.Tensor) -> np.ndarray:
        """Per-image distances ``[N]``."""
        p = torch.as_tensor(pred).to(self.device, torch.float32)
        t = torch.as_tensor(target).to(self.device, torch.float32)
        if p.dim() != 4 or t.dim() != 4:
            raise ValueError("expected NCHW batches")
        p, t = _gray_to_rgb(p), _gray_to_rgb(t)
        if min(p.shape[2], p.shape[3]) < 16:
            raise ValueError("LPIPS requires images >= 16x16")
        p, t = align_pair(p, t, self.align_policy)
        return host_array(self.model(_to_minus1_1(p), _to_minus1_1(t)))

    def distance(self, pred: torch.Tensor, target: torch.Tensor) -> float:
        return float(np.mean(self.per_image(pred, target)))

    def evaluate(self, pred: torch.Tensor,
                 target: torch.Tensor) -> Dict[str, Any]:
        scores = self.per_image(pred, target)
        return {
            "lpips_mean": float(scores.mean()),
            "lpips_std": float(scores.std()),
            "per_image": scores.tolist(),
            "config": {
                "net": self.net,
                "version": self.version,
                "align_policy": self.align_policy,
                "range_mapping": "[-1,1] auto",
                "pretrained": bool(self.pretrained),
            },
        }


class LPIPSEvaluator:
    """Legacy float API (reference ``LPIPSEvaluator``)."""

    def __init__(self, net: str = "alex", **kwargs):
        self._metric = LPIPSMetric(net=net, **kwargs)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> float:
        return self._metric.distance(pred, target)


def evaluate_pairs(pairs, net: str = "alex", **kwargs) -> Dict[str, Any]:
    """LPIPS over an iterable of (pred, target) NCHW pairs."""
    metric = LPIPSMetric(net=net, **kwargs)
    scores: List[float] = []
    for pred, target in pairs:
        scores.extend(metric.per_image(pred, target).tolist())
    arr = np.asarray(scores)
    return {"lpips_mean": float(arr.mean()), "count": int(arr.size),
            "per_image": scores}
