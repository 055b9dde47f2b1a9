"""HybridLossPlus smoke harness (counterpart of ``tools/debug_losses.py``):
every loss-term combination on one numpy-seeded batch, with the term
values and the norm of the gradient with respect to the prediction. First
step of the debug-first workflow (debug_losses -> debug_overfit -> pack
build -> pytest -> training)::

    python -m lowlight_image_enhancement_tpu_torch.tools.debug_losses [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.losses import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    build_psf_kernels,
    create_crosstalk_psf,
)
from lowlight_image_enhancement_tpu_torch.tools.common import (
    add_device_arg,
    nchw,
)

NO_TERMS = dict(use_perc=False, use_deltaE=False, use_ssim=False)


def configs() -> Dict[str, Dict[str, Any]]:
    """The combinations of ``debug_losses.py:37-58``."""
    return {
        "l1_only": dict(NO_TERMS, use_phys=False),
        "l1+deltaE+ssim": dict(use_perc=False, use_deltaE=True,
                               use_ssim=True, use_phys=False),
        "l1+phys_srgb": dict(NO_TERMS,
                             physics_psf_module=create_crosstalk_psf("mono")),
        "l1+phys_raw": dict(NO_TERMS,
                            physics_kernel=build_psf_kernels("mono", "P2")),
        "full_no_perc": dict(use_perc=False, use_deltaE=True, use_ssim=True,
                             physics_psf_module=create_crosstalk_psf(
                                 "rgb", "B2")),
        "perceptual": dict(use_perc=True, use_deltaE=False, use_ssim=False,
                           use_phys=False),
        "uncertainty": dict(use_perc=False, use_deltaE=True, use_ssim=False,
                            use_phys=False, use_uncertainty=True),
    }


def make_batch(dev: torch.device) -> Dict[str, torch.Tensor]:
    """The seeded 2x3x64x64 batch of ``debug_losses.py:26-34``, NCHW."""
    rng = np.random.default_rng(0)
    n, s = 2, 64
    mk = lambda lo=0.0, hi=1.0: rng.uniform(  # noqa: E731
        lo, hi, (n, s, s, 3)).astype(np.float32)
    return nchw(dict(Bhat_raw=mk(), B_raw=mk(), A_raw=mk(0, 0.2),
                     expo_ratio=np.full((n,), 5.0, np.float32),
                     Bhat_srgb01=mk(), B_srgb01=mk(), A_srgb01=mk(0, 0.2)),
                dev)


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = make_batch(dev)

    results = {}
    for name, kwargs in configs().items():
        loss = HybridLossPlus(**kwargs).to(dev)
        sig = loss.log_sigma if loss.use_uncertainty else None
        with torch.no_grad():
            total, logs = loss(**batch, log_sigma=sig)
        bhat = batch["Bhat_raw"].clone().requires_grad_(True)
        t, _ = loss(**{**batch, "Bhat_raw": bhat,
                       "Bhat_srgb01": bhat.clamp(0, 1)}, log_sigma=sig)
        (g,) = torch.autograd.grad(t, bhat)
        gnorm = float(torch.linalg.vector_norm(g))
        total = float(total)
        terms = {k: float(v) for k, v in logs.items()}
        ok = np.isfinite(total) and np.isfinite(gnorm)
        shown = {k: f"{v:.4f}" for k, v in terms.items()}
        print(f"[{'OK' if ok else 'FAIL'}] {name:16s} total={total:.4f} "
              f"grad_norm={gnorm:.4f} {shown}")
        results[name] = {"ok": bool(ok), "total": total, "grad_norm": gnorm,
                         "terms": terms}
    return results


if __name__ == "__main__":
    main()
