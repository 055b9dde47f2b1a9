"""The loss factories of the experiment trainer.

Counterpart of ``build_hybrid_loss`` and of the loss set-up in
``Trainer.__init__`` of
``lowlight_image_enhancement_tpu/training/trainer.py``. The ``Trainer``
class (config -> data -> model -> loop, checkpoints, validation) waits
for the port's data slice, with ``train.py`` and ``checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.losses import build_loss
from lowlight_image_enhancement_tpu_torch.losses.hybrid import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    build_psf_kernels,
    create_crosstalk_psf,
    normalize_psf_energy,
)


def build_hybrid_loss(train_opt: Mapping[str, Any],
                      device: Any = "cuda") -> Optional[HybridLossPlus]:
    """``HybridLossPlus`` from the ``train.hybrid_opt`` block (reference
    ``image_restoration_model.py:76-101``), on ``device``:

    - ``pretrained`` becomes ``require_pretrained`` (default True: a
      config that asks for the perceptual term gets ImageNet VGG19 or an
      error; ``pretrained: false`` opts into the random trunk);
    - ``enable_amp`` runs the perceptual trunk in bf16;
    - ``perceptual.pool_impl`` selects the trunk's max-pool implementation
      (``models/vgg.py``; absent: the default);
    - the ``physics`` block becomes a ``CrosstalkPSF`` (sRGB, default) or,
      with ``domain: raw``, the normalised raw kernel."""
    hybrid_opt = train_opt.get("hybrid_opt")
    if not hybrid_opt:
        return None
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = dict(hybrid_opt)
    kwargs.pop("type", None)
    kwargs.pop("device", None)
    physics = kwargs.pop("physics", None)
    perceptual = kwargs.pop("perceptual", None) or {}
    if "pool_impl" in perceptual:
        kwargs["perc_pool_impl"] = perceptual["pool_impl"]
    kwargs.setdefault("require_pretrained",
                      bool(kwargs.pop("pretrained", True)))
    if train_opt.get("enable_amp", False):
        kwargs.setdefault("perc_dtype", torch.bfloat16)
    if physics and kwargs.get("use_phys", True):
        mode = physics.get("mode", "mono")
        spec = physics.get("kernel_spec")
        if physics.get("domain", "srgb") == "raw":
            kwargs["physics_kernel"] = normalize_psf_energy(build_psf_kernels(
                mode, spec or ("P2" if mode == "mono" else "B2"))).to(dev)
        else:
            kwargs["physics_psf_module"] = create_crosstalk_psf(mode, spec)
    return HybridLossPlus(**kwargs).to(dev)


def build_training_losses(train_opt: Mapping[str, Any], device: Any = "cuda"
                          ) -> Tuple[HybridLossPlus, Optional[Callable]]:
    """``(loss, pixel_loss)`` for ``make_train_step`` as the JAX ``Trainer``
    sets them up: the ``hybrid_opt`` loss, and the ``pixel_opt`` loss when
    the config has one. A pixel-only config (``configs/stereo_nafssr.yml``)
    gets a ``HybridLossPlus`` with every term off and the raw L1 weighted
    0, so the pixel loss is the whole objective."""
    loss = build_hybrid_loss(train_opt, device)
    if loss is None:
        loss = HybridLossPlus(
            w_l1_raw=0.0 if train_opt.get("pixel_opt") else 1.0,
            use_perc=False, use_deltaE=False, use_ssim=False,
            use_phys=False).to(resolve_device(device))
    pixel_loss = (build_loss(train_opt["pixel_opt"])
                  if train_opt.get("pixel_opt") else None)
    return loss, pixel_loss
