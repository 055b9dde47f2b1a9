"""The loss factory of the experiment trainer.

Counterpart of ``build_hybrid_loss`` in
``lowlight_image_enhancement_tpu/training/trainer.py``. The ``Trainer``
class (config -> data -> model -> loop, checkpoints, validation) waits
for the port's data slice, with ``train.py`` and ``checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
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
