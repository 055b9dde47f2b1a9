"""Loss stack: elementwise losses and the NewBP hybrid losses (NCHW).

``build_loss(opt)`` resolves ``{'type': Name, **kwargs}`` through the
port's LOSS_REGISTRY (counterpart of
``lowlight_image_enhancement_tpu/losses/__init__.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

from lowlight_image_enhancement_tpu_torch.losses.basic import (  # noqa: F401
    CharbonnierLoss,
    L1Loss,
    MSELoss,
    PSNRLoss,
    charbonnier_loss,
    l1_loss,
    mse_loss,
    psnr_loss,
)
from lowlight_image_enhancement_tpu_torch.losses.components import (  # noqa: F401
    DeltaE00Loss,
    PerceptualLoss,
    PhysicalConsistencyLossSRGB,
    PhysicsConsistencyLoss,
    SSIMLoss,
    align_exposure_srgb,
)
from lowlight_image_enhancement_tpu_torch.losses.hybrid import (  # noqa: F401
    HybridLoss,
    HybridLossPlus,
    assert_finite_logs,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import LOSS_REGISTRY


def build_loss(opt: Mapping[str, Any]):
    """Instantiate a loss from ``{'type': Name, **kwargs}``."""
    opt = copy.deepcopy(dict(opt))
    return LOSS_REGISTRY.get(opt.pop("type"))(**opt)
