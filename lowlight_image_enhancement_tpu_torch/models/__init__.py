"""Architecture registry + factory, counterpart of
``lowlight_image_enhancement_tpu/models/__init__.py``.

``define_network(opt, device)`` instantiates a registered architecture from
a config dict whose ``type:`` key names the class/factory, and moves it to
``device`` (``"cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.models import newbp as _newbp  # noqa: F401
from lowlight_image_enhancement_tpu_torch.models.nafnet import (  # noqa: F401
    NAFBlock,
    NAFNet,
    SimpleGate,
    pixel_shuffle,
    simple_gate,
)
from lowlight_image_enhancement_tpu_torch.models.newbp import (  # noqa: F401
    as_dtype,
    create_newbp_net,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


def define_network(opt: Mapping[str, Any], device: Any = "cuda"):
    """Instantiate ``{'type': Name, **kwargs}`` on ``device``."""
    dev = resolve_device(device)
    opt = copy.deepcopy(dict(opt))
    cls = ARCH_REGISTRY.get(opt.pop("type"))
    if cls is _newbp.newbp_nafnet:
        return cls(device=dev, **opt)
    if "dtype" in opt:
        opt["dtype"] = as_dtype(opt["dtype"])
    return cls(**opt).to(dev)
