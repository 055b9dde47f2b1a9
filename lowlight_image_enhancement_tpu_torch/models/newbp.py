"""NewBP model factories (Scenario B), counterpart of
``lowlight_image_enhancement_tpu/models/newbp.py``.

:func:`create_newbp_net` returns a **plain NAFNet**: the input observation
is never convolved with the PSF in the forward pass (the PSF lives only in
the loss branch, ported with the training slice). ``NewBPNAFNet`` is the
YAML-facing alias resolving through ``ARCH_REGISTRY``.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping, Optional, Sequence

import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def as_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (fp32 or bf16 only)."""
    if isinstance(dtype, str):
        dtype = _DTYPES.get(dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return dtype


def create_newbp_net(
    in_channels: int = 3,
    width: Optional[int] = None,
    enc_blk_nums: Optional[Sequence[int]] = None,
    middle_blk_num: Optional[int] = None,
    dec_blk_nums: Optional[Sequence[int]] = None,
    nafnet_params: Optional[Mapping[str, Any]] = None,
    dtype: Any = torch.float32,
    device: Any = "cuda",
    **_ignored: Any,
) -> NAFNet:
    """Build the Scenario-B backbone, a plain NAFNet, on ``device``.

    Maps ``in_channels/width/enc_blk_nums/middle_blk_num/dec_blk_nums`` or
    a ``nafnet_params`` dict onto NAFNet kwargs (defaults: width 32,
    (2,2,4,8), 12, (2,2,2,2)). Extra kwargs (``kernel_type`` /
    ``kernel_spec`` from YAML configs) are accepted and ignored here.
    """
    dev = resolve_device(device)
    params: dict[str, Any] = dict(nafnet_params or {})
    params.setdefault("img_channel", in_channels)
    for key, val in (("width", width), ("enc_blk_nums", enc_blk_nums),
                     ("middle_blk_num", middle_blk_num),
                     ("dec_blk_nums", dec_blk_nums)):
        if val is not None:
            params[key] = val
    params.setdefault("width", 32)
    params.setdefault("enc_blk_nums", (2, 2, 4, 8))
    params.setdefault("middle_blk_num", 12)
    params.setdefault("dec_blk_nums", (2, 2, 2, 2))
    params["enc_blk_nums"] = tuple(params["enc_blk_nums"])
    params["dec_blk_nums"] = tuple(params["dec_blk_nums"])
    params["dtype"] = as_dtype(params.get("dtype", dtype))
    logger.info("create_newbp_net: plain NAFNet (Scenario B). params=%s",
                params)
    return NAFNet(**params).to(dev)


@ARCH_REGISTRY.register(name="NewBPNAFNet")
def newbp_nafnet(**kwargs: Any) -> NAFNet:
    """YAML-facing adapter: ``type: NewBPNAFNet`` -> plain NAFNet."""
    return create_newbp_net(**kwargs)
