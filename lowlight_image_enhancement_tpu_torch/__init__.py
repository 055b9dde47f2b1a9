"""PyTorch + CUDA port of ``lowlight_image_enhancement_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference; this package imports none of
it (and no ``jax``). Entry points run on ``device="cuda"`` unless the
caller asks for the CPU; on the CPU every hand-written kernel is replaced
by its plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev
