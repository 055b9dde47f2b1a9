"""Image operations of the loss path (NCHW).

Counterpart of ``max_pool_2x2`` in
``lowlight_image_enhancement_tpu/ops/image_ops.py`` (its default
``reduce_window`` implementation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of NCHW ``x``: an odd trailing row or column
    is floored away, and the gradient goes to the first maximum of each
    window in the order (0,0), (0,1), (1,0), (1,1) (torch ``MaxPool2d`` and
    XLA select-and-scatter semantics)."""
    return F.max_pool2d(x, 2, 2)
