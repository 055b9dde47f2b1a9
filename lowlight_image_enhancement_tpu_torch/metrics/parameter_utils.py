"""Parameter counting.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/parameter_utils.py``
(reference ``metrics/parameter_utils.py:12-35``): ``count_parameters(
params, unit in {raw, K, M})`` over the trainable parameters. An
``nn.Module`` counts the parameters that require a gradient (buffers, such
as BatchNorm statistics, are not parameters); a mapping (a ``state_dict``
or any nested dict) or a sequence counts every tensor or array in it, as
the JAX function counts every leaf of a parameter tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
from torch import nn

_UNITS = {"raw": 1.0, "K": 1e3, "M": 1e6}


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_parameters(params: Any, unit: str = "raw") -> float:
    """Number of parameter elements of ``params``, in ``unit``: ``'raw'``
    (a count), ``'K'`` (thousands) or ``'M'`` (millions)."""
    if unit not in _UNITS:
        raise ValueError(f"unit must be one of {sorted(_UNITS)}")
    if isinstance(params, nn.Module):
        total = sum(p.numel() for p in params.parameters()
                    if p.requires_grad)
    else:
        total = sum(int(np.prod(np.shape(leaf))) for leaf in _leaves(params))
    return total / _UNITS[unit] if unit != "raw" else float(total)
