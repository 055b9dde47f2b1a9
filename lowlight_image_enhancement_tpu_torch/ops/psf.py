"""Scenario-B cross-pixel-crosstalk PSF operator (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/ops/psf.py`` (reference
``NewBP_model/newbp_layer.py``):

- :func:`build_psf_kernels`: the canonical P2 (mono) / B2 (rgb) 3x3
  kernels, canonical shape ``[C_k, kh, kw]`` with ``C_k`` 1 or C;
- :func:`normalize_psf_energy`: each kernel divided by its (clamped) sum;
- :func:`depthwise_conv`: groups=C cross-correlation with zero, replicate
  or reflect padding;
- :func:`newbp_conv`: the zero-padded depthwise conv whose backward is the
  conv of the cotangent with the flipped kernel (its exact adjoint), and
  no kernel grad;
- :class:`CrosstalkPSF`: the loss-path PSF, its kernel a buffer (state,
  never optimised), applied to the prediction only;
- :class:`NewBPLayer`: the reference's deprecated input-side layer, a
  guard that raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Canonical kernel constants (reference newbp_layer.py:129-173).
_P2 = np.array(
    [[0.0100, 0.0200, 0.0100],
     [0.0200, 0.8800, 0.0200],
     [0.0100, 0.0200, 0.0100]],
    dtype=np.float32,
)
_B2_RED = np.array(
    [[0.0117, 0.0233, 0.0117],
     [0.0233, 0.8600, 0.0233],
     [0.0117, 0.0233, 0.0117]],
    dtype=np.float32,
)
_B2_GREEN = _P2
_B2_BLUE = np.array(
    [[0.0083, 0.0167, 0.0083],
     [0.0167, 0.9000, 0.0167],
     [0.0083, 0.0167, 0.0083]],
    dtype=np.float32,
)

_PAD_MODES = {"zero": "constant", "replicate": "replicate",
              "reflect": "reflect"}


def build_psf_kernels(mode: str, kernel_spec: str = "P2") -> torch.Tensor:
    """``[1, 3, 3]`` (mono, P2) or ``[3, 3, 3]`` (rgb, B2 in R, G, B
    order) float32 kernels."""
    if mode not in {"mono", "rgb"}:
        raise ValueError(f"mode must be 'mono' or 'rgb', got {mode!r}")
    if mode == "mono":
        if kernel_spec != "P2":
            raise ValueError("mono mode expects kernel_spec 'P2'")
        return torch.from_numpy(_P2[None].copy())
    if kernel_spec != "B2":
        raise ValueError("rgb mode expects kernel_spec 'B2'")
    return torch.from_numpy(np.stack([_B2_RED, _B2_GREEN, _B2_BLUE]))


def normalize_psf_energy(kernel: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    """Each ``[kh, kw]`` kernel divided by its sum, clamped to ``eps``
    (reference ``newbp_layer.py:102-106``)."""
    kernel = torch.as_tensor(kernel)
    s = kernel.reshape(kernel.shape[0], -1).sum(1).clamp(min=eps)
    return kernel / s[:, None, None]


def _canonical(kernel: torch.Tensor, channels: int) -> torch.Tensor:
    kernel = torch.as_tensor(kernel)
    if kernel.dim() == 2:
        kernel = kernel[None]
    if kernel.shape[0] not in (1, channels):
        raise ValueError(
            f"kernel channels ({kernel.shape[0]}) must be 1 or match input "
            f"channels ({channels})")
    return kernel


def depthwise_conv(x: torch.Tensor, kernel: torch.Tensor, *,
                   padding: str = "zero", pad_same: bool = True
                   ) -> torch.Tensor:
    """Depthwise (groups=C) cross-correlation of NCHW ``x`` with a
    canonical ``[C_k, kh, kw]`` kernel (``C_k`` 1 broadcasts to every
    channel); SAME amounts of ``padding`` when ``pad_same``, else VALID."""
    if padding not in _PAD_MODES:
        raise ValueError(f"padding must be one of {sorted(_PAD_MODES)}")
    c = x.shape[1]
    kernel = _canonical(kernel, c).to(device=x.device, dtype=x.dtype)
    _, kh, kw = kernel.shape
    if pad_same and (kh > 1 or kw > 1):
        ph, pw = kh // 2, kw // 2
        x = F.pad(x, (pw, pw, ph, ph), mode=_PAD_MODES[padding])
    weight = kernel.expand(c, kh, kw)[:, None]
    return F.conv2d(x, weight, groups=c)


class _NewBPConv(torch.autograd.Function):
    """Zero-padded depthwise conv; backward = the same conv with the
    flipped kernel (reference ``NewBPFunction``, ``newbp_layer.py:7-21``)."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(kernel)
        return depthwise_conv(x, kernel, padding="zero")

    @staticmethod
    def backward(ctx, g):
        (kernel,) = ctx.saved_tensors
        return depthwise_conv(g, kernel.flip(-2, -1), padding="zero"), None


def newbp_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise conv (zero pad SAME) with the explicit adjoint backward;
    the kernel gets no gradient."""
    return _NewBPConv.apply(x, _canonical(kernel, x.shape[1]).detach())


def apply_psf(x: torch.Tensor, kernel: torch.Tensor, *,
              padding: str = "zero", explicit_adjoint: bool = True
              ) -> torch.Tensor:
    """The PSF applied depthwise to an NCHW batch: :func:`newbp_conv` for
    zero padding with ``explicit_adjoint``, else autograd through
    :func:`depthwise_conv`."""
    if explicit_adjoint and padding == "zero":
        return newbp_conv(x, kernel)
    return depthwise_conv(x, kernel, padding=padding)


class CrosstalkPSF(nn.Module):
    """Fixed PSF used ONLY in the loss graph (reference ``CrosstalkPSF``,
    ``newbp_layer.py:88-126``): ``mode='mono'`` takes a ``[1, 3, 3]``
    kernel shared by the three channels, ``mode='rgb'`` a ``[3, 3, 3]``.
    The energy-normalised kernel is a buffer: it follows ``.to(device)``
    and the state dict but is never a parameter and gets no gradient."""

    def __init__(self, mode: str, kernels):
        super().__init__()
        if mode not in {"mono", "rgb"}:
            raise ValueError(f"mode must be 'mono' or 'rgb', got {mode!r}")
        kernel = torch.as_tensor(kernels, dtype=torch.float32)
        if kernel.dim() == 2:
            kernel = kernel[None]
        if kernel.dim() == 4:  # torch-style [C, 1, kh, kw]
            kernel = kernel[:, 0]
        want = (1, 3, 3) if mode == "mono" else (3, 3, 3)
        if tuple(kernel.shape) != want:
            raise ValueError(f"{mode} mode expects kernel {list(want)}, got "
                             f"{list(kernel.shape)}")
        self.mode = mode
        self.register_buffer("kernel", normalize_psf_energy(kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Depthwise PSF conv on sRGB NCHW input (padding 1, stride 1)."""
        if x.dim() != 4 or x.shape[1] != 3:
            raise ValueError("CrosstalkPSF expects sRGB inputs (3 channels, "
                             f"NCHW); got shape {tuple(x.shape)}")
        return newbp_conv(x, self.kernel)


def create_crosstalk_psf(mode: str = "mono",
                         kernel_spec: Optional[str] = None) -> CrosstalkPSF:
    """Reference ``create_crosstalk_psf`` (``newbp_net_arch.py:88-99``)."""
    if mode not in {"mono", "rgb"}:
        raise ValueError(f"mode must be 'mono' or 'rgb', got {mode!r}")
    if kernel_spec is None:
        kernel_spec = "P2" if mode == "mono" else "B2"
    return CrosstalkPSF(mode, build_psf_kernels(mode, kernel_spec))


class NewBPLayer:
    """Deprecated input-side crosstalk layer (API-compat error stub).

    The reference keeps a legacy layer that raises when used with
    ``deprecated=True`` (default) because Scenario B forbids input-side
    crosstalk (``newbp_layer.py:24-85``). The guard is kept, with the
    JAX package's messages.
    """

    def __init__(self, *args, deprecated: bool = True, **kwargs):
        self.deprecated = deprecated
        if not deprecated:
            raise NotImplementedError(
                "Input-side NewBPLayer is not supported in the TPU rebuild; "
                "use CrosstalkPSF in the loss path (Scenario B)."
            )

    def __call__(self, x):
        raise RuntimeError(
            "Deprecated: use CrosstalkPSF in loss path (Scenario B)"
        )
