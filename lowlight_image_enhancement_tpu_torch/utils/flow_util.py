"""Optical-flow file I/O + visualization (reference ``utils/flow_util.py``):
the port's copy of ``lowlight_image_enhancement_tpu/utils/flow_util.py``.

- :func:`flowread` / :func:`flowwrite` — the Middlebury ``.flo`` format
  (magic ``PIEH``, little-endian W/H, interleaved float32 u/v).
- :func:`flow_to_color` — standard flow color-wheel visualization.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 202021.25


def flowread(path: str) -> np.ndarray:
    """Read a ``.flo`` file -> float32 ``[H, W, 2]`` (u, v)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2).copy()


def flowwrite(flow: np.ndarray, path: str) -> None:
    """Write float ``[H, W, 2]`` flow as ``.flo``."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"expected [H, W, 2] flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())


def _color_wheel() -> np.ndarray:
    """The standard 55-color flow wheel (RY/YG/GC/CB/BM/MR segments)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:, 0] = 255
    return wheel / 255.0


def flow_to_color(flow: np.ndarray,
                  max_magnitude: float | None = None) -> np.ndarray:
    """Flow ``[H, W, 2]`` -> RGB float [0,1] visualization."""
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u**2 + v**2)
    if max_magnitude is None:
        max_magnitude = max(float(mag.max()), 1e-6)
    u, v = u / max_magnitude, v / max_magnitude
    mag = np.minimum(mag / max_magnitude, 1.0)

    wheel = _color_wheel()
    n = len(wheel)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int) % n
    k1 = (k0 + 1) % n
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * wheel[k0] + f * wheel[k1]
    # saturate toward white at low magnitude
    return 1 - mag[..., None] * (1 - col)
