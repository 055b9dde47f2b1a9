"""Synthetic debug SID fixture generator (the hermetic "fake backend").

The port's copy of ``lowlight_image_enhancement_tpu/data/
debug_fixtures.py``: the same seeded draws and the same pack writer, so
the files from one seed are byte-equal to the JAX package's. Rebuild of
the reference's ``data/debug_sid/`` scheme (component C63): a
tiny synthetic dataset — N 64x64 pairs with known exposure ratio — plus a
manifest and prebuilt pack files, so the full
config -> dataset -> loader -> model -> train-steps path is testable
offline with no SID download.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.records import SidPackWriter


def make_debug_sid(
    root: str,
    n_pairs: int = 2,
    size: int = 64,
    ratio: float = 10.0,
    subsets: Tuple[str, ...] = ("train", "val"),
    seed: int = 0,
) -> Dict[str, str]:
    """Create a synthetic SID debug set under ``root``.

    Layout::

        root/manifest_sid_debug.json
        root/{subset}_short.pack
        root/{subset}_long.pack

    The "long" image is a smooth random field in [0,1]; the "short"
    observation is ``long / ratio`` plus mild noise — so exposure-aligned
    shorts approximate the longs, and a model can overfit them.

    Returns a dict of created paths.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    records = []
    paths: Dict[str, str] = {}

    for subset in subsets:
        short_path = os.path.join(root, f"{subset}_short.pack")
        long_path = os.path.join(root, f"{subset}_long.pack")
        with SidPackWriter(short_path, comp="zlib_band") as ws, \
                SidPackWriter(long_path, comp="zlib_band") as wl:
            for i in range(n_pairs):
                pair_id = f"{subset}_{i:05d}"
                base = rng.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
                # smooth upsample to size x size
                reps = size // 8
                long_img = np.kron(base, np.ones((reps, reps, 1),
                                                 np.float32))
                noise = rng.normal(0, 0.002, long_img.shape).astype(
                    np.float32
                )
                short_img = np.clip(long_img / ratio + noise, 0, 1)
                long_u16 = (long_img * 65535).astype(np.uint16)
                short_u16 = (short_img * 65535).astype(np.uint16)
                ws.add(pair_id, short_u16)
                wl.add(pair_id, long_u16)
                records.append({
                    "pair_id": pair_id,
                    "subset": subset,
                    "short_key": pair_id,
                    "long_key": pair_id,
                    "short_exposure": 0.1,
                    "long_exposure": 0.1 * ratio,
                    "exposure_ratio": ratio,
                })
        paths[f"{subset}_short"] = short_path
        paths[f"{subset}_long"] = long_path

    manifest_path = os.path.join(root, "manifest_sid_debug.json")
    with open(manifest_path, "w") as f:
        json.dump(records, f, indent=1)
    paths["manifest"] = manifest_path
    return paths


def _natural_image(rng: np.ndarray, size: int) -> np.ndarray:
    """Natural-image-like RGB in [0,1]: multi-octave 1/f luminance field
    with correlated chroma and a few smooth structural edges."""
    try:
        from scipy.ndimage import gaussian_filter
    except ImportError:  # pragma: no cover
        gaussian_filter = None

    def smooth(field, sigma):
        if gaussian_filter is not None:
            return gaussian_filter(field, sigma)
        # box-blur fallback
        k = max(int(sigma), 1)
        c = np.cumsum(np.cumsum(field, 0), 1)
        pad = np.pad(c, ((k + 1, 0), (k + 1, 0)))
        s = (pad[2 * k + 1:, 2 * k + 1:] - pad[2 * k + 1:, : -2 * k - 1]
             - pad[: -2 * k - 1, 2 * k + 1:]
             + pad[: -2 * k - 1, : -2 * k - 1])
        return s[: field.shape[0], : field.shape[1]] / (2 * k + 1) ** 2

    luma = np.zeros((size, size), np.float64)
    for octave in range(5):
        luma += smooth(rng.standard_normal((size, size)),
                       2.0 ** (octave + 1)) * (2.0 ** octave)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    for _ in range(3):
        a, b, c = rng.uniform(-2, 2, 3)
        luma += rng.uniform(0.5, 1.5) * luma.std() * np.tanh(
            10.0 * (a * xx + b * yy + c))
    luma -= luma.min()
    luma /= max(luma.max(), 1e-9)
    chroma = np.stack([
        smooth(rng.standard_normal((size, size)), 16.0) for _ in range(3)
    ], axis=-1)
    chroma = 0.15 * chroma / (np.abs(chroma).max() + 1e-9)
    img = np.clip(luma[..., None] * rng.uniform(0.6, 1.0, (1, 1, 3))
                  + chroma + 0.05, 0.0, 1.0)
    return img.astype(np.float32)


def make_synthetic_sid(
    root: str,
    n_train: int = 32,
    n_val: int = 8,
    size: int = 512,
    ratios: Tuple[float, ...] = (100.0, 250.0, 300.0),
    seed: int = 0,
    shot_noise: float = 0.08,
    read_noise: float = 0.002,
) -> Dict[str, str]:
    """A *realistic* synthetic SID set for matched-budget quality A/Bs.

    Same pack/manifest layout as :func:`make_debug_sid` but with
    natural-image-like longs, SID-magnitude exposure ratios
    (100/250/300, reference ``datasets/sony_sid_dataset.py`` pairing),
    and a physical short-exposure noise model:
    ``short = clip(long/ratio + shot + read)`` with signal-dependent shot
    noise ``N(0, shot_noise*sqrt(long/ratio))`` — so denoising difficulty
    scales with darkness like real SID shorts.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    records = []
    paths: Dict[str, str] = {}
    for subset, n_pairs in (("train", n_train), ("val", n_val)):
        short_path = os.path.join(root, f"{subset}_short.pack")
        long_path = os.path.join(root, f"{subset}_long.pack")
        with SidPackWriter(short_path, comp="zlib_band") as ws, \
                SidPackWriter(long_path, comp="zlib_band") as wl:
            for i in range(n_pairs):
                pair_id = f"{subset}_{i:05d}"
                ratio = float(ratios[i % len(ratios)])
                long_img = _natural_image(rng, size)
                dark = long_img / ratio
                noise = (rng.normal(0, 1, dark.shape) * shot_noise
                         * np.sqrt(dark)
                         + rng.normal(0, read_noise, dark.shape))
                short_img = np.clip(dark + noise, 0, 1).astype(np.float32)
                ws.add(pair_id, (short_img * 65535).astype(np.uint16))
                wl.add(pair_id, (long_img * 65535).astype(np.uint16))
                records.append({
                    "pair_id": pair_id,
                    "subset": subset,
                    "short_key": pair_id,
                    "long_key": pair_id,
                    "short_exposure": 0.1,
                    "long_exposure": 0.1 * ratio,
                    "exposure_ratio": ratio,
                })
        paths[f"{subset}_short"] = short_path
        paths[f"{subset}_long"] = long_path
    manifest_path = os.path.join(root, "manifest_sid_synth.json")
    with open(manifest_path, "w") as f:
        json.dump(records, f, indent=1)
    paths["manifest"] = manifest_path
    return paths


def _write_filtered_png(path: str, arr: np.ndarray) -> None:
    """``arr`` as a PNG whose rows cycle through filter types 0-4."""
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(imgio.encode_png(arr, filter_types=range(5)))


def make_synthetic_stereo(
    root: str,
    n_train: int = 16,
    n_val: int = 2,
    train_hw: Tuple[int, int] = (96, 200),
    val_hw: Tuple[int, int] = (96, 192),
    seed: int = 0,
) -> Dict[str, str]:
    """A synthetic stereo SR set in the Flickr1024 layout that
    ``configs/stereo_nafssr.yml`` reads (``STEREO_ROOT=root``)::

        root/{train,val}/hr/<sample>/{hr0,hr1}.png
        root/{train,val}/lr_x2/<sample>/{lr0,lr1}.png

    Each sample is one natural-image-like scene (:func:`_natural_image`)
    seen by two cameras: the right view is the left one shifted by a
    disparity of 4-24 pixels. LR is the 2x2 mean of HR, so HR = 2 x LR.
    All files are seeded uint8 RGB PNGs whose scanlines cycle through the
    five PNG filter types (None, Sub, Up, Average, Paeth), as encoders of
    real photographs mix them (PIL and libpng write mostly Paeth rows), so
    reading the set costs what decoding real views costs; the pixels are
    those of unfiltered files. Sample ``i`` of a subset is
    ``8 (i % 4)`` pixels taller and ``16 (i % 4)`` wider than its ``*_hw``,
    so the validation images differ in size. The default 16 training
    samples fill one batch of the config (``batch_size_per_gpu: 16``, the
    last partial batch dropped).

    Returns ``{'root', 'train_hr', 'train_lr', 'val_hr', 'val_lr'}``."""
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    rng = np.random.default_rng(seed)
    paths: Dict[str, str] = {"root": root}
    for subset, n, (h0, w0) in (("train", n_train, train_hw),
                                ("val", n_val, val_hw)):
        hr_dir = os.path.join(root, subset, "hr")
        lr_dir = os.path.join(root, subset, "lr_x2")
        for i in range(n):
            h, w = h0 + 8 * (i % 4), w0 + 16 * (i % 4)
            disp = int(rng.integers(4, 25))
            scene = _natural_image(rng, max(h, w + disp))[:h]
            views = (scene[:, disp:disp + w], scene[:, :w])
            name = f"{i + 1:04d}"
            for k, hr in enumerate(views):
                hr8 = imgio.to_uint8(hr)
                lr = hr8.astype(np.float32).reshape(
                    h // 2, 2, w // 2, 2, 3).mean((1, 3))
                lr8 = np.clip(lr + 0.5, 0, 255).astype(np.uint8)
                _write_filtered_png(
                    os.path.join(hr_dir, name, f"hr{k}.png"), hr8)
                _write_filtered_png(
                    os.path.join(lr_dir, name, f"lr{k}.png"), lr8)
        paths[f"{subset}_hr"], paths[f"{subset}_lr"] = hr_dir, lr_dir
    return paths


def make_synthetic_sid_tree(root: str, n_train: int = 4, n_val: int = 2,
                            size: int = 512, seed: int = 0) -> str:
    """:func:`make_synthetic_sid` laid out as the SID configs'
    ``${SID_ROOT}`` (``SID_assets/manifest_sid.json``,
    ``SID_pack/{train,val}_{short,long}.pack``); returns ``root``."""
    gen = os.path.join(root, "generated")
    paths = make_synthetic_sid(gen, n_train=n_train, n_val=n_val, size=size,
                               seed=seed)
    os.makedirs(os.path.join(root, "SID_assets"), exist_ok=True)
    os.makedirs(os.path.join(root, "SID_pack"), exist_ok=True)
    os.replace(paths.pop("manifest"),
               os.path.join(root, "SID_assets", "manifest_sid.json"))
    for name, path in paths.items():
        os.replace(path, os.path.join(root, "SID_pack", f"{name}.pack"))
    os.rmdir(gen)
    return root
