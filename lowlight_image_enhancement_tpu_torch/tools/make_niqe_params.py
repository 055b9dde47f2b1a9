"""Fit NIQE pristine-model parameters from a folder of pristine images
(counterpart of ``tools/make_niqe_params.py``, on the port's
``metrics/niqe.py``).

The reference ships ``niqe_pris_params.npz`` (mu/cov of NIQE features over
a pristine-image corpus). This tool rebuilds such a model from any corpus
so the NIQE metric is fully usable without the reference's data file::

    python -m lowlight_image_enhancement_tpu_torch.tools.make_niqe_params \
        --images /path/to/pristine --output niqe_pris_params.npz
    python -m lowlight_image_enhancement_tpu_torch.tools.make_niqe_params \
        --synthetic 64 --output niqe_pris_params_synthetic.npz

Then ``export LLIE_NIQE_PARAMS=niqe_pris_params.npz``. Host only (numpy
and scipy).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np

from lowlight_image_enhancement_tpu_torch.metrics.niqe import (
    _mscn,
    compute_niqe_features,
)


def features_of_image(img: np.ndarray, block_size: int = 96) -> np.ndarray:
    """[n_blocks, 36] two-scale NIQE features of one grayscale image."""
    if img.ndim == 3:
        img = np.dot(img[..., :3], [0.299, 0.587, 0.114])
    img = img.astype(np.float64)
    if img.max() <= 2.0:
        img = img * 255.0
    h, w = img.shape
    nb_h, nb_w = h // block_size, w // block_size
    if nb_h == 0 or nb_w == 0:
        raise ValueError(f"image {img.shape} smaller than one block")
    img = img[: nb_h * block_size, : nb_w * block_size]

    feats_scales = []
    for scale in (1, 2):
        mscn = _mscn(img)
        bs = block_size // scale
        feats = [
            compute_niqe_features(
                mscn[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs]
            )
            for i in range(nb_h)
            for j in range(nb_w)
        ]
        feats_scales.append(np.stack(feats))
        if scale == 1:
            img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                          + img[0::2, 1::2] + img[1::2, 1::2])
    return np.concatenate(feats_scales, axis=1)


def fit_pristine_model(feature_blocks: np.ndarray):
    """-> (mu [36], cov [36,36]) over all pristine blocks."""
    valid = feature_blocks[~np.isnan(feature_blocks).any(axis=1)]
    mu = valid.mean(axis=0)
    cov = np.cov(valid, rowvar=False)
    return mu, cov


def synthetic_pristine_image(rng: np.ndarray, size: int = 384) -> np.ndarray:
    """One procedural 'pristine' grayscale image with natural-image-like
    1/f statistics: multi-octave Gaussian-filtered noise composited with
    a few sharp structural edges, normalized to [0, 255].

    This is the documented corpus behind the BUNDLED
    ``niqe_pris_params_synthetic.npz``: deterministic (seeded),
    reproducible with ``--synthetic N``, and sharp/noise-free in the NIQE
    sense. The fitted mu/cov will NOT numerically match the reference's
    MATLAB-fit ``niqe_pris_params.npz`` (different corpus); NIQE values
    are comparable only within one pristine model.
    """
    from scipy.ndimage import gaussian_filter

    img = np.zeros((size, size), np.float64)
    # 1/f octaves: sigma doubles, amplitude halves
    for octave in range(5):
        sigma = 2.0 ** (octave + 1)
        img += gaussian_filter(rng.standard_normal((size, size)),
                               sigma) * (2.0 ** octave)
    # structural edges: a few random smooth step functions
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    for _ in range(4):
        a, b, c = rng.uniform(-2, 2, 3)
        step = np.tanh(12.0 * (a * xx + b * yy + c))
        img += rng.uniform(0.5, 1.5) * step * img.std()
    img -= img.min()
    img /= max(img.max(), 1e-9)
    # mild gamma diversity
    img = img ** rng.uniform(0.7, 1.4)
    return img * 255.0


def make_synthetic_params(n_images: int = 64, size: int = 384,
                          block_size: int = 96, seed: int = 0):
    """Fit the pristine model on the procedural corpus. Returns (mu, cov)."""
    rng = np.random.default_rng(seed)
    all_feats = [
        features_of_image(synthetic_pristine_image(rng, size), block_size)
        for _ in range(n_images)
    ]
    return fit_pristine_model(np.concatenate(all_feats, axis=0))


def collect_bundled_photos(min_bytes: int = 30000):
    """Paths of real photographic images shipped inside installed
    packages (no egress needed): material/texture photographs from
    dm_control / gymnasium-robotics simulation assets plus matplotlib's
    ``grace_hopper.jpg`` sample photo. These are genuine camera captures,
    though material close-ups, not the MATLAB corpus' natural scenes:
    values still aren't comparable to MATLAB-fit NIQE."""
    import glob
    import site

    roots = site.getsitepackages() + [os.path.dirname(np.__file__) + "/.."]
    pats = [
        "dm_control/**/assets/**/*.png",
        "dm_control/suite/**/*.png",
        "gymnasium_robotics/envs/assets/**/textures/**/*.png",
        "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    ]
    skip = ("skybox", "logo", "icon", "all_domains")  # non-photographic
    found = []
    for root in dict.fromkeys(os.path.realpath(r) for r in roots):
        for pat in pats:
            found += glob.glob(os.path.join(root, pat), recursive=True)
    out = []
    for p in sorted(dict.fromkeys(found)):
        base = os.path.basename(p).lower()
        if any(s in base for s in skip):
            continue
        try:
            if os.path.getsize(p) >= min_bytes:
                out.append(p)
        except OSError:
            continue
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", default=None,
                    help="folder of pristine images; omit with --synthetic")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="fit on N procedural pristine images instead of "
                         "a folder (documented, seeded corpus)")
    ap.add_argument("--bundled-photos", action="store_true",
                    help="fit on the real photographic images bundled in "
                         "installed packages (see collect_bundled_photos)")
    ap.add_argument("--output", default="niqe_pris_params.npz")
    ap.add_argument("--block-size", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.synthetic:
        mu, cov = make_synthetic_params(args.synthetic,
                                        block_size=args.block_size,
                                        seed=args.seed)
        np.savez(args.output, mu_pris_param=mu, cov_pris_param=cov,
                 corpus=f"synthetic_v1:n={args.synthetic}:seed={args.seed}")
        print(f"fit pristine model from {args.synthetic} synthetic images "
              f"-> {args.output}")
        return {"output": args.output, "images": args.synthetic,
                "mu": mu, "cov": cov}

    from lowlight_image_enhancement_tpu_torch.utils import imgio

    def _read_gray(path):
        try:
            img = imgio.imread(path)
        except (OSError, ValueError):
            return None
        if img.dtype == np.uint16:
            img = (img / 257.0).round().astype(np.uint8)
        if img.ndim == 3:  # BT.601 luma, like cv2.IMREAD_GRAYSCALE
            img = np.round(img[..., :3].astype(np.float64)
                           @ [0.299, 0.587, 0.114]).astype(np.uint8)
        return img

    if args.bundled_photos:
        paths = collect_bundled_photos()
        if not paths:
            raise SystemExit("no bundled photographic images found")
        corpus = f"bundled_photographic_v1:n={len(paths)}"
    elif args.images:
        paths = [os.path.join(args.images, n)
                 for n in sorted(os.listdir(args.images))]
        corpus = f"folder:{os.path.basename(args.images)}"
    else:
        raise SystemExit(
            "provide --images DIR, --bundled-photos, or --synthetic N")
    all_feats = []
    for path in paths:
        img = _read_gray(path)
        if img is None:
            continue
        try:
            all_feats.append(features_of_image(img, args.block_size))
        except ValueError:
            print(f"skip {os.path.basename(path)}: too small")
    if not all_feats:
        raise SystemExit("no usable images")
    mu, cov = fit_pristine_model(np.concatenate(all_feats, axis=0))
    np.savez(args.output, mu_pris_param=mu, cov_pris_param=cov,
             corpus=corpus)
    blocks = sum(len(f) for f in all_feats)
    print(f"fit pristine model from {len(all_feats)} images "
          f"({blocks} blocks) -> {args.output}")
    return {"output": args.output, "images": len(all_feats),
            "blocks": blocks, "mu": mu, "cov": cov}


if __name__ == "__main__":
    main()
