"""Build SIDPack files from a manifest and a PNG tree (counterpart of
``tools/create_sid_pack.py``; the reference's ``create_sid_lmdb.py`` with
LMDB replaced by SIDPack)::

    python -m lowlight_image_enhancement_tpu_torch.tools.create_sid_pack \
        --manifest manifest.json --root <tree with short/ long/> \
        --output <dir> [--subsets train val] [--placeholder-on-corrupt]

Per subset it writes ``{output}/{subset}_short.pack`` and
``{subset}_long.pack`` of the decoded uint16 RGB arrays, each long frame
once. PNG integrity is checked; with ``--placeholder-on-corrupt`` a
corrupt or missing file becomes a seeded random 512x512 placeholder (the
reference's fault-injection hook; the seed is ``hash(key)``, as in the JAX
tool, so it holds within one process). Host only: the packs are the JAX
tool's, byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.records import SidPackWriter
from lowlight_image_enhancement_tpu_torch.data.transforms import (
    decode_png_uint16,
)


def load_png(root: str, which: str, key: str, placeholder: bool,
             shape=(512, 512, 3)) -> np.ndarray:
    path = os.path.join(root, which, f"{key}.png")
    try:
        with open(path, "rb") as f:
            return decode_png_uint16(f.read())
    except (OSError, ValueError) as e:
        if not placeholder:
            raise
        print(f"WARN: {path}: {e} — writing random placeholder")
        rng = np.random.default_rng(abs(hash(key)) % (2**31))
        return rng.integers(0, 65535, shape).astype(np.uint16)


def main(argv=None) -> Dict[str, Dict[str, object]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--root", required=True, help="PNG tree with short/ long/")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--subsets", nargs="*", default=["train", "val"])
    ap.add_argument("--placeholder-on-corrupt", action="store_true")
    ap.add_argument("--comp", default="zlib_band",
                    choices=["zlib_band", "zlib", "none"],
                    help="zlib_band (default): stripe-wise compression so "
                         "crop reads inflate only overlapping stripes")
    args = ap.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)
    records = manifest["pairs"] if isinstance(manifest, dict) else manifest

    os.makedirs(args.output, exist_ok=True)
    written = {}
    for subset in args.subsets:
        subset_records = [r for r in records if r["subset"] == subset]
        if not subset_records:
            print(f"{subset}: no records, skipping")
            continue
        short_path = os.path.join(args.output, f"{subset}_short.pack")
        long_path = os.path.join(args.output, f"{subset}_long.pack")
        seen_long = set()
        with SidPackWriter(short_path, comp=args.comp) as ws, \
                SidPackWriter(long_path, comp=args.comp) as wl:
            for r in subset_records:
                ws.add(r["short_key"],
                       load_png(args.root, "short", r["short_key"],
                                args.placeholder_on_corrupt))
                if r["long_key"] not in seen_long:
                    wl.add(r["long_key"],
                           load_png(args.root, "long", r["long_key"],
                                    args.placeholder_on_corrupt))
                    seen_long.add(r["long_key"])
        print(f"{subset}: {len(subset_records)} shorts, "
              f"{len(seen_long)} longs -> {short_path}, {long_path}")
        written[subset] = {"shorts": len(subset_records),
                           "longs": len(seen_long), "short": short_path,
                           "long": long_path}
    return written


if __name__ == "__main__":
    main()
