"""Dataset sanity harness (counterpart of ``tools/debug_dataset.py``):
manifest, exposure-ratio and pack checks, one item and one batch. Point it
at a manifest and packs, or run ``--synthetic`` to generate and check the
debug fixture set::

    python -m lowlight_image_enhancement_tpu_torch.tools.debug_dataset \
        --manifest m.json --short-pack train_short.pack \
        --long-pack train_long.pack [--subset train]
    python -m lowlight_image_enhancement_tpu_torch.tools.debug_dataset --synthetic

Host only: it reads and decodes, and runs nothing on a device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Any, Dict

import numpy as np

from lowlight_image_enhancement_tpu_torch.data import (
    Loader,
    SidPackReader,
    SonySIDDataset,
    make_debug_sid,
)


def check(manifest_path: str, short_pack: str, long_pack: str,
          subset: str) -> Dict[str, Any]:
    with open(manifest_path) as f:
        records = json.load(f)
    if isinstance(records, dict):
        records = records["pairs"]
    print(f"manifest: {len(records)} records, "
          f"subsets={sorted({r['subset'] for r in records})}")
    ratios = [r["exposure_ratio"] for r in records]
    print(f"exposure ratios: min={min(ratios):.1f} max={max(ratios):.1f}")

    with SidPackReader(short_pack) as rs, SidPackReader(long_pack) as rl:
        print(f"short pack: {len(rs)} keys; long pack: {len(rl)} keys")
        missing_s = [r["short_key"] for r in records
                     if r["subset"] == subset and r["short_key"] not in rs]
        missing_l = [r["long_key"] for r in records
                     if r["subset"] == subset and r["long_key"] not in rl]
        if missing_s or missing_l:
            print(f"MISSING: {len(missing_s)} shorts, {len(missing_l)} longs")
        else:
            print("all manifest keys present in packs")

    ds = SonySIDDataset(
        manifest_path=manifest_path, subset=subset, phase="train",
        patch_size=32,
        io_backend={"type": "pack", "short_path": short_pack,
                    "long_path": long_pack},
    )
    item = ds[0]
    print(f"item: lq{item['lq'].shape} gt{item['gt'].shape} "
          f"ratio={float(item['expo_ratio']):.1f} "
          f"lq range [{item['lq'].min():.3f}, {item['lq'].max():.3f}]")
    aligned_err = float(np.mean(np.abs(
        item["lq"] - np.clip(item["short_raw"] * float(item["expo_ratio"]),
                             0, 1))))
    print(f"lq == clip(short*ratio): err={aligned_err:.2e} "
          f"({'OK' if aligned_err < 1e-6 else 'FAIL'})")

    loader = Loader(ds, batch_size=2, shuffle=True)
    batch = next(iter(loader))
    print(f"batch: lq{batch['lq'].shape} expo{batch['expo_ratio'].shape} OK")
    return {"records": len(records), "ratios": [min(ratios), max(ratios)],
            "missing_short": missing_s, "missing_long": missing_l,
            "item_lq_shape": list(item["lq"].shape),
            "aligned_err": aligned_err,
            "batch_lq_shape": list(batch["lq"].shape)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest")
    ap.add_argument("--short-pack")
    ap.add_argument("--long-pack")
    ap.add_argument("--subset", default="train")
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    if args.synthetic:
        with tempfile.TemporaryDirectory() as root:
            paths = make_debug_sid(root, n_pairs=3)
            return check(paths["manifest"], paths["train_short"],
                         paths["train_long"], "train")
    if not (args.manifest and args.short_pack and args.long_pack):
        raise SystemExit("provide --manifest/--short-pack/--long-pack "
                         "or --synthetic")
    return check(args.manifest, args.short_pack, args.long_pack, args.subset)


if __name__ == "__main__":
    main()
