"""Host input-pipeline rate: items per second for each pack compression
and worker setting (counterpart of ``tools/bench_input_pipeline.py``).
It says whether training is data-bound when set beside the train-step
time of ``tools.profile_train``; ``tools.train_pipeline_e2e`` measures the
two together. A diagnostic, not the benchmark::

    python -m lowlight_image_enhancement_tpu_torch.tools.bench_input_pipeline \
        [--size 512] [--patch 384] [--pairs 6] [--batches 16] \
        [--batch-size 2] [--workers 0 4]

Runs on the host only: ``Loader(num_workers=W)`` fetches items on W
threads (the native pack decode releases the GIL).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, List

from lowlight_image_enhancement_tpu_torch.data import Loader, SonySIDDataset
from lowlight_image_enhancement_tpu_torch.tools.common import synthetic_pack

COMPS = ("none", "zlib", "zlib_band")


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512,
                    help="stored frame size (use 2848 to simulate real SID)")
    ap.add_argument("--patch", type=int, default=384)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--workers", nargs="*", type=int, default=[0, 4])
    args = ap.parse_args(argv)

    rows = []
    with tempfile.TemporaryDirectory() as root:
        print(f"frame {args.size}^2 uint16, patch {args.patch}, "
              f"batch {args.batch_size}")
        for comp in COMPS:
            manifest = synthetic_pack(root, args.pairs, args.size, comp,
                                      prefix=f"{comp}_")
            ds = SonySIDDataset(
                manifest_path=manifest, subset="train", phase="train",
                patch_size=args.patch, samples_per_pair=64,
                io_backend={"type": "pack",
                            "short_path": f"{root}/{comp}_short.pack",
                            "long_path": f"{root}/{comp}_long.pack"},
            )
            for workers in args.workers:
                loader = Loader(ds, batch_size=args.batch_size,
                                shuffle=True, num_workers=workers)
                it = iter(loader)
                next(it)  # warm caches
                t0 = time.perf_counter()
                n = 0
                for _ in it:
                    n += 1
                    if n >= args.batches:
                        break
                dt = (time.perf_counter() - t0) / n
                print(f"  comp={comp:9s} workers={workers}: "
                      f"{dt * 1e3:7.1f} ms/batch "
                      f"({args.batch_size / dt:6.1f} img/s)", flush=True)
                rows.append({"comp": comp, "workers": workers,
                             "ms_per_batch": dt * 1e3,
                             "img_per_s": args.batch_size / dt})
    return rows


if __name__ == "__main__":
    main()
