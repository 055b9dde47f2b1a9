"""Convert SID Sony ``.ARW`` RAW captures to 16-bit PNGs (counterpart of
``tools/convert_sid_raw_to_png.py``; reference
``NAFNet_base/tools/convert_sid_raw_to_png.py``)::

    python -m lowlight_image_enhancement_tpu_torch.tools.convert_sid_raw_to_png \
        --input <Sony/ with short/ long/> --output <PNG root>

RAW decoding stays an offline host step: ``rawpy`` postprocess with the
camera white balance, no auto-brightening, 16-bit output, written by the
port's ``utils.imgio``. ``rawpy`` is not bundled: the tool gates on it
and is meant for a data-prep host that has it.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

from lowlight_image_enhancement_tpu_torch.utils import imgio


def main(argv=None) -> Dict[str, int]:
    try:
        import rawpy
    except ImportError:
        raise SystemExit(
            "rawpy is required for RAW conversion; run this tool on a "
            "data-prep host with `rawpy` installed."
        )

    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="Sony/ directory containing short/ and long/ .ARW")
    ap.add_argument("--output", required=True, help="PNG output root")
    args = ap.parse_args(argv)

    converted = {}
    for split in ("short", "long"):
        in_dir = os.path.join(args.input, split)
        out_dir = os.path.join(args.output, split)
        os.makedirs(out_dir, exist_ok=True)
        names = sorted(n for n in os.listdir(in_dir)
                       if n.lower().endswith(".arw"))
        for i, name in enumerate(names):
            with rawpy.imread(os.path.join(in_dir, name)) as raw:
                rgb = raw.postprocess(
                    use_camera_wb=True,
                    no_auto_bright=True,
                    output_bps=16,
                )
            out_path = os.path.join(out_dir,
                                    os.path.splitext(name)[0] + ".png")
            imgio.imwrite(out_path, rgb)  # 16-bit PNG, RGB
            if (i + 1) % 50 == 0:
                print(f"{split}: {i + 1}/{len(names)}")
        print(f"{split}: converted {len(names)} files -> {out_dir}")
        converted[split] = len(names)
    return converted


if __name__ == "__main__":
    main()
