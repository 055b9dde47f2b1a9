"""Training CLI::

    python -m lowlight_image_enhancement_tpu_torch.train -opt <yaml> \
        [--device cuda|cpu]

Counterpart of ``lowlight_image_enhancement_tpu/train.py`` (reference
``basicsr/train.py:36-98``): the same arguments (``--launcher`` and
``--local_rank`` are accepted for config compatibility and ignored; the
port runs one process), plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse

from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    train_from_config,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True, help="Path to YAML config.")
    parser.add_argument("--launcher", default="none",
                        choices=["none", "pytorch", "slurm"],
                        help="accepted for config compatibility; ignored")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    train_from_config(parse(args.opt, is_train=True), device=args.device)


if __name__ == "__main__":
    main()
