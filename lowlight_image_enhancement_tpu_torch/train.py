"""Training CLI::

    python -m lowlight_image_enhancement_tpu_torch.train -opt <yaml> \
        [--launcher none|pytorch|slurm] [--device cuda|cpu]

    torchrun --nproc_per_node=N -m lowlight_image_enhancement_tpu_torch.train \
        -opt <yaml> --launcher pytorch

Counterpart of ``lowlight_image_enhancement_tpu/train.py`` (reference
``basicsr/train.py:36-98``): the same arguments, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels). ``--launcher pytorch`` (torchrun's environment) or ``slurm``
(SLURM's, with ``MASTER_ADDR``/``MASTER_PORT`` set) joins each process to
a ``torch.distributed`` world (``parallel.init_multihost``): one process
per device, ``cuda:LOCAL_RANK`` on NCCL (gloo with ``--device cpu``;
the config's ``dist_params.backend`` overrides it), data-parallel
training with ``batch_size_per_gpu`` items per process. ``none`` runs one
process. ``--local_rank`` is accepted for compatibility (torchrun passes
``LOCAL_RANK`` in the environment).
"""

from __future__ import annotations

import argparse

import torch

from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
    init_multihost,
)
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    train_from_config,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True, help="Path to YAML config.")
    parser.add_argument("--launcher", default="none",
                        choices=["none", "pytorch", "slurm"])
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    opt = parse(args.opt, is_train=True)
    if args.launcher == "none":
        train_from_config(opt, device=args.device)
        return
    init_multihost(backend=(opt.get("dist_params") or {}).get("backend"),
                   device=args.device)
    opt["dist"] = True
    try:
        train_from_config(opt, device=args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
