"""Standalone evaluation CLI: the full metric suite over a val/test split
and a JSON report (counterpart of ``tools/evaluate.py``)::

    # a trained checkpoint on the config's val set, on the card
    python -m lowlight_image_enhancement_tpu_torch.tools.evaluate \
        -opt configs/sid_newbp_mono.yml \
        --checkpoint experiments/SID_NewBP_Mono/models/net_g_latest.pth \
        --output report.json

    # identity-model sanity pass over the debug set, on the CPU
    python -m lowlight_image_enhancement_tpu_torch.tools.evaluate \
        -opt configs/debug/sid_newbp_mono_debug.yml --identity --device cpu

``--checkpoint`` (default: the config's ``path.pretrain_network_g``) is a
port checkpoint (``net_g_*.pth`` or a training state ``<step>.pth``), a
``.pth`` state_dict or a ``.npz`` of JAX params, read by
``demo.load_weights``; an orbax directory raises there.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.data import (
    create_dataset,
    create_loader,
)
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.metrics.evaluation import (
    compute_metrics,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    build_psf_kernels,
    normalize_psf_energy,
)
from lowlight_image_enhancement_tpu_torch.tools.common import add_device_arg
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)


def physics_kernel(opt: Dict[str, Any]):
    """The energy-normalised raw PSF of ``train.hybrid_opt.physics``, for
    the consistency MAE; None without a physics block."""
    physics = (((opt.get("train") or {}).get("hybrid_opt") or {})
               .get("physics"))
    if not physics:
        return None
    mode = physics.get("mode", "mono")
    return normalize_psf_energy(build_psf_kernels(
        mode, physics.get("kernel_spec", "P2" if mode == "mono" else "B2")))


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="weights (.pth or .npz); default: config "
                         "path.pretrain_network_g")
    ap.add_argument("--split", default="val",
                    help="datasets.<split> block to evaluate")
    ap.add_argument("--output", default=None, help="JSON report path")
    ap.add_argument("--identity", action="store_true",
                    help="evaluate the identity model (pipeline sanity)")
    ap.add_argument("--lpips-net", default="vgg")
    ap.add_argument("--no-lpips", action="store_true")
    ap.add_argument("--max-batches", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    opt = parse(args.opt, is_train=False)
    ds_opt = (opt.get("datasets") or {}).get(args.split)
    if ds_opt is None:
        raise SystemExit(f"config has no datasets.{args.split}")
    ds = create_dataset(ds_opt)
    loader = create_loader(ds, {**ds_opt, "phase": "val"})

    if args.identity:
        forward = lambda x: x  # noqa: E731
        model_desc = "identity"
    else:
        net = define_network(dict(opt["network_g"]), device=dev)
        checkpoint = args.checkpoint or (opt.get("path") or {}).get(
            "pretrain_network_g")
        if checkpoint:
            load_weights(net, checkpoint)
        forward = make_eval_step(net)
        model_desc = f"{opt['network_g'].get('type')} @ {checkpoint}"

    psf = physics_kernel(opt)
    results = compute_metrics(
        forward, loader,
        psf_kernel=None if psf is None else psf.to(dev),
        use_lpips=not args.no_lpips,
        lpips_net=args.lpips_net,
        max_batches=args.max_batches,
        device=dev,
    )
    report = {
        "model": model_desc,
        "split": args.split,
        "dataset": ds_opt.get("name", args.split),
        "num_items": len(ds),
        "metrics": results,
    }
    text = json.dumps(report, indent=1)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()
