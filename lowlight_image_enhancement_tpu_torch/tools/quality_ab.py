"""Matched-budget quality A/B: NAFNet (``NewBPNAFNet``) against
``NAFNetTPU`` (counterpart of ``tools/quality_ab.py``).

Both architectures train under the same recipe (384^2 crops, AdamW 5e-4
on a cosine schedule, bf16, the hybrid loss L1 + deltaE00 + phys) on the
same synthetic SID set (``make_synthetic_sid``: natural-image longs,
SID-magnitude ratios, signal-dependent short noise) for the same number
of steps; then PSNR / SSIM / LPIPS / deltaE00 / phys-consistency on the
held-out val split. The full protocol, on the card::

    python -m lowlight_image_enhancement_tpu_torch.tools.quality_ab \
        --steps 5000 --out quality_ab_torch.json

A few steps at width 8 on the CPU (the kernels' plain versions)::

    python -m lowlight_image_enhancement_tpu_torch.tools.quality_ab \
        --steps 2 --crop 32 --size 64 --n-train 2 --width 8 --device cpu

The flags, the recipe and the result JSON are the JAX tool's, with these
differences: ``--out`` defaults to ``quality_ab_torch.json`` (the JAX
tool's ``quality_ab.json`` holds its result), ``--width`` (default:
``ARCHS``'s 32) sets both networks' width, and ``--seed`` (default: 7,
``build_opt``'s) the Trainer's ``manual_seed``, which draws the initial
weights and the shuffle, for a second run of the same protocol.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import torch

from lowlight_image_enhancement_tpu_torch.data.debug_fixtures import (
    make_synthetic_sid,
)
from lowlight_image_enhancement_tpu_torch.metrics.phys_consistency import (
    phys_cons_srgb,
)
from lowlight_image_enhancement_tpu_torch.models.lpips import load_lpips
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    build_psf_kernels,
    normalize_psf_energy,
)
from lowlight_image_enhancement_tpu_torch.tools.common import (
    add_device_arg,
    nchw,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer
from lowlight_image_enhancement_tpu_torch.training.validation import (
    compute_metrics,
)

ARCHS = {
    "nafnet_w32": {
        "type": "NewBPNAFNet",
        "in_channels": 3,
        "kernel_type": "panchromatic",
        "kernel_spec": "P2",
        "nafnet_params": {
            "img_channel": 3, "width": 32,
            "enc_blk_nums": [2, 2, 4, 8], "middle_blk_num": 12,
            "dec_blk_nums": [2, 2, 2, 2],
        },
    },
    "nafnet_tpu_w64": {
        "type": "NAFNetTPU",
        "width": 32,
        "enc_blk_nums": [2, 2, 4, 8], "middle_blk_num": 12,
        "dec_blk_nums": [2, 2, 2, 2],
    },
}


def with_width(net_opt: Dict[str, Any], width: int) -> Dict[str, Any]:
    """``net_opt`` with the network's width set to ``width``."""
    net_opt = copy.deepcopy(net_opt)
    (net_opt.get("nafnet_params") or net_opt)["width"] = width
    return net_opt


def build_opt(name, net_opt, data_root, workdir, steps, batch, crop,
              seed=7):
    return {
        "name": f"quality_ab_{name}",
        "model_type": "ImageRestorationModel",
        "is_train": True,
        "manual_seed": seed,
        "datasets": {
            "train": {
                "name": "synth-train", "type": "SonySIDDataset",
                "phase": "train",
                "manifest_path": f"{data_root}/manifest_sid_synth.json",
                "subset": "train", "patch_size": crop,
                "samples_per_pair": 4, "random_crop": True,
                "batch_size_per_gpu": batch,
                "num_worker_per_gpu": 4,
                "io_backend": {
                    "type": "pack",
                    "short_path": f"{data_root}/train_short.pack",
                    "long_path": f"{data_root}/train_long.pack",
                },
            },
            "val": {
                "name": "synth-val", "type": "SonySIDDataset",
                "phase": "val", "subset": "val",
                "manifest_path": f"{data_root}/manifest_sid_synth.json",
                "random_crop": False, "samples_per_pair": 1,
                "patch_size": crop,
                "batch_size_per_gpu": 1,
                "io_backend": {
                    "type": "pack",
                    "short_path": f"{data_root}/val_short.pack",
                    "long_path": f"{data_root}/val_long.pack",
                },
            },
        },
        "network_g": net_opt,
        "path": {
            "models": os.path.join(workdir, name, "models"),
            "training_states": os.path.join(workdir, name, "states"),
            "log": os.path.join(workdir, name, "log"),
            "visualization": os.path.join(workdir, name, "vis"),
        },
        "train": {
            "total_iter": steps,
            "warmup_iter": -1,
            "enable_amp": True,
            "optim_g": {"type": "AdamW", "lr": 5.0e-4,
                        "betas": [0.9, 0.9], "weight_decay": 0.0},
            "scheduler": {"type": "TrueCosineAnnealingLR",
                          "T_max": steps, "eta_min": 1.0e-6},
            "use_grad_clip": True,
            "hybrid_opt": {
                "type": "HybridLossPlus",
                "use_perc": False,
                "use_lpips": False,
                "use_deltaE": True, "use_ssim": False, "use_phys": True,
                "w_l1_raw": 1.0, "w_deltaE": 0.02, "w_phys": 0.10,
                "physics": {"mode": "mono", "kernel_spec": "P2"},
            },
        },
        "logger": {"print_freq": max(steps // 10, 1),
                   "save_checkpoint_freq": steps},
        "val": {
            "val_freq": 0,
            "metrics": {
                "psnr": {"type": "linear_psnr", "data_range": 1.0},
                "ssim": {"type": "linear_ssim", "data_range": 1.0},
                "deltae": {"type": "deltae2000_mean"},
            },
        },
    }


def evaluate_full(trainer, opt) -> Dict[str, Any]:
    """The val metrics, LPIPS-alex (a seeded random trunk unless
    ``$LLIE_LPIPS_NPZ`` names converted weights: comparable across the
    archs, not with published values; ``lpips_pretrained`` says which)
    and the sRGB phys-consistency, which needs the short observation,
    means over the val loader."""
    dev = trainer.device
    lpips_mod, lpips_pretrained = load_lpips(net="alex")
    lpips_mod = lpips_mod.to(dev).eval()
    kernel = normalize_psf_energy(build_psf_kernels("mono", "P2")).to(dev)
    metrics_opt = opt["val"]["metrics"]
    sums: Dict[str, float] = {}
    n = 0
    for batch in trainer.val_loader:
        b = nchw(batch, dev)
        sr = trainer.eval_fn(b["lq"]).float()
        gt = b["gt"]
        per = compute_metrics(sr, gt, metrics_opt)
        with torch.no_grad():
            per["lpips"] = float(torch.mean(lpips_mod(
                torch.clamp(sr, 0, 1) * 2 - 1, gt * 2 - 1)))
        # rho * (K * Bhat) ~ A with rho the short/long exposure quotient:
        # the inverse of the data set's alignment ratio
        rho = 1.0 / b["expo_ratio"].reshape(-1)
        per["phys_mae"] = float(phys_cons_srgb(
            torch.clamp(sr, 0, 1), b["short_obs"], kernel, rho))
        for k, v in per.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    out: Dict[str, Any] = {k: v / n for k, v in sums.items()}
    out["lpips_pretrained"] = bool(lpips_pretrained)
    return out


def _subprocess_env() -> Dict[str, str]:
    """The environment with this package's root on ``PYTHONPATH``."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--crop", type=int, default=384)
    ap.add_argument("--archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--out", default="quality_ab_torch.json")
    ap.add_argument("--width", type=int, default=None,
                    help="both networks' width (default: ARCHS's, 32)")
    ap.add_argument("--seed", type=int, default=7,
                    help="the Trainer's manual_seed (default: 7)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    data_root = args.data_root or os.path.join(
        tempfile.gettempdir(), f"sid_synth_{args.size}_{args.n_train}")
    manifest = os.path.join(data_root, "manifest_sid_synth.json")
    if not os.path.exists(manifest):
        print(f"generating synthetic SID set at {data_root} ...",
              flush=True)
        make_synthetic_sid(data_root, n_train=args.n_train, size=args.size)

    results: Dict[str, Any] = {"protocol": {
        "steps": args.steps, "batch": args.batch, "crop": args.crop,
        "data": f"make_synthetic_sid(n_train={args.n_train}, "
                f"size={args.size}, ratios=100/250/300, seed=0)",
        "recipe": "AdamW 5e-4 cosine->1e-6, bf16, grad-clip, "
                  "hybrid L1+deltaE00+phys (reference "
                  "configs/colab/sid_newbp_mono.yml:65-96)",
    }, "archs": {}}
    if len(args.archs) > 1:
        # one architecture per process, as the JAX tool runs them
        for name in args.archs:
            sub_out = f"{args.out}.{name}.json"
            cmd = [sys.executable, "-m", __spec__.name,
                   "--steps", str(args.steps), "--batch", str(args.batch),
                   "--crop", str(args.crop), "--archs", name,
                   "--data-root", data_root, "--size", str(args.size),
                   "--n-train", str(args.n_train), "--out", sub_out,
                   "--device", args.device, "--seed", str(args.seed)]
            if args.width is not None:
                cmd += ["--width", str(args.width)]
            rc = subprocess.run(cmd, env=_subprocess_env()).returncode
            if rc != 0:
                raise SystemExit(f"{name} sub-run failed rc={rc}")
            with open(sub_out) as f:
                results["archs"][name] = json.load(f)["archs"][name]
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(results))
        return results

    workdir = tempfile.mkdtemp(prefix="quality_ab_")
    for name in args.archs:
        net_opt = ARCHS[name]
        if args.width is not None:
            net_opt = with_width(net_opt, args.width)
        opt = build_opt(name, net_opt, data_root, workdir, args.steps,
                        args.batch, args.crop, seed=args.seed)
        print(f"=== training {name} for {args.steps} steps ===", flush=True)
        t0 = time.time()
        trainer = Trainer(opt, device=args.device)
        trainer.train()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        wall = time.time() - t0
        metrics = evaluate_full(trainer, opt)
        metrics = {k: (float(v) if not isinstance(v, bool) else v)
                   for k, v in metrics.items()}
        results["archs"][name] = {
            "metrics": metrics,
            "wall_s": round(wall, 1),
            "steps_per_sec_wall": round(args.steps / wall, 2),
        }
        print(f"{name}: {json.dumps(results['archs'][name])}", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
