#!/usr/bin/env python
"""Training-trajectory parity A/B: the PyTorch port against the JAX package.

``tools/parity_train_ab.py`` holds the JAX package's training loop against
the reference's torch code. This tool holds the port's loop against the
JAX package's on the same protocols: N steps of the port's
``make_train_step`` and of the JAX ``make_train_step``, from one shared
initialisation and on the same batch, both in fp32 on the CPU.

- The init: the JAX ``NAFNet``'s parameters, every leaf redrawn from
  N(0, 0.05) with a numpy seed (the reference side's init in
  ``parity_train_ab.py``), bridged into the port's ``NAFNet`` by
  ``weights.params_from_jax``.
- The objective, as in ``parity_train_ab.py``: ``v1`` is L1(raw) + 0.1 *
  the sRGB physics term (mono P2 PSF); ``v3`` adds 0.02 * perceptual (one
  random VGG19 trunk, the JAX ``PerceptualLoss``'s, bridged by
  ``vgg_params_from_jax``), 0.02 * DeltaE00 and 0.05 * SSIM.
- The optimizer: AdamW lr 5e-4, wd 0.01, global-norm clip 0.01 (both
  packages' ``make_optimizer`` defaults).

It reports the per-step losses, the largest relative loss difference, the
final largest parameter difference (the JAX parameters bridged into the
port's names), and PSNR/SSIM of both trained networks on a held-out
batch, both computed by the JAX package's ``calculate_psnr_img`` /
``calculate_ssim_img`` on 8-bit outputs, as ``parity_train_ab.py`` does.

Usage::

    python tools/parity_port_ab.py --protocol v1   # -> parity_port_ab.json
    python tools/parity_port_ab.py --protocol v3   # -> parity_port_ab_v3.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

LR, WD, CLIP, W_PHYS, W_PERC, RHO = 5e-4, 0.01, 0.01, 0.10, 0.02, 5.0
W_DELTAE, W_SSIM = 0.02, 0.05
GEOMETRY = dict(img_channel=3, width=8, middle_blk_num=2,
                enc_blk_nums=(1, 2), dec_blk_nums=(1, 1))
# the protocols of parity_train_ab.json and parity_train_ab_v3.json
PROTOCOLS = {
    "v1": dict(steps=12, side=32, width=8, full=False,
               json="parity_port_ab.json"),
    "v3": dict(steps=300, side=128, width=16, full=True,
               json="parity_port_ab_v3.json"),
}
INIT_SEED = 0


def make_batch(side: int, n: int = 2, seed: int = 7):
    """The NHWC numpy batch of ``parity_train_ab.make_batch``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    short_raw = rng.uniform(0, 0.18, (n, side, side, 3)).astype(np.float32)
    lq = np.clip(short_raw * RHO, 0, 1).astype(np.float32)
    gt = np.clip(lq + rng.uniform(-0.05, 0.08, lq.shape), 0, 1).astype(
        np.float32)
    return {"lq": lq, "gt": gt, "short_raw": short_raw, "long_raw": gt,
            "short_obs": short_raw}


def shared_init(geometry, side: int):
    """The JAX NAFNet's parameter tree with every leaf drawn from
    N(0, 0.05) (numpy leaves)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lowlight_image_enhancement_tpu.models import NAFNet

    net = NAFNet(**geometry)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, side, side, 3)))["params"]
    rng = np.random.default_rng(INIT_SEED)
    return net, jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.05).astype(
            np.float32), params)


def run_jax(net, params, steps: int, side: int, full: bool, jperc):
    """The JAX package's trajectory: (losses, final params, val output)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lowlight_image_enhancement_tpu.losses import HybridLossPlus
    from lowlight_image_enhancement_tpu.ops.psf import create_crosstalk_psf
    from lowlight_image_enhancement_tpu.training.train_step import (
        TrainState, make_optimizer, make_train_step)

    loss = HybridLossPlus(
        use_perc=full, w_perc=W_PERC, perceptual=jperc,
        use_deltaE=full, w_deltaE=W_DELTAE, use_ssim=full, w_ssim=W_SSIM,
        use_phys=True, w_phys=W_PHYS,
        physics_psf_module=create_crosstalk_psf("mono", "P2"))
    tx = make_optimizer(LR)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    trainable = {"params": params, "log_sigma": {}}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(trainable), log_sigma={})
    step = make_train_step(net, loss, tx, donate=False)
    b = make_batch(side)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    batch["expo_ratio"] = jnp.full((b["lq"].shape[0],), RHO, jnp.float32)
    losses = []
    for _ in range(steps):
        state, logs = step(state, batch)
        losses.append(float(logs["l_total"]))
    vb = make_batch(side, seed=1234)
    out = jax.jit(lambda p, x: net.apply({"params": p}, x))(
        state.params, jnp.asarray(vb["lq"]))
    return (losses, jax.tree_util.tree_map(np.asarray, state.params),
            np.clip(np.asarray(out), 0.0, 1.0))


def run_port(params, geometry, steps: int, side: int, full: bool, jperc):
    """The port's trajectory from the same init: (losses, final
    state_dict, val output NHWC)."""
    import jax
    import numpy as np
    import torch

    from lowlight_image_enhancement_tpu_torch.losses.components import (
        PerceptualLoss)
    from lowlight_image_enhancement_tpu_torch.losses.hybrid import (
        HybridLossPlus)
    from lowlight_image_enhancement_tpu_torch.models import NAFNet
    from lowlight_image_enhancement_tpu_torch.ops.psf import (
        create_crosstalk_psf)
    from lowlight_image_enhancement_tpu_torch.training.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from lowlight_image_enhancement_tpu_torch.weights import (
        params_from_jax, vgg_params_from_jax)

    net = NAFNet(**geometry)
    net.load_state_dict(params_from_jax(params, model=net))
    perc = None
    if full:
        perc = PerceptualLoss(dtype=torch.float32)
        perc.vgg.load_state_dict(vgg_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jperc.variables["params"])))
    loss = HybridLossPlus(
        use_perc=full, w_perc=W_PERC, perceptual=perc,
        use_deltaE=full, w_deltaE=W_DELTAE, use_ssim=full, w_ssim=W_SSIM,
        use_phys=True, w_phys=W_PHYS,
        physics_psf_module=create_crosstalk_psf("mono", "P2"))
    opt = make_optimizer(LR)
    state = create_train_state(net, opt, loss)
    step = make_train_step(net, loss, opt)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2))))
    b = make_batch(side)
    batch = {k: nchw(v) for k, v in b.items()}
    batch["expo_ratio"] = torch.full((b["lq"].shape[0],), RHO)
    losses = []
    for _ in range(steps):
        state, logs = step(state, batch)
        losses.append(float(logs["l_total"]))
    vb = make_batch(side, seed=1234)
    net.eval()
    with torch.no_grad():
        out = net(nchw(vb["lq"])).clamp(0, 1).permute(0, 2, 3, 1).numpy()
    return (losses, {k: v.detach().numpy() for k, v in
                     net.state_dict().items()}, out, vb["gt"])


def val_metrics(out, gt):
    """PSNR / SSIM of 8-bit outputs, by the JAX package's functions."""
    import numpy as np

    from lowlight_image_enhancement_tpu.metrics.psnr_ssim_img import (
        calculate_psnr_img, calculate_ssim_img)

    o8 = (np.clip(out, 0, 1) * 255.0).round().astype(np.uint8)
    g8 = (np.clip(gt, 0, 1) * 255.0).round().astype(np.uint8)
    psnr = float(np.mean([calculate_psnr_img(o, g, crop_border=0)
                          for o, g in zip(o8, g8)]))
    ssim = float(np.mean([calculate_ssim_img(o, g, crop_border=0)
                          for o, g in zip(o8, g8)]))
    return psnr, ssim


def run_parity(steps: int, side: int, width: int, full: bool) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from lowlight_image_enhancement_tpu.losses.components import (
        PerceptualLoss as JaxPerceptualLoss)
    from lowlight_image_enhancement_tpu_torch.models import NAFNet
    from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

    geometry = dict(GEOMETRY, width=width)
    jperc = JaxPerceptualLoss(dtype=jnp.float32) if full else None
    jnet, params = shared_init(geometry, side)
    t0 = time.perf_counter()
    j_losses, j_params, j_out = run_jax(jnet, params, steps, side, full,
                                        jperc)
    t_jax = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_losses, p_sd, p_out, gt = run_port(params, geometry, steps, side,
                                         full, jperc)
    t_port = time.perf_counter() - t0

    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(p_losses,
                                                           j_losses)]
    j_sd = params_from_jax(j_params, model=NAFNet(**geometry))
    worst, worst_key = 0.0, None
    for k, v in p_sd.items():
        d = float(np.max(np.abs(v - j_sd[k].numpy())))
        if d > worst:
            worst, worst_key = d, k
    p_psnr, p_ssim = val_metrics(p_out, gt)
    j_psnr, j_ssim = val_metrics(j_out, gt)
    objective = f"l1_raw + {W_PHYS}*phys_srgb(mono P2)"
    if full:
        objective += (f" + {W_PERC}*perceptual(one random VGG19 trunk, the "
                      f"JAX PerceptualLoss's, bridged) + {W_DELTAE}*deltaE00"
                      f" + {W_SSIM}*ssim")
    return {
        "protocol": {"steps": steps, "side": side, "geometry": geometry,
                     "objective": objective,
                     "optimizer": f"AdamW lr={LR} wd={WD} clip={CLIP}",
                     "init": f"JAX NAFNet params redrawn from N(0, 0.05), "
                             f"numpy seed {INIT_SEED}, bridged by "
                             "params_from_jax",
                     "dtype": "float32 (CPU, both sides)"},
        "loss_port": p_losses[:20] + (["..."] if steps > 20 else []),
        "loss_jax": j_losses[:20] + (["..."] if steps > 20 else []),
        "loss_port_final": p_losses[-1],
        "loss_jax_final": j_losses[-1],
        "max_rel_loss_diff": max(rel),
        "final_rel_loss_diff": rel[-1],
        "final_param_max_abs_diff": worst,
        "final_param_worst_leaf": worst_key,
        "val_psnr_port": p_psnr, "val_psnr_jax": j_psnr,
        "val_psnr_abs_diff": abs(p_psnr - j_psnr),
        "val_ssim_port": p_ssim, "val_ssim_jax": j_ssim,
        "val_ssim_abs_diff": abs(p_ssim - j_ssim),
        # the JAX-against-reference records this protocol is held to
        # (parity_train_ab.json, parity_train_ab_v3.json)
        "bar": ({"val_psnr_abs_diff": 0.004, "val_ssim_abs_diff": 1.1e-5}
                if full else {"max_rel_loss_diff": 3.65e-6,
                              "final_param_max_abs_diff": 1.8e-7}),
        "port_loss_decreased": p_losses[-1] < p_losses[0],
        "jax_loss_decreased": j_losses[-1] < j_losses[0],
        "seconds": {"jax": t_jax, "port": t_port},
    }


def force_jax_cpu() -> None:
    """Both sides run on the host CPU; a TPU plugin ignores a plain
    ``JAX_PLATFORMS=cpu``, so all three settings are made."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", choices=sorted(PROTOCOLS), default="v1")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the protocol's step count")
    ap.add_argument("--json", default=None,
                    help="output path (default: the protocol's file at the "
                         "repository root)")
    args = ap.parse_args()
    force_jax_cpu()
    proto = PROTOCOLS[args.protocol]
    report = run_parity(args.steps or proto["steps"], proto["side"],
                        proto["width"], proto["full"])
    report["protocol"]["name"] = args.protocol
    out = json.dumps(report, indent=2, default=str)
    print(out)
    path = args.json or os.path.join(ROOT, proto["json"])
    with open(path, "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
