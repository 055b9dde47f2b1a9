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

``--probe`` answers a different question: whether the two packages take
the same step from the same state. It runs the JAX trajectory of the
protocol and, at steps 0, 50, 100, 200 and 299 (``--probe-at``), loads
JAX's parameters and AdamW moments into the port, takes one step on both
sides from that state, and reports per leaf the relative difference
``max|port - jax| / max|jax|`` of the gradient and of the update (the
port's update taken in float64 from the fp32 gradient, so that the
rounding of ``p + u`` does not enter it), and each loss term of both
sides.

Usage::

    python tools/parity_port_ab.py --protocol v1   # -> parity_port_ab.json
    python tools/parity_port_ab.py --protocol v3   # -> parity_port_ab_v3.json
    python tools/parity_port_ab.py --protocol v3 --probe
                                        # -> parity_port_ab_v3_probe.json
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


TERMS = ("l1_raw", "perc", "deltaE", "ssim", "phys")


def loss_kwargs(full: bool, only: str = None) -> dict:
    """``HybridLossPlus`` weights and switches of the protocol, or of its
    term ``only`` alone (the same keywords in both packages)."""
    kw = dict(use_perc=full, w_perc=W_PERC, use_deltaE=full,
              w_deltaE=W_DELTAE, use_ssim=full, w_ssim=W_SSIM,
              use_phys=True, w_phys=W_PHYS)
    if only is not None:
        for t in TERMS[1:]:
            kw[f"use_{t}"] = kw[f"use_{t}"] and t == only
        kw["w_l1_raw"] = 1.0 if only == "l1_raw" else 0.0
    return kw


def jax_loss_of(full: bool, jperc, only: str = None):
    from lowlight_image_enhancement_tpu.losses import HybridLossPlus
    from lowlight_image_enhancement_tpu.ops.psf import create_crosstalk_psf

    kw = loss_kwargs(full, only)
    return HybridLossPlus(
        perceptual=jperc if kw["use_perc"] else None,
        physics_psf_module=(create_crosstalk_psf("mono", "P2")
                            if kw["use_phys"] else None), **kw)


def jax_setup(net, params, side: int, full: bool, jperc):
    """The JAX package's loss, optimizer, initial state, step and batch."""
    import jax
    import jax.numpy as jnp

    from lowlight_image_enhancement_tpu.training.train_step import (
        TrainState, make_optimizer, make_train_step)

    loss = jax_loss_of(full, jperc)
    tx = make_optimizer(LR)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    trainable = {"params": params, "log_sigma": {}}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(trainable), log_sigma={})
    step = make_train_step(net, loss, tx, donate=False)
    b = make_batch(side)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    batch["expo_ratio"] = jnp.full((b["lq"].shape[0],), RHO, jnp.float32)
    return loss, tx, state, step, batch


def run_jax(net, params, steps: int, side: int, full: bool, jperc):
    """The JAX package's trajectory: (losses, final params, val output)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    _, _, state, step, batch = jax_setup(net, params, side, full, jperc)
    losses = []
    for _ in range(steps):
        state, logs = step(state, batch)
        losses.append(float(logs["l_total"]))
    vb = make_batch(side, seed=1234)
    out = jax.jit(lambda p, x: net.apply({"params": p}, x))(
        state.params, jnp.asarray(vb["lq"]))
    return (losses, jax.tree_util.tree_map(np.asarray, state.params),
            np.clip(np.asarray(out), 0.0, 1.0))


def port_loss(full: bool, jperc, only: str = None):
    """The port's ``HybridLossPlus`` of the protocol, or of its term
    ``only`` alone (the perceptual trunk bridged from ``jperc``)."""
    import jax
    import numpy as np
    import torch

    from lowlight_image_enhancement_tpu_torch.losses.components import (
        PerceptualLoss)
    from lowlight_image_enhancement_tpu_torch.losses.hybrid import (
        HybridLossPlus)
    from lowlight_image_enhancement_tpu_torch.ops.psf import (
        create_crosstalk_psf)
    from lowlight_image_enhancement_tpu_torch.weights import (
        vgg_params_from_jax)

    kw = loss_kwargs(full, only)
    perc = None
    if kw["use_perc"]:
        perc = PerceptualLoss(dtype=torch.float32)
        perc.vgg.load_state_dict(vgg_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jperc.variables["params"])))
    return HybridLossPlus(
        perceptual=perc, physics_psf_module=(
            create_crosstalk_psf("mono", "P2") if kw["use_phys"] else None),
        **kw)


def run_port(params, geometry, steps: int, side: int, full: bool, jperc):
    """The port's trajectory from the same init: (losses, final
    state_dict, val output NHWC)."""
    import numpy as np
    import torch

    from lowlight_image_enhancement_tpu_torch.models import NAFNet
    from lowlight_image_enhancement_tpu_torch.training.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

    net = NAFNet(**geometry)
    net.load_state_dict(params_from_jax(params, model=net))
    loss = port_loss(full, jperc)
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


PROBE_AT = (0, 50, 100, 200, 299)


def rel_diff(got, want) -> float:
    """``max|got - want| / max|want|`` (float64)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def diff_stats(got, want) -> dict:
    """How two gradients differ: ``max|d| / max|want|``, ``|d|_2 /
    |want|_2`` and the share of elements with ``|d| > 1e-5 max|want|``.
    A switch decided by a rounding (a ReLU at 0, a max-pool argmax, a hue
    branch) moves a region of the gradient; a wrong formula moves all of
    it."""
    import numpy as np

    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want.detach() if hasattr(want, "detach") else want,
                      np.float64)
    d = np.abs(got - want)
    top = max(np.abs(want).max(), 1e-30)
    return {"max_rel": float(d.max() / top),
            "l2_rel": float(np.linalg.norm(d) / max(np.linalg.norm(want),
                                                    1e-30)),
            "share_over_1e-5": float(np.mean(d > 1e-5 * top))}


def run_probe(points, side: int, width: int, full: bool) -> dict:
    """JAX's trajectory, and at each step of ``points`` one step of both
    packages from JAX's state there (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from lowlight_image_enhancement_tpu.losses.components import (
        PerceptualLoss as JaxPerceptualLoss)
    from lowlight_image_enhancement_tpu.training.train_step import (
        hybrid_batch_kwargs as jax_batch_kwargs)
    from lowlight_image_enhancement_tpu_torch.models import NAFNet
    from lowlight_image_enhancement_tpu_torch.training.train_step import (
        hybrid_batch_kwargs, make_optimizer)
    from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

    geometry = dict(GEOMETRY, width=width)
    jperc = JaxPerceptualLoss(dtype=jnp.float32) if full else None
    jnet, params = shared_init(geometry, side)
    jloss, tx, state, step, batch = jax_setup(jnet, params, side, full,
                                              jperc)
    t0 = time.perf_counter()
    saved = {}
    for i in range(max(points) + 1):
        if i in points:
            saved[i] = state
        if i < max(points):
            state, _ = step(state, batch)
    t_jax = time.perf_counter() - t0

    def jax_loss(p, b):
        out = jnet.apply({"params": p}, b["lq"], deterministic=False)
        return jloss(**jax_batch_kwargs(out, b))

    # the batch is an argument of every jitted function: as a constant XLA
    # would fold the VGG19 trunk of the perceptual target
    jax_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))

    def out_grad(loss_):
        """``o -> dL/do`` of ``loss_`` at the batch."""
        grad = jax.jit(jax.grad(
            lambda o, b: loss_(**jax_batch_kwargs(o, b))[0]))
        return lambda o: grad(o, batch)

    jax_out_grad = out_grad(jloss)
    terms = [t for t in TERMS if full or t in ("l1_raw", "phys")]
    jax_term_grads = {t: out_grad(jax_loss_of(full, jperc, t))
                      for t in terms}
    port_terms = {t: port_loss(full, jperc, t) for t in terms}

    def jax_split(p):
        """The network's output, dL/d(output) there, and the network's
        VJP of that cotangent."""
        out, vjp = jax.vjp(lambda q: jnet.apply(
            {"params": q}, batch["lq"], deterministic=False), p)
        g_out = jax_out_grad(out)
        return out, g_out, vjp(g_out)[0]

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.array(a), (0, 3, 1, 2))))
    pbatch = {k: nchw(v) for k, v in batch.items() if k != "expo_ratio"}
    pbatch["expo_ratio"] = torch.from_numpy(np.array(batch["expo_ratio"]))
    net = NAFNet(**geometry)
    loss = port_loss(full, jperc)
    names = [k for k, _ in net.named_parameters()]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    report = []
    for k in points:
        st = saved[k]
        (_, jlogs), jg = jax_grad(st.params, batch)
        trainable = {"params": st.params, "log_sigma": {}}
        jupd, _ = tx.update({"params": jg, "log_sigma": {}}, st.opt_state,
                            trainable)
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            st.opt_state, is_leaf=lambda s: isinstance(
                s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        jg_sd = params_from_jax(to_np(jg), model=net)
        ju_sd = params_from_jax(to_np(jupd["params"]), model=net)
        mu_sd = params_from_jax(to_np(adam.mu["params"]), model=net)
        nu_sd = params_from_jax(to_np(adam.nu["params"]), model=net)

        net.load_state_dict(params_from_jax(to_np(st.params), model=net))
        net.train()
        out = net(pbatch["lq"])
        total, logs = loss(**hybrid_batch_kwargs(out, pbatch))
        grads = torch.autograd.grad(total, list(net.parameters()),
                                    retain_graph=True)
        # the gradient split where the loss meets the network: the loss's
        # gradient at JAX's own output, and the network's VJP of JAX's
        # cotangent
        j_out, j_gout, j_vjp = jax_split(st.params)
        o = nchw(j_out).requires_grad_(True)
        (p_gout,) = torch.autograd.grad(
            loss(**hybrid_batch_kwargs(o, pbatch))[0], o)
        by_term = {}
        for t in terms:
            (g_t,) = torch.autograd.grad(
                port_terms[t](**hybrid_batch_kwargs(o, pbatch))[0], o)
            by_term[t] = diff_stats(g_t, nchw(jax_term_grads[t](j_out)))
            if t == "perc":
                # the port's own fp32 rounding band: the same term in fp64
                vgg = port_terms[t].perceptual.vgg
                vgg.dtype = torch.float64
                o64 = o.detach().double().requires_grad_(True)
                (g64,) = torch.autograd.grad(port_terms[t](
                    **hybrid_batch_kwargs(o64, pbatch))[0], o64)
                vgg.dtype = torch.float32
                by_term[t]["port_fp32_vs_port_fp64"] = diff_stats(g_t, g64)
        p_vjp = torch.autograd.grad(out, list(net.parameters()),
                                    grad_outputs=nchw(j_gout))
        j_vjp_sd = params_from_jax(to_np(j_vjp), model=net)
        b_raw = pbatch["long_raw"]
        flips = int(((out.detach() - b_raw).sign()
                     != (nchw(j_out) - b_raw).sign()).sum())
        split = {
            "output_rel": rel_diff(out.detach().numpy(), nchw(j_out)),
            "loss_grad_rel_at_jax_output": rel_diff(p_gout.numpy(),
                                                    nchw(j_gout)),
            "loss_grad_rel_by_term": by_term,
            "vjp_worst_rel_of_jax_cotangent": max(
                rel_diff(g.numpy(), j_vjp_sd[n])
                for n, g in zip(names, p_vjp)),
            "l1_sign_flips": flips, "pixels": int(b_raw.numel()),
        }
        def port_update(grads_):
            """The port optimizer's update in float64 from fp32 ``grads_``
            and JAX's moments."""
            p64 = [p.detach().double().clone() for p in net.parameters()]
            opt = make_optimizer(LR).init(p64)
            opt.count = int(adam.count)
            for m, v, name in zip(opt.mu, opt.nu, names):
                m.copy_(mu_sd[name].double())
                v.copy_(nu_sd[name].double())
            before = [p.clone() for p in p64]
            opt.step([g.detach().float().clone() for g in grads_])
            return [(a - b).numpy() for a, b in zip(p64, before)]

        upd = port_update(grads)
        # the optimizer alone: the port's update from JAX's gradient
        upd_j = port_update([jg_sd[n] for n in names])
        leaves = {}
        for name, g, u, uj in zip(names, grads, upd, upd_j):
            leaves[name] = {
                "grad_rel": rel_diff(g.detach().numpy(), jg_sd[name]),
                "update_rel": rel_diff(u, ju_sd[name]),
                "update_rel_same_grad": rel_diff(uj, ju_sd[name]),
                "grad_max": float(jg_sd[name].abs().max()),
            }
        logged = {t: {"port": float(logs[t]), "jax": float(jlogs[t]),
                      "rel": abs(float(logs[t]) - float(jlogs[t]))
                      / max(abs(float(jlogs[t])), 1e-30)} for t in logs}
        worst_g = max(leaves, key=lambda n: leaves[n]["grad_rel"])
        worst_u = max(leaves, key=lambda n: leaves[n]["update_rel"])
        worst_o = max(leaves[n]["update_rel_same_grad"] for n in leaves)
        report.append({
            "step": k, "terms": logged,
            "worst_grad_leaf": worst_g,
            "worst_grad_rel": leaves[worst_g]["grad_rel"],
            "worst_update_leaf": worst_u,
            "worst_update_rel": leaves[worst_u]["update_rel"],
            "worst_update_rel_same_grad": worst_o, "split": split,
            "leaves": leaves})
        print(f"step {k}: worst grad rel {leaves[worst_g]['grad_rel']:.3e} "
              f"({worst_g}), worst update rel "
              f"{leaves[worst_u]['update_rel']:.3e} ({worst_u}), from JAX's "
              f"gradient {worst_o:.3e}; {split}; terms "
              + ", ".join(f"{t} {v['rel']:.2e}" for t, v in logged.items()),
              flush=True)
    return {"protocol": {"side": side, "geometry": geometry, "full": full,
                         "points": list(points),
                         "measure": "max|port - jax| / max|jax| per leaf",
                         "dtype": "float32 (CPU, both sides); the port's "
                                  "update in float64"},
            "points": report, "seconds": {"jax_trajectory": t_jax}}


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
    ap.add_argument("--probe", action="store_true",
                    help="one step of both packages from JAX's state at "
                         "the --probe-at steps of the protocol")
    ap.add_argument("--probe-at", default=",".join(map(str, PROBE_AT)))
    args = ap.parse_args()
    force_jax_cpu()
    proto = PROTOCOLS[args.protocol]
    if args.probe:
        points = tuple(int(p) for p in args.probe_at.split(","))
        report = run_probe(points, proto["side"], proto["width"],
                           proto["full"])
        default = proto["json"].replace(".json", "_probe.json")
    else:
        report = run_parity(args.steps or proto["steps"], proto["side"],
                            proto["width"], proto["full"])
        default = proto["json"]
    report["protocol"]["name"] = args.protocol
    out = json.dumps(report, indent=2, default=str)
    print(out if not args.probe else "")
    path = args.json or os.path.join(ROOT, default)
    with open(path, "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
