"""The port's training core held against the JAX package: schedules,
the optimizer chain (clip 0.01 -> AdamW, with optax.MultiSteps), and
three train steps of a small ``NewBPNAFNet`` with the self-contained
flagship loss from the same bridged weights, fp32.

Tolerances: schedules rtol 1e-5, atol 1e-7 of the base lr (JAX computes
in fp32, so a cosine near eta_min carries the base lr's rounding); one optimizer
update rtol 1e-5 / atol 1e-7 (elementwise fp32 arithmetic in another
order); train steps: every loss term rtol 1e-4, first-step gradients
atol 1e-4 * max(1, max|g|) per leaf, parameters after three steps atol
1e-4 (0.1 * lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.losses.components import (
    PerceptualLoss as JaxPerceptualLoss,
)
from lowlight_image_enhancement_tpu.models import (
    define_network as jax_define_network,
)
from lowlight_image_enhancement_tpu.training import schedules as jsched
from lowlight_image_enhancement_tpu.training import train_step as jts
from lowlight_image_enhancement_tpu.training.trainer import (
    build_hybrid_loss as jbuild_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.losses import assert_finite_logs
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.training import schedules
from lowlight_image_enhancement_tpu_torch.training import train_step as ts
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.weights import (
    params_from_jax,
    vgg_params_from_jax,
)

CONFIG = "configs/sid_newbp_mono_selfcontained.yml"

SCHEDULES = [
    ({"type": "TrueCosineAnnealingLR", "T_max": 300000, "eta_min": 1e-6}, -1),
    ({"type": "CosineAnnealingLR", "T_max": 1000}, 100),
    ({"type": "CosineAnnealingRestartLR", "periods": [50, 100],
      "restart_weights": [1.0, 0.5], "eta_min": 1e-7}, -1),
    ({"type": "MultiStepLR", "milestones": [120, 50], "gamma": 0.5}, -1),
    ({"type": "MultiStepRestartLR", "milestones": [30, 130],
      "restarts": [0, 100], "restart_weights": [1.0, 0.5]}, 20),
    ({"type": "LinearLR", "total_iter": 200}, -1),
    ({"type": "VibrateLR", "total_iter": 8000}, -1),
]
STEPS = [0, 1, 7, 49, 50, 51, 99, 100, 149, 150, 199, 200, 250, 4000,
         299999, 300000, 400000]


@pytest.mark.parametrize("opt,warmup", SCHEDULES,
                         ids=[s[0]["type"] + ("+warmup" if s[1] > 0 else "")
                              for s in SCHEDULES])
def test_schedules_match_jax(opt, warmup):
    ours = schedules.make_schedule(opt, 5e-4, warmup)
    ref = jsched.make_schedule(opt, 5e-4, warmup)
    for step in STEPS:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5,
                                   atol=1e-7 * 5e-4, err_msg=f"step {step}")
    with pytest.raises(ValueError):
        schedules.make_schedule({"type": "Nope"}, 1.0)


OPT_CASES = [("AdamW", True, 1), ("AdamW", False, 1), ("AdamW", True, 2),
             ("AdamW", False, 2), ("Adam", True, 1), ("SGD", True, 1)]


@pytest.mark.parametrize("optim_type,clip_triggers,accum", OPT_CASES)
def test_optimizer_matches_optax_chain(optim_type, clip_triggers, accum):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": ()}
    params = {k: np.asarray(rng.normal(size=s), np.float32)
              for k, s in shapes.items()}
    sched = schedules.make_schedule(
        {"type": "TrueCosineAnnealingLR", "T_max": 10, "eta_min": 1e-6}, 0.05)
    jsch = jsched.make_schedule(
        {"type": "TrueCosineAnnealingLR", "T_max": 10, "eta_min": 1e-6}, 0.05)
    kw = dict(optim_type=optim_type, betas=(0.9, 0.999), weight_decay=0.01,
              use_grad_clip=True, accum_steps=accum)
    tx = jts.make_optimizer(jsch, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    opt = ts.make_optimizer(sched, **kw).init(tparams)
    # the clip norm is 0.01: grads of norm ~1 trigger it, ~1e-3 do not
    scale = 1.0 if clip_triggers else 1e-4
    for it in range(3 * accum):
        grads = {k: np.asarray(scale * rng.normal(size=s), np.float32)
                 for k, s in shapes.items()}
        norm = float(np.sqrt(sum((g ** 2).sum() for g in grads.values())))
        assert (norm >= 0.01) == clip_triggers
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step([torch.from_numpy(grads[k]) for k in sorted(shapes)])
        for k, t in zip(sorted(shapes), tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after update {it}")
    assert opt.count == 3


NET = {"type": "NewBPNAFNet", "in_channels": 3,
       "nafnet_params": {"img_channel": 3, "width": 8, "enc_blk_nums": [1, 1],
                         "middle_blk_num": 1, "dec_blk_nums": [1, 1]}}


def _batch(kind="flagship"):
    """``flagship``: gt uniform in [0, 1], rho = 100, 300 and lq =
    clip(gt / rho + N(0, 1e-3)), as the recipe sees it; ``mid``: gt in
    [0.2, 0.8], rho = 2, 3, so no prediction lies near the [0, 1] clamps."""
    rng = np.random.default_rng(0)
    lo, hi, expo = ((0.0, 1.0, [100.0, 300.0]) if kind == "flagship"
                    else (0.2, 0.8, [2.0, 3.0]))
    gt = rng.uniform(lo, hi, (2, 32, 32, 3)).astype(np.float32)
    expo = np.array(expo, np.float32)
    lq = np.clip(gt / expo[:, None, None, None]
                 + rng.normal(0, 1e-3, gt.shape), 0, 1).astype(np.float32)
    return gt, lq, expo


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("kind", ["flagship", "mid"])
def test_three_train_steps_match_jax(kind):
    cfg = yaml.safe_load(open(CONFIG))
    topt = dict(cfg["train"], enable_amp=False)
    optim = dict(topt["optim_g"])
    lr = float(optim.pop("lr"))
    kw = dict(optim_type=optim.pop("type"), betas=tuple(optim["betas"]),
              weight_decay=float(optim["weight_decay"]),
              use_grad_clip=topt["use_grad_clip"],
              accum_steps=topt["accum_steps"])
    gt, lq, expo = _batch(kind)

    # JAX: unfused NAFNet on CPU, random VGG trunk, optax chain
    jnet = jax_define_network(dict(NET))
    jloss = jbuild_hybrid_loss(topt)
    jloss.perceptual = JaxPerceptualLoss()
    tx = jts.make_optimizer(jsched.make_schedule(topt["scheduler"], lr), **kw)
    jstate = jts.create_train_state(jnet, tx, jax.random.PRNGKey(0),
                                    jnp.asarray(lq), loss=jloss)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    params = {k: ({**v, "beta": rng.normal(0, 0.3, v["beta"].shape).astype(
        np.float32), "gamma": rng.normal(0, 0.3, v["gamma"].shape).astype(
        np.float32)} if "_blk" in k else v) for k, v in params.items()}
    # intro.bias off its zero init: where the dark flagship lq clips to 0,
    # the first LN1 sees intro.bias alone, and near zero its channel
    # variance sits at LN's eps, where a 2e-8 rounding difference of
    # intro.bias moves the output by ~1e-4
    params["intro"] = {**params["intro"], "bias": rng.normal(
        0, 0.3, params["intro"]["bias"].shape).astype(np.float32)}
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jbatch = dict(lq=jnp.asarray(lq), gt=jnp.asarray(gt),
                  expo_ratio=jnp.asarray(expo))

    # the port: the same weights (fused blocks, plain K1-K4 on CPU)
    net = define_network(dict(NET), device="cpu")
    net.load_state_dict(params_from_jax(params, model=net), strict=True)
    loss = build_hybrid_loss(topt, device="cpu")
    loss.perceptual.vgg.load_state_dict(vgg_params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jloss.perceptual.variables["params"])))
    optimizer = ts.make_optimizer(
        schedules.make_schedule(topt["scheduler"], lr), **kw)
    state = ts.create_train_state(net, optimizer, loss)
    batch = dict(lq=_nchw(lq), gt=_nchw(gt), expo_ratio=torch.from_numpy(expo))

    # first-step gradients, leaf by leaf
    def jtotal(p):
        out = jnet.apply({"params": p}, jbatch["lq"])
        return jloss(**jts.hybrid_batch_kwargs(out, jbatch))[0]

    jgrads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(jtotal)(jstate.params)))
    total, _ = loss(**ts.hybrid_batch_kwargs(net(batch["lq"]), batch))
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(total, list(net.parameters()))
    for k, g in zip(names, grads):
        ref = jgrads[k].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=k)

    jstep = jts.make_train_step(jnet, jloss, tx, donate=False)
    step = ts.make_train_step(net, loss, optimizer)
    for i in range(3):
        jstate, jlogs = jstep(jstate, jbatch)
        state, logs = step(state, batch)
        assert_finite_logs(logs)
        assert set(logs) == set(jlogs)
        for k in jlogs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-4, err_msg=f"step {i}: {k}")
    assert state.step == int(jstate.step) == 3
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, prm in net.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_train_step_rules():
    net = define_network(dict(NET), device="cpu")
    loss = build_hybrid_loss({"hybrid_opt": {
        "use_perc": False, "use_deltaE": False, "use_ssim": False,
        "use_phys": False}}, device="cpu")
    opt = ts.make_optimizer(1e-3)
    mixup_step = ts.make_train_step(net, loss, opt, mixup_alpha=1.2, seed=3)
    with pytest.raises(ValueError):
        ts.make_optimizer(1e-3, optim_type="Lion")
    state = ts.create_train_state(net, opt, loss)
    gt, lq, _ = _batch()
    batch = dict(lq=_nchw(lq), gt=_nchw(gt))
    state, logs = ts.make_train_step(net, loss, opt)(state, batch)
    assert state.step == 1 and float(logs["grad_norm"]) > 0
    out = ts.make_eval_step(net)(batch["lq"])
    assert out.shape == batch["lq"].shape and not out.requires_grad
    # mixup (training/augment.py) mixes the batch before the step
    state, logs = mixup_step(state, batch)
    assert state.step == 2 and np.isfinite(float(logs["l_total"]))
