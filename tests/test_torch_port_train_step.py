"""The port's training core held against the JAX package: schedules,
the optimizer chain (clip 0.01 -> AdamW, with optax.MultiSteps), and
three train steps of a small ``NewBPNAFNet`` with the self-contained
flagship loss from the same bridged weights, fp32. The multi-tensor
update is held to every bit against the per-leaf loop it replaced, and
its dispatched op count against the number of leaves.

Tolerances: schedules rtol 1e-5, atol 1e-7 of the base lr (JAX computes
in fp32, so a cosine near eta_min carries the base lr's rounding); one optimizer
update rtol 1e-5 / atol 1e-7 (elementwise fp32 arithmetic in another
order); train steps: every loss term rtol 1e-4, first-step gradients
atol 1e-4 * max(1, max|g|) per leaf, parameters after three steps atol
1e-4 (0.1 * lr).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

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
from lowlight_image_enhancement_tpu_torch.utils import profiling
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


# -- the multi-tensor update against the per-leaf loop it replaced ---------

def _loop_step(opt, grads, g_norm_of):
    """One ``step`` of the per-leaf loop that ``ChainOptimizer`` ran before
    its update became multi-tensor, on ``opt``'s own state; the clip norm
    is ``g_norm_of(grads)`` of the gradient it clips."""
    grads = [g.float() for g in grads]
    if opt.acc is None:
        _loop_apply(opt, grads, g_norm_of(grads)
                    if opt.max_norm is not None else None)
        return
    n = opt.mini_step
    for a, g in zip(opt.acc, grads):
        a.add_((g - a) / (n + 1))
    opt.mini_step = (n + 1) % opt.accum_steps
    if opt.mini_step:
        return
    grads = [a.clone() for a in opt.acc]
    for a in opt.acc:
        a.zero_()
    _loop_apply(opt, grads, g_norm_of(grads)
                if opt.max_norm is not None else None)


def _loop_apply(opt, grads, g_norm):
    if g_norm is not None:
        scale = torch.where(g_norm < opt.max_norm, torch.ones_like(g_norm),
                            opt.max_norm / g_norm)
        for g in grads:
            g.mul_(scale)
    lr = float(opt.schedule(opt.count))
    opt.count += 1
    if opt.optim_type == "SGD":
        for p, g in zip(opt.params, grads):
            p.add_(g, alpha=-lr)
        return
    one = np.float32(1.0)
    c1 = float(one - np.float32(opt.b1) ** np.float32(opt.count))
    c2 = float(one - np.float32(opt.b2) ** np.float32(opt.count))
    for p, g, m, v in zip(opt.params, grads, opt.mu, opt.nu):
        m.mul_(opt.b1).add_(g, alpha=1.0 - opt.b1)
        v.mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
        u = (m / c1) / (torch.sqrt(v / c2) + ts.ADAM_EPS)
        if opt.weight_decay:
            u = u + opt.weight_decay * p
        p.add_(u, alpha=-lr)


def _tensor(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


# leaves of mixed shapes, a 0-d leaf among them; "mixed": a bf16 group
LEAF_SHAPES = [(3, 4), (5,), (), (2, 3, 5), (7, 1)]
BITWISE_CASES = ([(o, c, a, "fp32") for o in ("AdamW", "Adam", "SGD")
                  for c in (True, False) for a in (1, 2)]
                 + [("AdamW", True, 1, "mixed"), ("AdamW", False, 2, "mixed")])


@pytest.mark.parametrize("optim_type,clip_triggers,accum,dtypes",
                         BITWISE_CASES,
                         ids=[f"{o}-{'clip' if c else 'noclip'}-accum{a}-{d}"
                              for o, c, a, d in BITWISE_CASES])
def test_multi_tensor_update_equals_the_per_leaf_loop_bitwise(
        optim_type, clip_triggers, accum, dtypes):
    rng = np.random.default_rng(7)
    dt = ([torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
           torch.bfloat16] if dtypes == "mixed" else [torch.float32] * 5)
    init = [_tensor(rng.normal(size=s), d) for s, d in zip(LEAF_SHAPES, dt)]
    sched = schedules.make_schedule(
        {"type": "TrueCosineAnnealingLR", "T_max": 10, "eta_min": 1e-6}, 0.05)
    kw = dict(optim_type=optim_type, betas=(0.9, 0.999), weight_decay=0.01,
              use_grad_clip=True, accum_steps=accum)
    opt = ts.make_optimizer(sched, **kw).init([t.clone() for t in init])
    ref = ts.make_optimizer(sched, **kw).init([t.clone() for t in init])
    assert len(opt.groups) == (2 if dtypes == "mixed" else 1)
    scale = 1.0 if clip_triggers else 1e-4
    for it in range(3 * accum):
        draw = [_tensor(scale * rng.normal(size=s), d)
                for s, d in zip(LEAF_SHAPES, dt)]
        assert (float(ts.global_norm(draw)) >= 0.01) == clip_triggers
        grads = [g.clone() for g in draw]
        if it % 2:        # the train step's route: the norm handed over
            opt.grad_norm(grads)
        opt.step(grads)
        # both sides clip by the new norm of the same values
        _loop_step(ref, [g.clone() for g in draw], ts.global_norm)
        assert (opt.count, opt.mini_step) == (ref.count, ref.mini_step)
        for k in ("params", "mu", "nu", "acc"):
            for i, (a, b) in enumerate(zip(getattr(opt, k) or [],
                                           getattr(ref, k) or [])):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(_bits(a), _bits(b)), (k, i, it)
    assert opt.count == ref.count == 3


@pytest.mark.parametrize("dtypes", ["fp32", "mixed"])
def test_global_norm_matches_the_sum_of_squares(dtypes):
    rng = np.random.default_rng(11)
    shapes = LEAF_SHAPES + [(64, 33), (1000,)]
    dt = [torch.bfloat16 if dtypes == "mixed" and i % 2 else torch.float32
          for i in range(len(shapes))]
    ts_ = [_tensor(rng.normal(size=s), d) for s, d in zip(shapes, dt)]
    old = torch.sqrt(sum((t.float() * t.float()).sum() for t in ts_))
    new = ts.global_norm(ts_)
    assert new.dtype == torch.float32 and new.shape == ()
    np.testing.assert_allclose(float(new), float(old), rtol=1e-6)


class _Dispatched(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("optim_type", ["AdamW", "Adam", "SGD"])
def test_update_dispatches_as_many_ops_for_8_leaves_as_for_664(optim_type):
    rng = np.random.default_rng(5)

    def ops(n_leaves):
        shapes = [(1 + i % 3, 2) if i % 5 else () for i in range(n_leaves)]
        params = [_tensor(rng.normal(size=s), torch.float32) for s in shapes]
        opt = ts.make_optimizer(1e-3, optim_type=optim_type).init(params)
        grads = [_tensor(rng.normal(size=s), torch.float32) for s in shapes]
        with _Dispatched() as mode:
            opt.grad_norm(grads)
            opt.step(grads)
        assert opt.count == 1
        return sum(mode.ops.values())

    few, many = ops(8), ops(664)
    assert few == many <= 40, (few, many)


def test_train_step_counts_its_update_and_clips_by_the_logged_norm(
        monkeypatch):
    net = define_network(dict(NET), device="cpu")
    loss = build_hybrid_loss({"hybrid_opt": {
        "use_perc": False, "use_deltaE": False, "use_ssim": False,
        "use_phys": False}}, device="cpu")
    opt = ts.make_optimizer(1e-3)
    state = ts.create_train_state(net, opt, loss)
    step = ts.make_train_step(net, loss, opt)
    gt, lq, _ = _batch()
    batch = dict(lq=_nchw(lq), gt=_nchw(gt))
    clipped_by = []
    apply = ts.ChainOptimizer._apply

    def spy(self, grads, g_norm):
        clipped_by.append(g_norm)
        return apply(self, grads, g_norm)

    monkeypatch.setattr(ts.ChainOptimizer, "_apply", spy)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), _Dispatched() as mode:
        for _ in range(2):
            state, logs = step(state, batch)
    counters = profiling.record()["counters"]
    profiling.reset()
    n_params = len(list(net.parameters())) + len(state.log_sigma)
    assert counters["train_step.optimizer_leaves"] == 2 * n_params
    assert counters["train_step.optimizer_groups"] == 2 * 1
    assert len(clipped_by) == 2
    assert torch.equal(clipped_by[-1], logs["grad_norm"])
    assert mode.ops["aten._foreach_norm.Scalar"] == 2   # one norm a step
