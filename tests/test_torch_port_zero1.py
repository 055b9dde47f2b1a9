"""ZeRO-1 in the port (``parallel/zero.py``, ``ChainOptimizer.shard_``):
the optimizer moments cut per leaf over the ranks, the update on each
rank's slices, the parameters gathered back.

- the leaf rule against the JAX package's ``zero1_shardings`` on the same
  state shapes (the same sharded dimension for every moment leaf);
- two ranks over gloo on the CPU (real processes), 3 steps: ZeRO-1 equals
  replicated data-parallel training within 2e-6 (JAX's bar in
  ``tests/test_zero1.py``), a moment leaf holds 1/2 of its elements on
  each rank, the step adds a bulk all-gather of the parameters; with
  ``accum_steps=2`` (the accumulator sharded too) ZeRO-1 equals the
  single-process step within 1e-5 of each leaf's max|p|;
- ``Trainer`` with ``train.zero1: true`` on the debug config at 2 ranks:
  4 iterations (center crops, 2 iterations an epoch), a resume at 2 that
  gives iterations 3-4's logged losses again, and a checkpoint that
  reloads into a single-process ``Trainer``.
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.parallel import create_mesh as jax_mesh
from lowlight_image_enhancement_tpu.parallel import (
    zero1_shardings as jax_zero1_shardings,
)
from lowlight_image_enhancement_tpu.training import train_step as jts
from lowlight_image_enhancement_tpu_torch.data import make_debug_sid
from lowlight_image_enhancement_tpu_torch.parallel import (
    create_mesh,
    zero1_shardings,
)
from lowlight_image_enhancement_tpu_torch.parallel.introspect import (
    bulk_and_scalar,
)
from lowlight_image_enhancement_tpu_torch.parallel.launch import (
    run_trainer,
    spawn,
    train_steps,
)
from lowlight_image_enhancement_tpu_torch.training import checkpoint as ckpt
from lowlight_image_enhancement_tpu_torch.training import train_step as ts
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer

SHAPES = {"a": (8, 3, 3, 3), "b": (16,), "c": (3, 5), "d": (6, 4, 2),
          "e": (2, 2), "f": (7,), "g": (), "h": (1, 8, 1, 1), "i": (12, 6)}
NET = {"type": "NAFNet", "img_channel": 3, "width": 8,
       "middle_blk_num": 1, "enc_blk_nums": [1], "dec_blk_nums": [1]}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 1e-3},
         "hybrid_opt": {"use_perc": False, "use_deltaE": False,
                        "use_ssim": False, "use_phys": True,
                        "use_uncertainty": True,
                        "physics": {"mode": "mono", "kernel_spec": "P2"}}}
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "debug",
                      "sid_newbp_mono_debug.yml")


@pytest.mark.parametrize("n", [2, 4])
def test_leaf_rule_matches_jax(n):
    params = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    tx = jts.make_optimizer(1e-3)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=tx.init(params), log_sigma={})
    sh = jax_zero1_shardings(jstate, jax_mesh(n))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh.opt_state)[0]:
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if "mu" in names:
            spec = tuple(s.spec) + (None,) * len(SHAPES[names[-1]])
            want[names[-1]] = next((d for d, a in enumerate(spec)
                                    if a == "data"), None)
    opt = ts.make_optimizer(1e-3).init(
        [torch.zeros(SHAPES[k]) for k in sorted(SHAPES)])
    got = zero1_shardings(SimpleNamespace(optimizer=opt),
                          create_mesh(devices=["cpu"] * n))
    assert set(got) == {"mu", "nu"}
    assert dict(zip(sorted(SHAPES), got["mu"])) == want
    assert got["nu"] == got["mu"]


def _batch(n=4, s=16):
    rng = np.random.default_rng(3)
    short = rng.uniform(0, 0.2, (n, 3, s, s)).astype(np.float32)
    lq = np.clip(short * 5.0, 0, 1).astype(np.float32)
    gt = np.clip(lq + 0.02, 0, 1).astype(np.float32)
    return {"lq": lq, "gt": gt, "short_raw": short, "long_raw": gt,
            "short_obs": short, "expo_ratio": np.full((n,), 5.0, np.float32)}


@pytest.fixture(scope="module")
def steps():
    spec = dict(network_g=NET, train=TRAIN, batch=_batch(), steps=3,
                trace_step=1, device="cpu")
    accum = dict(spec, train=dict(TRAIN, accum_steps=2), steps=4,
                 trace_step=None)
    return dict(rep=spawn(train_steps, 2, device="cpu", args=(spec,),
                          threads=2),
                zero=spawn(train_steps, 2, device="cpu",
                           args=(dict(spec, zero1=True),), threads=2),
                zero_accum=spawn(train_steps, 2, device="cpu",
                                 args=(dict(accum, zero1=True),), threads=2),
                one_accum=train_steps(accum))


def test_zero1_matches_replicated_training(steps):
    for z, r in zip(steps["zero"], steps["rep"]):
        assert [lg["l_total"] for lg in z["logs"]] == pytest.approx(
            [lg["l_total"] for lg in r["logs"]], rel=1e-6)
        for k, a, b in zip(z["names"] + ["log_sigma"] * 9, z["params"],
                           r["params"]):
            np.testing.assert_allclose(a, b, atol=2e-6, rtol=2e-6,
                                       err_msg=k)
    for a, b in zip(steps["zero"][0]["params"], steps["zero"][1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_moments_are_sharded_half_per_rank(steps):
    for z, r in zip(steps["zero"], steps["rep"]):
        halves = [m for m, p in zip(z["moment_shapes"], z["param_shapes"])
                  if np.prod(m) * 2 == np.prod(p)]
        assert halves, "no moment leaf holds 1/2 of its elements"
        # the log_sigma scalars (no dimension 2 divides) stay whole
        assert z["moment_shapes"][-1] == z["param_shapes"][-1] == ()
        assert z["state_bytes"] < 0.6 * r["state_bytes"]


def test_zero1_step_adds_param_gather(steps):
    for z, r in zip(steps["zero"], steps["rep"]):
        zs, rs = bulk_and_scalar(z["stats"]), bulk_and_scalar(r["stats"])
        assert zs["all-reduce"]["bulk_bytes"] == rs["all-reduce"][
            "bulk_bytes"] > 0
        assert zs.get("all-gather", {}).get("bulk_count", 0) >= 1, z["stats"]
        assert rs.get("all-gather", {}).get("bulk_count", 0) == 0


def test_zero1_accumulation_matches_one_process(steps):
    one = steps["one_accum"]
    for z in steps["zero_accum"]:
        for k, a, b in zip(z["names"], z["params"], one["params"]):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()), err_msg=k)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("debug_sid")
    make_debug_sid(str(root))
    old = os.environ.get("DEBUG_SID_ROOT")
    os.environ["DEBUG_SID_ROOT"] = str(root)
    try:
        opt = parse(CONFIG, is_train=True,
                    root_dir=str(tmp_path_factory.mktemp("exp")))
        opt["train"] = dict(opt["train"], total_iter=4, zero1=True)
        # center crops and 2 iterations an epoch (2 pairs x 4 samples over
        # 2 ranks, 2 a batch): the resume at 2 starts epoch 1, whose
        # batches are iterations 3-4's
        opt["datasets"]["train"] = dict(opt["datasets"]["train"],
                                        samples_per_pair=4,
                                        random_crop=False)
        opt["logger"] = dict(opt["logger"], save_checkpoint_freq=2,
                             print_freq=1)
        opt["val"] = dict(opt["val"], val_freq=4)
        outs = spawn(run_trainer, 2, device="cpu", args=(opt, 2),
                     threads=2)
        single = Trainer(copy.deepcopy(opt), device="cpu")
    finally:
        if old is None:
            os.environ.pop("DEBUG_SID_ROOT", None)
        else:
            os.environ["DEBUG_SID_ROOT"] = old
    return opt, outs, single


def test_trainer_zero1_two_ranks(trainer_runs):
    opt, outs, _ = trainer_runs
    for out in outs:
        assert out["zero1"] and out["step"] == 4
        assert [h["iter"] for h in out["history"]] == [1, 2, 3, 4]
        assert all(np.isfinite(h["l_total"]) for h in out["history"])
        assert set(out["val"]) == {"psnr_linear", "ssim_linear"}
    # every rank logs the global means and validates to the same numbers
    assert outs[0]["history"][-1]["l_total"] == outs[1]["history"][-1][
        "l_total"]
    assert outs[0]["val"] == outs[1]["val"]
    # a resume at 2 gives iterations 3-4 again
    for out in outs:
        assert out["resumed_from"] == 2
        got = [h["l_total"] for h in out["resumed_history"]]
        want = [h["l_total"] for h in out["history"][2:]]
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_zero1_checkpoint_reloads_into_one_process(trainer_runs):
    opt, _, single = trainer_runs
    assert single.mesh is None and single.start_iter == 4
    saved = torch.load(ckpt.latest_training_state(
        opt["path"]["training_states"]), weights_only=True)
    opt_state = single.state.optimizer
    for p, m, saved_m in zip(opt_state.params, opt_state.mu,
                             saved["optimizer"]["mu"]):
        assert m.shape == p.shape == saved_m.shape
        assert torch.equal(m, saved_m)
    assert opt_state.count == 4
