"""Data-parallel training of the port (``make_train_step(..., mesh=)``:
one flat gradient all-reduce after ``torch.autograd.grad``, the logs
averaged over the ranks) held against the JAX package's data-parallel
step on a 2-device mesh.

The network and loss are ``tests/test_zero1.py``'s: a width-8 NAFNet with
(1,)/1/(1,) blocks and ``HybridLossPlus`` with the P2 physics term, on a
4-image batch; the port runs two real processes over gloo on the CPU,
each with 2 of the images. Tolerances: every logged term rtol 1e-4 per
step; the parameters after 3 steps within 1e-5 of each leaf's max|p|;
the 2-rank gradients within 1e-5 of each leaf's max|g| of the
single-process 4-image step. The step's collectives, read from a
``torch.profiler`` trace of one step, are exactly one bulk all-reduce of
0.95-1.10x the fp32 gradient bytes and no bulk all-gather (JAX's
``tests/test_collective_structure.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lowlight_image_enhancement_tpu.models import (
    define_network as jax_define_network,
)
from lowlight_image_enhancement_tpu.parallel import create_mesh as jax_mesh
from lowlight_image_enhancement_tpu.parallel import shard_batch as jax_shard
from lowlight_image_enhancement_tpu.training import train_step as jts
from lowlight_image_enhancement_tpu.training.trainer import (
    build_hybrid_loss as jax_build_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel.introspect import (
    bulk_and_scalar,
    collective_stats,
)
from lowlight_image_enhancement_tpu_torch.parallel.launch import (
    spawn,
    train_steps,
)
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

NET = {"type": "NewBPNAFNet", "in_channels": 3,
       "nafnet_params": {"img_channel": 3, "width": 8, "enc_blk_nums": [1],
                         "middle_blk_num": 1, "dec_blk_nums": [1]}}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 1e-3},
         "hybrid_opt": {"use_perc": False, "use_deltaE": False,
                        "use_ssim": False, "use_phys": True,
                        "physics": {"mode": "mono", "kernel_spec": "P2"}}}
STEPS = 3


def _batch(n=4, s=16):
    """``tests/test_zero1.py``'s batch, NHWC."""
    rng = np.random.default_rng(3)
    short = rng.uniform(0, 0.2, (n, s, s, 3)).astype(np.float32)
    lq = np.clip(short * 5.0, 0, 1).astype(np.float32)
    gt = np.clip(lq + 0.02, 0, 1).astype(np.float32)
    return {"lq": lq, "gt": gt, "short_raw": short, "long_raw": gt,
            "short_obs": short, "expo_ratio": np.full((n,), 5.0, np.float32)}


def _nchw(batch):
    return {k: (np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if v.ndim == 4
                else v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs():
    """The JAX step on a 2-device mesh, the port on 2 ranks and in one
    process, from the same weights (beta/gamma off their zero init, so
    every block carries gradient)."""
    batch = _batch()
    jnet = jax_define_network(dict(NET))
    jloss = jax_build_hybrid_loss(TRAIN)
    tx = jts.make_optimizer(1e-3)
    state = jts.create_train_state(jnet, tx, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16, 16, 3)), loss=jloss)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    params = {k: ({**v, "beta": rng.normal(0, 0.3, v["beta"].shape).astype(
        np.float32), "gamma": rng.normal(0, 0.3, v["gamma"].shape).astype(
        np.float32)} if "_blk" in k else v) for k, v in params.items()}
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))

    mesh = jax_mesh(2)
    jstate = jts.put_replicated(state, mesh)
    jstep = jts.make_train_step(jnet, jloss, tx, donate=False)
    sb = jax_shard(batch, mesh)
    jlogs = []
    for _ in range(STEPS):
        jstate, logs = jstep(jstate, sb)
        jlogs.append({k: float(v) for k, v in logs.items()})
    jparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))

    port_net = define_network(dict(NET), device="cpu")
    spec = dict(network_g=NET, train=TRAIN, batch=_nchw(batch), steps=STEPS,
                grads=True, trace_step=1, device="cpu",
                state_dict=params_from_jax(params, model=port_net))
    two = spawn(train_steps, 2, device="cpu", args=(spec,), threads=2)
    one = train_steps(dict(spec, trace_step=None))
    return dict(jlogs=jlogs, jparams=jparams, two=two, one=one)


def test_two_rank_logs_match_jax_mesh(runs):
    for rank in runs["two"]:
        assert len(rank["logs"]) == STEPS
        for i, (got, want) in enumerate(zip(rank["logs"], runs["jlogs"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=f"step {i}: {k}")


def test_two_rank_params_match_jax_mesh(runs):
    two = runs["two"]
    for rank in two:
        for k, p in zip(rank["names"], rank["params"]):
            want = runs["jparams"][k].numpy()
            np.testing.assert_allclose(
                p, want, rtol=0, atol=1e-5 * float(np.abs(want).max()),
                err_msg=k)
    # both ranks hold the same parameters, bit for bit
    for a, b in zip(two[0]["params"], two[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_two_rank_grads_match_one_process(runs):
    one = runs["one"]
    for rank in runs["two"]:
        assert len(rank["grads"]) == len(one["grads"]) > 0
        for k, g, want in zip(rank["names"], rank["grads"], one["grads"]):
            np.testing.assert_allclose(
                g, want, rtol=0, atol=1e-5 * float(np.abs(want).max()),
                err_msg=k)


def test_dp_step_has_single_bulk_grad_allreduce(runs):
    grad_bytes = sum(p.size * 4 for p in runs["one"]["params"])
    for rank in runs["two"]:
        stats = rank["stats"]
        split = bulk_and_scalar(stats)
        ar = split["all-reduce"]
        assert ar["bulk_count"] == 1, stats
        assert 0.95 * grad_bytes <= ar["bulk_bytes"] <= 1.10 * grad_bytes
        # the logged losses: one small all-reduce
        assert ar["scalar_count"] == 1
        for kind in ("all-gather", "reduce-scatter", "all-to-all"):
            assert split.get(kind, {}).get("bulk_count", 0) == 0, stats


def test_collective_stats_parser():
    """c10d's dispatcher records (the names are pinned here: gloo and NCCL
    record the same ``c10d::`` ops), a backend's own annotation (not
    counted again) and a compute op."""
    def ev(name, dims, types, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name,
                "args": {"Input Dims": dims, "Input type": types}}

    trace = {"traceEvents": [
        ev("c10d::allreduce_", [[[1024]], [], []], ["TensorList", "", ""]),
        ev("c10d::allreduce_", [[[256], [128]]], ["TensorList"]),
        ev("c10d::_allgather_base_", [[8, 4], [2, 4], []],
           ["float", "float", ""]),
        ev("c10d::allgather_", [[], [[3]]], ["", "TensorList"]),
        ev("c10d::broadcast_", [[[16]]], ["TensorList"]),
        ev("c10d::barrier", [[1], []], ["unsigned char", ""]),
        ev("gloo:all_reduce", [[1024]], ["float"], cat="user_annotation"),
        ev("aten::add", [[4], [4]], ["float", "float"]),
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]}
    stats = collective_stats(trace)
    assert set(stats) == {"all-reduce", "all-gather", "broadcast", "barrier"}
    assert stats["all-reduce"]["count"] == 2
    assert stats["all-reduce"]["bytes"] == 1024 * 4 + (256 + 128) * 4
    assert stats["all-reduce"]["shapes"] == ["f32[1024]",
                                             "(f32[256], f32[128])"]
    assert stats["all-gather"]["count"] == 2
    assert stats["all-gather"]["bytes"] == 32 * 4 + 3 * 4
    assert stats["barrier"]["bytes"] == 1
    split = bulk_and_scalar(stats)
    assert split["all-reduce"] == {"bulk_count": 1, "bulk_bytes": 4096,
                                   "scalar_count": 1}
