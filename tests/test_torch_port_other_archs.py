"""The port's ``Baseline`` and ``NAFSSR`` held against the JAX modules.

Weights go through ``baseline_params_from_jax`` / ``nafssr_params_from_jax``
and the same numpy inputs through both sides: forward values and the
gradient of every parameter, fp32, each within 2e-4 of max|ref| (two conv
and matmul implementations sum in another order through a few blocks). On
the CPU every ``LayerNorm2d`` runs the plain versions of kernels K5/K6 and
every NAFSSR block the plain versions of K1-K4.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.baseline import (
    Baseline as JaxBaseline,
)
from lowlight_image_enhancement_tpu.models.nafssr import NAFSSR as JaxNAFSSR
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.nafssr import (
    DropPath,
    NAFBlockSR,
)
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_training_losses,
)
from lowlight_image_enhancement_tpu_torch.weights import (
    baseline_params_from_jax,
    nafssr_params_from_jax,
)

TOL = 2e-4
BASE_KW = dict(img_channel=3, width=8, enc_blk_nums=(1, 1), middle_blk_num=1,
               dec_blk_nums=(1, 1))
SSR_KW = dict(up_scale=2, width=8, num_blks=2, img_channel=3)


def _randomized(params, seed):
    """Every leaf redrawn (zero-init scales and biases would hide half the
    graph): kernels keep their init scale, the rest get small normals."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "kernel":
            return leaf
        if name == "weight":
            return (1 + rng.normal(0, 0.2, leaf.shape)).astype(np.float32)
        scale = 0.5 if name in ("beta", "gamma") else 0.2
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= TOL * max(scale, 1e-30), f"{what}: {err} > {TOL} * {scale}"


def _compare(jnet, params, model, bridge, x, cot):
    """Forward and every parameter gradient of ``sum(out * cot)``."""
    model.load_state_dict(bridge(params, model=model), strict=True)
    model.eval()

    def loss(p):
        return jnp.sum(jnet.apply({"params": p}, jnp.asarray(x))
                       * jnp.asarray(cot))

    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    out = model(_to_nchw(x))
    assert out.dtype == torch.float32
    _close(_to_nhwc(out), ref, "forward")
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad((out * _to_nchw(cot)).sum(),
                                list(model.parameters()))
    # the bridge maps JAX grads onto the port's names and layouts
    want = bridge(jgrads)
    assert set(want) == set(names)
    for k, g in zip(names, grads):
        _close(g.numpy(), want[k].numpy(), f"grad {k}")
    return out


@pytest.fixture(scope="module")
def baseline_pair():
    net = JaxBaseline(**BASE_KW)
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8, 8, 3)))["params"]
    return net, _randomized(params, 21)


@pytest.mark.parametrize("hw", [(16, 12), (14, 10)])
def test_baseline_matches_jax(baseline_pair, hw):
    """14x10 is no multiple of 4: padded, then cropped back."""
    net, params = baseline_pair
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    model = define_network({"type": "Baseline", **BASE_KW}, device="cpu")
    out = _compare(net, params, model, baseline_params_from_jax, x, cot)
    assert out.shape == (2, 3, *hw)
    # every LayerNorm2d of the model went through LayerNorm2dFunction
    norms = [m for m in model.modules() if isinstance(m, ln.LayerNorm2d)]
    assert len(norms) == 2 * 5


def test_baseline_width32_is_the_published_configuration():
    model = define_network(
        {"type": "Baseline", "width": 32, "enc_blk_nums": [2, 2, 4, 8],
         "middle_blk_num": 12, "dec_blk_nums": [2, 2, 2, 2], "dw_expand": 1,
         "ffn_expand": 2, "dtype": "bfloat16"}, device="cpu")
    norms = [m for m in model.modules() if isinstance(m, ln.LayerNorm2d)]
    assert len(norms) == 72 and model.dtype == torch.bfloat16
    assert sorted({m.weight.numel() for m in norms}) == [32, 64, 128, 256,
                                                         512]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _load_baseline_converter():
    tools = Path(__file__).resolve().parent.parent / "tools"
    mods = {}
    for name in ("convert_torch_nafnet", "convert_torch_baseline"):
        spec = importlib.util.spec_from_file_location(name,
                                                      tools / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        # convert_torch_baseline imports its sibling by bare name
        sys.modules.setdefault(name, mods[name])
        spec.loader.exec_module(mods[name])
    return mods["convert_torch_baseline"].convert_state_dict


def test_torch_baseline_converter_reads_port_state_dict(baseline_pair):
    _, params = baseline_pair
    model = define_network({"type": "Baseline", **BASE_KW}, device="cpu")
    model.load_state_dict(baseline_params_from_jax(params), strict=True)
    flat = _load_baseline_converter()(model.state_dict())
    leaves = {"/".join(k.key for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.fixture(scope="module")
def nafssr_pair():
    net = JaxNAFSSR(**SSR_KW)
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 6, 10, 6)))["params"]
    return net, _randomized(params, 22)


def test_nafssr_matches_jax(nafssr_pair):
    net, params = nafssr_pair
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 6, 10, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 20, 6)).astype(np.float32)
    model = define_network({"type": "NAFSSR", **SSR_KW,
                            "drop_path_rate": 0.0}, device="cpu")
    out = _compare(net, params, model, nafssr_params_from_jax, x, cot)
    assert out.shape == (2, 6, 12, 20)
    assert len(model.blocks()) == 2


def test_nafssr_eval_mode_ignores_drop_path(nafssr_pair):
    net, params = nafssr_pair
    x = np.random.default_rng(3).uniform(0, 1, (1, 6, 10, 6)).astype(
        np.float32)
    model = define_network({"type": "NAFSSR", **SSR_KW,
                            "drop_path_rate": 0.5}, device="cpu")
    model.load_state_dict(nafssr_params_from_jax(params, model=model))
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    out = make_eval_step(model)(_to_nchw(x))       # no generator needed
    assert model.training                           # mode put back
    _close(_to_nhwc(out), ref, "eval forward")
    with pytest.raises(ValueError, match="torch.Generator"):
        model(_to_nchw(x))                          # training, no generator


def test_nafssr_fusion_range_and_input_check(nafssr_pair):
    _, params = nafssr_pair
    model = define_network({"type": "NAFSSR", **SSR_KW, "fusion_from": 1},
                           device="cpu")
    assert model.body[0].scam is None and model.body[1].scam is not None
    tree = {k: dict(v) for k, v in params.items()}
    del tree["blk0"]["scam"]
    model.load_state_dict(nafssr_params_from_jax(tree, model=model))
    with pytest.raises(ValueError, match="two views"):
        model(torch.zeros(1, 3, 6, 10))


def test_drop_path_masks_per_sample_scaled_and_independent_per_view():
    dp = DropPath(0.4)
    delta = torch.ones(64, 2, 3, 3)
    gen = torch.Generator().manual_seed(5)
    a = dp(delta, gen)
    b = dp(delta, gen)                 # the second view: a draw of its own
    for out in (a, b):
        per_sample = out.flatten(1)
        assert (per_sample == per_sample[:, :1]).all()       # per sample
        vals = sorted(set(per_sample[:, 0].tolist()))
        assert vals == [0.0, pytest.approx(1 / 0.6)]         # scale 1/keep
    assert not torch.equal(a, b)
    # the draws are the generator's: same seed, same masks
    again = dp(delta, torch.Generator().manual_seed(5))
    assert torch.equal(again, a)
    expect = (torch.rand(64, generator=torch.Generator().manual_seed(5))
              < 0.6).float() / 0.6
    assert torch.equal(a[:, 0, 0, 0], expect)
    dp.eval()
    assert dp(delta) is delta
    assert DropPath(0.0)(delta) is delta
    with pytest.raises(ValueError, match="rate"):
        DropPath(1.0)


def test_nafblocksr_draws_once_per_view():
    blk = NAFBlockSR(8, fusion=False, drop_path=0.5)
    with torch.no_grad():
        blk.blk.beta.fill_(0.3)
        blk.blk.gamma.fill_(0.3)
    x = torch.randn(16, 8, 4, 6, generator=torch.Generator().manual_seed(0))
    yl, yr = blk(x, x, torch.Generator().manual_seed(1))
    kept_l = (yl != x).flatten(1).any(1)
    kept_r = (yr != x).flatten(1).any(1)
    assert 0 < kept_l.sum() < 16 and not torch.equal(kept_l, kept_r)


@pytest.mark.parametrize("bridge, pair, corrupt", [
    (baseline_params_from_jax, "baseline_pair", "unknown_group"),
    (baseline_params_from_jax, "baseline_pair", "missing_leaf"),
    (baseline_params_from_jax, "baseline_pair", "missing_group"),
    (baseline_params_from_jax, "baseline_pair", "nafnet_block"),
    (nafssr_params_from_jax, "nafssr_pair", "unknown_group"),
    (nafssr_params_from_jax, "nafssr_pair", "missing_leaf"),
    (nafssr_params_from_jax, "nafssr_pair", "missing_group"),
    (nafssr_params_from_jax, "nafssr_pair", "wrong_model"),
])
def test_bridges_reject_bad_trees(request, bridge, pair, corrupt):
    _, params = request.getfixturevalue(pair)
    bad = {k: dict(v) for k, v in params.items()}
    blk = "mid_blk0" if pair == "baseline_pair" else "blk1"
    model = None
    if corrupt == "unknown_group":
        bad["side0"] = bad["intro"]
    elif corrupt == "missing_leaf":
        inner = dict(bad[blk]["ca"] if pair == "baseline_pair"
                     else bad[blk]["scam"])
        inner.pop("down" if pair == "baseline_pair" else "norm_r")
        bad[blk]["ca" if pair == "baseline_pair" else "scam"] = inner
    elif corrupt == "missing_group":
        del bad["intro"]
    elif corrupt == "nafnet_block":
        bad[blk]["sca_conv"] = bad[blk].pop("ca")["up"]
    else:
        model = define_network({"type": "NAFSSR", **SSR_KW, "num_blks": 3},
                               device="cpu")
    with pytest.raises(KeyError):
        bridge(bad, model=model)


def test_stereo_config_parses_and_trains_on_the_pixel_loss(tmp_path):
    """``configs/stereo_nafssr.yml`` parses with ``${STEREO_ROOT}`` unset;
    its train block builds a pixel-only objective that ``make_train_step``
    runs (debug width), with drop-path masks from the model's generator."""
    opt = parse("configs/stereo_nafssr.yml", root_dir=str(tmp_path))
    assert opt["datasets"]["train"]["dataroot_gt"].startswith("${STEREO_ROOT}")
    assert opt["network_g"]["type"] == "NAFSSR" and opt["scale"] == 2
    train = opt["train"]
    loss, pixel_loss = build_training_losses(train, device="cpu")
    assert pixel_loss is not None and loss.w["l1_raw"] == 0.0
    assert not any(loss.use.values())

    net = define_network({**opt["network_g"], "width": 8, "num_blks": 2},
                         device="cpu")
    net.generator = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.rsplit(".", 1)[-1] in ("beta", "gamma"):
                p.fill_(0.1)
    optimizer = make_optimizer(1e-3, optim_type=train["optim_g"]["type"],
                               betas=tuple(train["optim_g"]["betas"]),
                               weight_decay=train["optim_g"]["weight_decay"])
    state = create_train_state(net, optimizer, loss)
    step = make_train_step(net, loss, optimizer, pixel_loss=pixel_loss)
    rng = np.random.default_rng(0)
    batch = {"lq": torch.from_numpy(rng.uniform(0, 1, (4, 6, 6, 10))
                                    .astype(np.float32)),
             "gt": torch.from_numpy(rng.uniform(0, 1, (4, 6, 12, 20))
                                    .astype(np.float32))}
    history = []
    for _ in range(4):
        state, logs = step(state, batch)
        assert float(logs["l_total"]) == float(logs["l_pix"])
        history.append(float(logs["l_total"]))
    assert np.isfinite(history).all() and history[-1] < history[0]
