"""Port's NAFNet and weight bridge held against the JAX package.

The JAX reference is ``NAFNet(fused_blocks=False, flat_trunk=False)`` (the
unfused NHWC graph). The port runs its fused blocks (the plain version of
K1/K2 on CPU) and its eager blocks, on weights bridged by
``params_from_jax``; fp32, atol 1e-4 / rtol 1e-4 (float summation order
of two conv implementations through a 4-block U-net).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu.models.nafnet import stack_block_params
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax


def _load_converter():
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "convert_torch_nafnet.py"
    spec = importlib.util.spec_from_file_location("convert_torch_nafnet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert_state_dict


convert_state_dict = _load_converter()

KW = dict(img_channel=3, width=8, enc_blk_nums=(1, 2), middle_blk_num=1,
          dec_blk_nums=(1, 1))
ATOL, RTOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def jax_net_and_params():
    net = JaxNAFNet(fused_blocks=False, flat_trunk=False, **KW)
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # non-trivial residual scales and norms in every block
    rng = np.random.default_rng(11)
    params = {
        k: ({**v, **{s: rng.normal(0, 0.5, v[s].shape).astype(np.float32)
                     for s in ("beta", "gamma")},
             "norm1": {"weight": (1 + rng.normal(0, 0.2, v["beta"].shape)
                                  ).astype(np.float32),
                       "bias": rng.normal(0, 0.2, v["beta"].shape
                                          ).astype(np.float32)}}
            if "_blk" in k else v)
        for k, v in params.items()
    }
    return net, params


def _input(h=30, w=20, n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(
        np.float32)


def _port_forward(model, x_nhwc):
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous())
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fused", [True, False])
def test_nafnet_matches_jax_unfused(jax_net_and_params, fused):
    net, params = jax_net_and_params
    x = _input()   # 30x20 pads to 32x20 (multiple of 4) and is cropped back
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    model = NAFNet(fused_blocks=fused, **KW)
    model.load_state_dict(params_from_jax(params, model=model), strict=True)
    got = _port_forward(model, x)
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_define_network_newbp_matches_jax(jax_net_and_params):
    net, params = jax_net_and_params
    model = define_network({"type": "NewBPNAFNet", "in_channels": 3,
                            "kernel_type": "panchromatic",
                            "nafnet_params": dict(KW)}, device="cpu")
    assert isinstance(model, NAFNet) and len(model.blocks()) == 6
    model.load_state_dict(params_from_jax(params, model=model), strict=True)
    x = _input(h=17, w=23, n=1, seed=4)
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_port_forward(model, x), ref, atol=ATOL,
                               rtol=RTOL)


def test_newbp_defaults_are_the_flagship_config():
    model = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                           device="cpu")
    assert len(model.blocks()) == 36 and model.dtype == torch.bfloat16
    widths = sorted({b.conv1.in_channels for b in model.blocks()})
    assert widths == [32, 64, 128, 256, 512]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_torch_converter_reads_port_state_dict(jax_net_and_params):
    _, params = jax_net_and_params
    model = NAFNet(**KW)
    model.load_state_dict(params_from_jax(params), strict=True)
    flat = convert_state_dict(model.state_dict())
    leaves = {"/".join(k.key for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_scanned_layout_is_accepted(jax_net_and_params):
    _, params = jax_net_and_params
    scanned = jax.tree_util.tree_map(np.asarray, stack_block_params(params))
    assert "enc1_blks" in scanned
    a, b = params_from_jax(params), params_from_jax(scanned)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("corrupt", ["unknown_group", "missing_leaf",
                                     "extra_leaf", "missing_group",
                                     "wrong_model"])
def test_bad_keys_raise(jax_net_and_params, corrupt):
    _, params = jax_net_and_params
    bad = dict(params)
    model = None
    if corrupt == "unknown_group":
        bad["side0"] = bad["intro"]
    elif corrupt == "missing_leaf":
        bad["enc0_blk0"] = {k: v for k, v in bad["enc0_blk0"].items()
                            if k != "gamma"}
    elif corrupt == "extra_leaf":
        bad["mid_blk0"] = {**bad["mid_blk0"], "delta": bad["mid_blk0"]["beta"]}
    elif corrupt == "missing_group":
        del bad["ending"]
    else:
        model = NAFNet(**{**KW, "middle_blk_num": 2})
    with pytest.raises(KeyError):
        params_from_jax(bad, model=model)
