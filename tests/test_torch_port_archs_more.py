"""The port's remaining architectures held against the JAX modules: the TLC
windowed mean and ``NAFNetLocal``, the NAFBlock's dropout option,
``NAFNetTPU``, ``UNetSID``, ``SwinIR`` and the generic blocks.

Weights go through the ``*_params_from_jax`` bridges and the same numpy
inputs through both sides, fp32: forward values within 1e-4 of max|ref|
(SwinIR 2e-4), the gradient of every parameter of ``sum(out * cot)``
within 1e-3 of its max|g|, the blocks within 1e-5. ``define_network``
takes every ``network_g`` of ``configs/*.yml`` (debug widths), and the
torch converters of ``tools/`` read the port's UNet and SwinIR
``state_dict``s back into the JAX trees.
"""

import glob
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.models.blocks import (
    ResidualBlockNoBN as JaxResidualBlockNoBN,
)
from lowlight_image_enhancement_tpu.models.blocks import (
    UpsamplePixelShuffle as JaxUpsample,
)
from lowlight_image_enhancement_tpu.models.blocks import (
    make_layer as jax_make_layer,
)
from lowlight_image_enhancement_tpu.models.nafnet import NAFBlock as JaxBlock
from lowlight_image_enhancement_tpu.models.nafnet import nafnet_local
from lowlight_image_enhancement_tpu.models.nafnet_tpu import (
    NAFNetTPU as JaxNAFNetTPU,
)
from lowlight_image_enhancement_tpu.models.swinir import SwinIR as JaxSwinIR
from lowlight_image_enhancement_tpu.models.unet import UNetSID as JaxUNetSID
from lowlight_image_enhancement_tpu.ops.tlc import (
    windowed_mean as jax_windowed_mean,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.blocks import (
    ResidualBlockNoBN,
    UpsamplePixelShuffle,
    make_layer,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock
from lowlight_image_enhancement_tpu_torch.ops.tlc import (
    tlc_window_from_train_size,
    windowed_mean,
)
from lowlight_image_enhancement_tpu_torch.weights import (
    block_state_from_jax,
    nafnet_tpu_params_from_jax,
    params_from_jax,
    swinir_params_from_jax,
    unet_params_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
FWD_TOL, GRAD_TOL = 1e-4, 1e-3
TINY = dict(img_channel=3, width=8, enc_blk_nums=(1, 1), middle_blk_num=1,
            dec_blk_nums=(1, 1))


def _randomized(params, seed):
    """Every leaf but the conv / dense kernels redrawn (zero-initialised
    residual scales and biases would hide half the graph)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "kernel":
            return leaf
        if name in ("weight", "scale"):
            return (1 + rng.normal(0, 0.2, leaf.shape)).astype(np.float32)
        scale = 0.5 if name in ("beta", "gamma") else 0.2
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _init(net, shape, seed):
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                                jnp.zeros(shape))["params"]
    return _randomized(params, seed)


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} > {tol} * {scale}"


def _compare(jnet, params, model, bridge, x, seed, fwd_tol=FWD_TOL,
             zero_grad=()):
    """Forward and every parameter gradient of ``sum(out * cot)``. The
    leaves named in ``zero_grad`` have a gradient of 0 in exact arithmetic:
    on both sides they must stay within 1e-6 of the largest gradient."""
    model.load_state_dict(bridge(params, model=model), strict=True)
    model.eval()
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    cot = np.random.default_rng(seed).standard_normal(ref.shape).astype(
        np.float32)

    def loss(p):
        return jnp.sum(jnet.apply({"params": p}, jnp.asarray(x))
                       * jnp.asarray(cot))

    jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    out = model(_to_nchw(x))
    assert out.dtype == torch.float32
    _close(_to_nhwc(out), ref, fwd_tol, "forward")
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad((out * _to_nchw(cot)).sum(),
                                list(model.parameters()))
    want = bridge(jgrads)
    assert set(want) == set(names)
    top = max(float(g.abs().max()) for g in grads)
    for k, g in zip(names, grads):
        if k in zero_grad:
            assert max(float(g.abs().max()),
                       float(want[k].abs().max())) <= 1e-6 * top, k
            continue
        _close(g.numpy(), want[k].numpy(), GRAD_TOL, f"grad {k}")
    return out


# --- TLC --------------------------------------------------------------------

WINDOWS = [(5, 7), (48, 48), (30, 5), (1, 1)]


def _windowed_mean_f64(x, window):
    """Direct sums over the clipped windows in float64 (NHWC)."""
    kh, kw = window
    _, h, w, _ = x.shape
    out = np.zeros(x.shape, np.float64)
    for i in range(h):
        r0, r1 = max(i - kh // 2, 0), min(i + (kh + 1) // 2, h)
        for j in range(w):
            c0, c1 = max(j - kw // 2, 0), min(j + (kw + 1) // 2, w)
            out[:, i, j] = x[:, r0:r1, c0:c1].astype(np.float64).mean((1, 2))
    return out


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_mean_matches_jax(window):
    """(48, 48) is >= 2x the 12x20 image; (30, 5) exceeds one side only.

    The inputs are multiples of 1/64: every integral-image sum is exact in
    fp32 on both sides, so the two differ only where the window bounds,
    clipping or counts differ. (On continuous data the JAX fp32 integral
    image loses up to 1.7e-2 of a 1x1 window's value to cancellation; the
    port's is float64, and the next test holds it to direct float64 sums
    there.)"""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 64, (2, 12, 20, 4)) / 64).astype(np.float32)
    ref = np.asarray(jax_windowed_mean(jnp.asarray(x), window))
    got = _to_nhwc(windowed_mean(_to_nchw(x), window))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    if window == (48, 48):
        np.testing.assert_allclose(
            got, np.broadcast_to(x.mean((1, 2), keepdims=True), x.shape),
            rtol=1e-6)
    assert tlc_window_from_train_size((256, 256)) == (384, 384)


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_mean_matches_direct_sums(window):
    x = np.random.default_rng(1).uniform(0, 1, (2, 12, 20, 4)).astype(
        np.float32)
    got = _to_nhwc(windowed_mean(_to_nchw(x), window))
    np.testing.assert_allclose(got, _windowed_mean_f64(x, window), rtol=1e-6,
                               atol=0)


def test_nafnet_local_matches_jax():
    """``NAFNetLocal`` with window (12, 12) on 2x3x24x40: the windowed SCA
    in every block (smaller than the image at the top scale, larger below)."""
    jnet = nafnet_local(train_size=(8, 8), **TINY)
    assert jnet.tlc_window == (12, 12)
    params = _init(jnet, (1, 24, 40, 3), 31)
    model = define_network({"type": "NAFNetLocal", "train_size": [8, 8],
                            **TINY}, device="cpu")
    assert all(b.tlc_window == (12, 12) for b in model.blocks())
    x = np.random.default_rng(1).uniform(0, 1, (2, 24, 40, 3)).astype(
        np.float32)
    model.load_state_dict(params_from_jax(params, model=model), strict=True)
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = model.eval()(_to_nchw(x))
    _close(_to_nhwc(out), ref, FWD_TOL, "NAFNetLocal forward")


# --- NAFBlock dropout -------------------------------------------------------

@pytest.fixture(scope="module")
def block_pair():
    jblk = JaxBlock(features=8, dropout_rate=0.0)
    return _init(jblk, (1, 6, 10, 8), 32)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_nafblock_dropout_matches_jax_in_eval(block_pair, rate):
    """Rate 0 against the JAX block; a rate > 0 in eval mode is the rate-0
    block (the JAX ``deterministic=True``)."""
    params = block_pair
    x = np.random.default_rng(3).standard_normal((2, 6, 10, 8)).astype(
        np.float32)
    ref = np.asarray(JaxBlock(features=8).apply({"params": params},
                                                 jnp.asarray(x)))
    blk = NAFBlock(8, dropout_rate=rate)
    blk.load_state_dict(block_state_from_jax(params), strict=True)
    with torch.no_grad():
        out = blk.eval()(_to_nchw(x))
    _close(_to_nhwc(out), ref, FWD_TOL, f"block rate {rate}")


def test_nafblock_dropout_draws_from_its_generator(block_pair):
    """In training mode the masks come from ``generator``: the same seed
    gives the same output, another seed another one, and no generator
    raises. The dropped block differs from the rate-0 block."""
    x = _to_nchw(np.random.default_rng(4).standard_normal(
        (2, 6, 10, 8)).astype(np.float32))
    blk = NAFBlock(8, dropout_rate=0.3)
    blk.load_state_dict(block_state_from_jax(block_pair), strict=True)
    blk.train()
    with pytest.raises(ValueError):
        blk(x)
    outs = []
    for seed in (0, 0, 1):
        blk.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(blk(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        assert not torch.allclose(outs[0], blk.eval()(x))


# --- NAFNetTPU --------------------------------------------------------------

def test_nafnet_tpu_matches_jax():
    """2x3x36x52 pads to 40x56 (a multiple of 2 * 2**2), unshuffles to 12
    channels, runs the trunk and crops back."""
    kw = dict(width=8, enc_blk_nums=(1, 1), middle_blk_num=1,
              dec_blk_nums=(1, 1))
    jnet = JaxNAFNetTPU(dtype=jnp.float32, **kw)
    params = _init(jnet, (1, 36, 52, 3), 33)
    model = define_network({"type": "NAFNetTPU", "dtype": "float32", **kw},
                           device="cpu")
    assert model.trunk.intro.in_channels == 12
    x = np.random.default_rng(5).uniform(0, 1, (2, 36, 52, 3)).astype(
        np.float32)
    out = _compare(jnet, params, model, nafnet_tpu_params_from_jax, x, 6)
    assert out.shape == (2, 3, 36, 52)


# --- UNetSID ----------------------------------------------------------------

@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("norm", ["none", "group"])
def test_unet_matches_jax(bilinear, norm):
    """Depths (8, 16, 32) on an odd 2x3x33x47 input: the floored pools and
    the pad-to-match of every up run."""
    kw = dict(in_channels=3, out_channels=3, depths=(8, 16, 32),
              bilinear=bilinear, norm=norm)
    jnet = JaxUNetSID(**kw)
    params = _init(jnet, (1, 33, 47, 3), 34)
    model = define_network({"type": "UNetSID", **kw}, device="cpu")
    x = np.random.default_rng(7).uniform(0, 1, (2, 33, 47, 3)).astype(
        np.float32)
    # a conv bias before a GroupNorm of one channel per group is cancelled
    # by the normalisation: its gradient is 0
    zero = [f"{name}.bias" for name, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d) and norm == "group"
            and m.out_channels <= 8 and ".block." in f"{name}."]
    _compare(jnet, params, model, unet_params_from_jax, x, 8, zero_grad=zero)


def test_unet_kernel_bwd_pools_match_reduce_window(monkeypatch):
    """``$LLIE_MAXPOOL_IMPL=kernel_bwd`` routes the downs' backward through
    K8 (its plain version on the CPU): the same output and gradients as the
    library pool, and as the JAX ``reduce_window`` network."""
    kw = dict(in_channels=3, out_channels=3, depths=(8, 16, 32),
              bilinear=True)
    jnet = JaxUNetSID(**kw)
    params = _init(jnet, (1, 33, 47, 3), 35)
    model = define_network({"type": "UNetSID", **kw}, device="cpu")
    x = np.random.default_rng(9).uniform(0, 1, (2, 33, 47, 3)).astype(
        np.float32)
    model.load_state_dict(unet_params_from_jax(params, model=model))
    xt = _to_nchw(x)

    def run():
        out = model(xt)
        return out, torch.autograd.grad(out.square().sum(),
                                        list(model.parameters()))

    monkeypatch.setenv("LLIE_MAXPOOL_IMPL", "reduce_window")
    out_rw, g_rw = run()
    monkeypatch.setenv("LLIE_MAXPOOL_IMPL", "kernel_bwd")
    out_k, g_k = run()
    assert torch.equal(out_rw, out_k)
    for a, b in zip(g_rw, g_k):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
            a.abs().max()))
    monkeypatch.setenv("LLIE_MAXPOOL_IMPL", "reduce_window")
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    _close(_to_nhwc(out_k), ref, FWD_TOL, "UNet forward, kernel_bwd")


def _load_tool(name):
    path = REPO / "tools" / f"{name}.py"
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


def _flat_leaves(params):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


def test_torch_unet_converter_reads_port_state_dict():
    """``bilinear=False``, no norm: the graph the converter covers."""
    kw = dict(in_channels=3, out_channels=3, depths=(8, 16, 32),
              bilinear=False)
    params = _init(JaxUNetSID(**kw), (1, 16, 16, 3), 36)
    model = define_network({"type": "UNetSID", **kw}, device="cpu")
    model.load_state_dict(unet_params_from_jax(params, model=model))
    flat = _load_tool("convert_torch_unet").convert_unet_state_dict(
        model.state_dict())
    leaves = _flat_leaves(params)
    assert set(flat) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


# --- SwinIR -----------------------------------------------------------------

SWIN_KW = dict(img_channel=3, embed_dim=12, depths=(2, 2), num_heads=(2, 2),
               window_size=4, mlp_ratio=2.0)


@pytest.fixture(scope="module")
def swin_pair():
    jnet = JaxSwinIR(**SWIN_KW)
    return jnet, _init(jnet, (1, 8, 8, 3), 37)


@pytest.mark.parametrize("shape", [(2, 12, 20), (2, 10, 18), (1, 4, 4)])
def test_swinir_matches_jax(swin_pair, shape):
    """12x20: shifted windows with their mask; 10x18: reflect-padded to
    12x20 first; 4x4: one window, so the shift is dropped."""
    jnet, params = swin_pair
    n, h, w = shape
    model = define_network({"type": "SwinIR", **SWIN_KW}, device="cpu")
    x = np.random.default_rng(h * w).uniform(0, 1, (n, h, w, 3)).astype(
        np.float32)
    out = _compare(jnet, params, model, swinir_params_from_jax, x, h + w,
                   fwd_tol=2e-4)
    assert out.shape == (n, 3, h, w)


@pytest.mark.parametrize("bad", [dict(upscale=2), dict(upsampler="pixelshuffle"),
                                 dict(resi_connection="3conv"), dict(ape=True),
                                 dict(qkv_bias=False)])
def test_swinir_unsupported_options_raise(bad):
    model = define_network({"type": "SwinIRRestoration", **SWIN_KW, **bad},
                           device="cpu")
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 3, 8, 8))


def test_torch_swinir_converter_reads_port_state_dict(swin_pair):
    _, params = swin_pair
    model = define_network({"type": "SwinIR", **SWIN_KW}, device="cpu")
    model.load_state_dict(swinir_params_from_jax(params, model=model))
    flat = _load_tool("convert_torch_swinir").convert_state_dict(
        model.state_dict())
    leaves = _flat_leaves(params)
    assert set(flat) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


# --- generic blocks ---------------------------------------------------------

def _conv_sd(sub):
    k = np.asarray(sub["kernel"])
    return {"weight": torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(np.asarray(sub["bias"]))}


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def test_residual_block_and_make_layer_match_jax():
    import flax.linen as fnn

    class Trunk(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax_make_layer(JaxResidualBlockNoBN, 3, features=8,
                                  res_scale=0.5)(x)

    x = np.random.default_rng(10).standard_normal((2, 6, 7, 8)).astype(
        np.float32)
    params = _init(Trunk(), x.shape, 38)
    ref = np.asarray(Trunk().apply({"params": params}, jnp.asarray(x)))
    trunk = make_layer(ResidualBlockNoBN, 3, features=8, res_scale=0.5)
    sd = {}
    for i in range(3):
        for conv in ("conv1", "conv2"):
            sd.update(_prefixed(f"{i}.{conv}",
                                _conv_sd(params[f"block{i}"][conv])))
    trunk.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = trunk(_to_nchw(x))
    _close(_to_nhwc(out), ref, 1e-5, "make_layer(ResidualBlockNoBN)")

    single = ResidualBlockNoBN(features=8)
    w = single.conv1.weight
    assert float(w.detach().std()) < 0.1 * (2.0 / (9 * 8)) ** 0.5 * 1.5
    assert float(single.conv1.bias.abs().max()) == 0.0


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_upsample_matches_jax(scale):
    jup = JaxUpsample(scale=scale, features=8)
    x = np.random.default_rng(scale).standard_normal((1, 6, 5, 8)).astype(
        np.float32)
    variables = jax.jit(jup.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _randomized(variables.get("params", {}), 39)
    ref = np.asarray(jup.apply({"params": params}, jnp.asarray(x)))
    up = UpsamplePixelShuffle(scale, 8)
    sd = {}
    for name, sub in params.items():
        sd.update(_prefixed(name, _conv_sd(sub)))
    up.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = up(_to_nchw(x))
    assert out.shape == (1, 8, 6 * scale, 5 * scale)
    _close(_to_nhwc(out), ref, 1e-5, f"upsample x{scale}")


def test_upsample_bad_scale():
    with pytest.raises(ValueError):
        UpsamplePixelShuffle(5, 4)


# --- the registry ---------------------------------------------------------

def _debug_width(net_opt):
    """A config's ``network_g`` at debug widths and depths (same type,
    same options otherwise)."""
    opt = dict(net_opt)
    t = opt["type"]
    if t == "NewBPNAFNet":
        opt["nafnet_params"] = {**(opt.get("nafnet_params") or {}),
                                "width": 8, "enc_blk_nums": [1, 1],
                                "middle_blk_num": 1, "dec_blk_nums": [1, 1]}
    elif t in ("NAFNet", "NAFNetTPU", "Baseline"):
        opt.update(width=8, enc_blk_nums=[1, 1], middle_blk_num=1,
                   dec_blk_nums=[1, 1])
    elif t == "NAFSSR":
        opt.update(width=8, num_blks=2)
    elif t in ("UNetSID", "UNetSIDModel"):
        opt.update(depths=[8, 16, 32, 64])
    elif t in ("SwinIR", "SwinIRRestoration"):
        opt.update(embed_dim=12, depths=[2, 2], num_heads=[2, 2],
                   window_size=4)
    return opt


CONFIGS = sorted(glob.glob(str(REPO / "configs" / "*.yml"))
                 + glob.glob(str(REPO / "configs" / "debug" / "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_define_network_builds_every_config(path):
    with open(path) as f:
        net_opt = yaml.safe_load(f)["network_g"]
    model = define_network(_debug_width(net_opt), device="cpu")
    chans = 6 if net_opt["type"] == "NAFSSR" else 3
    scale = int(net_opt.get("up_scale", 1))
    model.eval()
    with torch.no_grad():
        out = model(torch.rand(1, chans, 20, 28,
                               generator=torch.Generator().manual_seed(0)))
    assert out.shape == (1, chans, 20 * scale, 28 * scale)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
