"""Backward of the port's fused NAFBlock (K3/K4 plain versions on CPU) held
against the JAX package.

- ``NAFBlockFunction`` grads vs ``jax.grad`` through ``fused_nafblock`` in
  Pallas interpret mode, whole-image and multi-tile, c=8, 16x24, n=2,
  loss ``sum(sin(out))``, for dx and all 18 parameter grads: fp32 within
  atol 2e-4 * max(1, max|ref|) / rtol 1e-4; bf16 within 2^-6 * max|ref|
  (bf16 products rounded at other places in the two frameworks). The
  conv2 bias is zero there: the JAX kernel P2 leaves it out of the gate
  gradient, which is exact only at zero (a test below pins the port to the
  true derivative with a nonzero bias).
- ``plain_p1``/``plain_p2`` vs torch autograd of ``plain_a``/``plain_b``.
- NAFNet grads, fused and eager path, vs the JAX unfused NAFNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.nafnet import NAFBlock as JaxNAFBlock
from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu.ops.pallas.nafblock import (
    BlockConfig,
    fused_nafblock,
    make_block_config,
)
from lowlight_image_enhancement_tpu.ops.pallas.nafblock import (
    pack_params as jax_pack_params,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock, NAFNet
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from lowlight_image_enhancement_tpu_torch.weights import (
    block_state_from_jax,
    params_from_jax,
)

C, H, W, N = 8, 16, 24, 2


def _jax_block_params(c, x, seed=1, conv2_bias=False):
    """Flax NAFBlock params with non-trivial beta/gamma/norms."""
    params = dict(JaxNAFBlock(c).init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.default_rng(seed)
    params["beta"] = jnp.asarray(rng.normal(size=(c,)), jnp.float32)
    params["gamma"] = jnp.asarray(rng.normal(size=(c,)), jnp.float32)
    for name in ("norm1", "norm2"):
        params[name] = {
            "weight": jnp.asarray(rng.normal(size=(c,)) + 1.0, jnp.float32),
            "bias": jnp.asarray(rng.normal(size=(c,)), jnp.float32),
        }
    if conv2_bias:
        params["conv2"] = {**params["conv2"], "bias": jnp.asarray(
            rng.normal(size=(2 * c,)), jnp.float32)}
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_pack(params):
    return jax_pack_params(
        params["norm1"]["weight"], params["norm1"]["bias"],
        params["conv1"]["kernel"], params["conv1"]["bias"],
        params["conv2"]["kernel"], params["conv2"]["bias"],
        params["sca_conv"]["kernel"], params["sca_conv"]["bias"],
        params["conv3"]["kernel"], params["conv3"]["bias"],
        params["norm2"]["weight"], params["norm2"]["bias"],
        params["conv4"]["kernel"], params["conv4"]["bias"],
        params["conv5"]["kernel"], params["conv5"]["bias"],
        params["beta"], params["gamma"])


def _flat(x_nhwc):
    n, h, w, c = x_nhwc.shape
    return np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)).reshape(
        n, c, h * w)


def _port_block(params, c, fused=True):
    blk = NAFBlock(c, fused=fused)
    blk.load_state_dict(block_state_from_jax(params), strict=True)
    return blk


def _port_grads(blk, xf, hw, dtype):
    """d sum(sin(out)) / d (x, state_dict) through NAFBlockFunction."""
    x = torch.from_numpy(xf).to(dtype).requires_grad_(True)
    out = ops.nafblock_fwd(x, blk.packed(), hw)
    assert out.dtype == dtype
    loss = torch.sin(out.float()).sum()
    names = [k for k, _ in blk.named_parameters()]
    grads = torch.autograd.grad(loss, [x, *blk.parameters()])
    assert grads[0].dtype == dtype
    return grads[0].float().numpy(), {
        k: g.numpy() for k, g in zip(names, grads[1:])}


def _check(got, ref, what, dtype):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=2e-4 * max(1.0, scale), err_msg=what)
    else:
        assert err <= 2.0 ** -6 * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_block_grads_match_jax_fused_vjp(tiled, dtype):
    x = np.random.default_rng(0).normal(size=(N, H, W, C)).astype(np.float32)
    params = _jax_block_params(C, x)
    assert not np.any(params["conv2"]["bias"])
    cfg = (BlockConfig(H, W, 4, C, 2 * C, 2 * C, 1, 2, 1, 1e-6, True)
           if tiled else make_block_config(H, W, C, 2, 2))
    assert cfg is not None and (cfg.th < H) == tiled
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(p, xf):
        out = fused_nafblock(xf, _jax_pack(p), cfg)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    xf = _flat(x)
    xq = np.array(jnp.asarray(xf).astype(jdt).astype(jnp.float32))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(xf, jdt))
    ref_p = block_state_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    got_x, got_p = _port_grads(_port_block(params, C), xq, (H, W), dtype)
    _check(got_x, np.asarray(gx, np.float32), "dx", dtype)
    assert set(got_p) == set(ref_p) and len(got_p) == 18
    for k, g in got_p.items():
        _check(g, ref_p[k].numpy(), k, dtype)


def test_block_grads_with_conv2_bias_match_jax_unfused_block():
    """With a nonzero depthwise bias the port's fused backward still gives
    the block's true gradient (``jax.grad`` of the unfused Flax block)."""
    x = np.random.default_rng(3).normal(size=(N, H, W, C)).astype(np.float32)
    params = _jax_block_params(C, x, seed=4, conv2_bias=True)
    net = JaxNAFBlock(C)

    def loss(p, xn):
        return jnp.sum(jnp.sin(net.apply({"params": p}, xn)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    ref_p = block_state_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    got_x, got_p = _port_grads(_port_block(params, C), _flat(x), (H, W),
                               torch.float32)
    _check(got_x, _flat(np.asarray(gx)), "dx", torch.float32)
    for k, g in got_p.items():
        _check(g, ref_p[k].numpy(), k, torch.float32)


def _random_packed(c, seed):
    blk = NAFBlock(c)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            r = torch.randn(prm.shape, generator=gen)
            prm.copy_(1.0 + 0.2 * r if "norm" in name and
                      name.endswith("weight") else r / 2)
    return blk.packed()


def test_plain_backward_matches_autograd_of_plain_forward():
    c, h, w, n = 8, 7, 9, 2
    hw = (h, w)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in _random_packed(c, 0).items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, c, h * w)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(n, c, h * w)).astype(np.float32))
    x.requires_grad_(True)

    # second half: autograd of plain_b at fixed (x, g, att)
    g, sums = ops.plain_a(x.detach(), p, hw)
    att = ops.sca_attention(sums, p, h * w).detach()
    gl = g.detach().requires_grad_(True)
    al = att.clone().requires_grad_(True)
    b_names = ["W3", "b3", "w2n", "b2n", "W4", "b4", "W5", "b5", "beta",
               "gamma"]
    auto = torch.autograd.grad(ops.plain_b(x, gl, al, p), [x, gl, al]
                               + [p[k] for k in b_names], dout)
    dz, da, grads = ops.plain_p1(x.detach(), g.detach(), dout, att, p)
    torch.testing.assert_close(dz, auto[0], rtol=1e-4, atol=1e-4)
    # da = sum_p dv * g is the attention grad
    torch.testing.assert_close(da, auto[2], rtol=1e-4, atol=1e-4)
    for k, ref in zip(b_names, auto[3:]):
        torch.testing.assert_close(grads[k], ref, rtol=1e-4, atol=1e-4,
                                   msg=k)

    # first half: autograd of plain_a -> SCA at fixed dz, att-grad da
    a_names = ["w1n", "b1n", "W1", "b1", "kdw", "bk"]
    g2, sums2 = ops.plain_a(x, p, hw)
    att2 = ops.sca_attention(sums2, p, h * w)
    v = g2 * att2.detach()[:, :, None]
    # g feeds v = g * att (cotangent dv) and the SCA mean (cotangent via da)
    dv = torch.matmul(p["W3"].detach().t(), p["beta"].detach()[:, None] * dz)
    surrogate = (v * dv).sum() + (att2 * da).sum() + (x * dz).sum()
    auto1 = torch.autograd.grad(surrogate, [x] + [p[k] for k in a_names]
                                + [p["Wsca"], p["bsca"]])
    m = sums.detach() / (h * w)
    dwsca, dbsca, dgc = ops.sca_backward(da, m, p, h * w)
    dx, grads1 = ops.plain_p2(x.detach(), dz, dgc, att, p, hw)
    torch.testing.assert_close(dx, auto1[0], rtol=1e-4, atol=1e-4)
    for k, ref in zip(a_names, auto1[1:]):
        torch.testing.assert_close(grads1[k], ref, rtol=1e-4, atol=1e-4,
                                   msg=k)
    torch.testing.assert_close(dwsca, auto1[-2], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dbsca, auto1[-1], rtol=1e-4, atol=1e-4)


def test_cpu_backward_dispatch_counts_no_launch():
    c, h, w = 8, 5, 6
    blk = NAFBlock(c)
    x = torch.randn(1, c, h, w, requires_grad=True)
    ops.reset_launch_counts()
    blk(x).sum().backward()
    assert x.grad.shape == x.shape
    assert all(prm.grad is not None for prm in blk.parameters())
    assert (ops.call_a.launches, ops.call_b.launches, ops.call_p1.launches,
            ops.call_p2.launches) == (0, 0, 0, 0)


KW = dict(img_channel=3, width=8, enc_blk_nums=(1, 1), middle_blk_num=1,
          dec_blk_nums=(1, 1))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_nafnet_grads_match_jax_unfused(fused):
    net = JaxNAFNet(fused_blocks=False, flat_trunk=False, **KW)
    x = np.random.default_rng(7).uniform(0, 1, (2, 20, 12, 3)).astype(
        np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(8)
    params = {k: ({**v, "beta": rng.normal(0, 0.5, v["beta"].shape).astype(
        np.float32), "gamma": rng.normal(0, 0.5, v["gamma"].shape).astype(
        np.float32)} if "_blk" in k else v) for k, v in params.items()}

    def loss(p, xn):
        return jnp.sum(jnp.sin(3.0 * net.apply({"params": p}, xn)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    model = NAFNet(fused_blocks=fused, **KW)
    model.load_state_dict(params_from_jax(params, model=model), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    xt.requires_grad_(True)
    out = torch.sin(3.0 * model(xt)).sum()
    names = [k for k, _ in model.named_parameters()]
    got = torch.autograd.grad(out, [xt, *model.parameters()])
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    scale = max(1.0, float(np.abs(np.asarray(gx)).max()))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=1e-4, atol=2e-4 * scale)
    for k, g in zip(names, got[1:]):
        r = ref[k].numpy()
        np.testing.assert_allclose(
            g.numpy(), r, rtol=1e-4,
            atol=2e-4 * max(1.0, float(np.abs(r).max())), err_msg=k)
