"""Port of the fused NAFBlock forward (K1/K2) held against the JAX package.

The port's plain version of the kernels (``nafblock_fwd_reference``, and
``call_a``/``call_b`` on CPU tensors) must reproduce the JAX
``fused_nafblock`` run in Pallas interpret mode, in the whole-image and
the multi-tile configuration, at fp32 with atol 2e-4 / rtol 1e-4 (the
JAX package's own fused-vs-unfused tolerance). Inputs come from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.nafnet import NAFBlock as JaxNAFBlock
from lowlight_image_enhancement_tpu.ops.pallas.nafblock import (
    BlockConfig,
    fused_nafblock,
    make_block_config,
)
from lowlight_image_enhancement_tpu.ops.pallas.nafblock import (
    pack_params as jax_pack_params,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from lowlight_image_enhancement_tpu_torch.weights import block_state_from_jax

ATOL, RTOL = 2e-4, 1e-4


def _jax_block_params(c, x, seed=1):
    """Flax NAFBlock params with non-trivial beta/gamma/norms (zero-init
    beta/gamma would make the block an identity and hide bugs)."""
    params = dict(JaxNAFBlock(c).init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.default_rng(seed)
    params["beta"] = jnp.asarray(rng.normal(size=(c,)), jnp.float32)
    params["gamma"] = jnp.asarray(rng.normal(size=(c,)), jnp.float32)
    for name in ("norm1", "norm2"):
        params[name] = {
            "weight": jnp.asarray(rng.normal(size=(c,)) + 1.0, jnp.float32),
            "bias": jnp.asarray(rng.normal(size=(c,)), jnp.float32),
        }
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_fused(params, x_nhwc, cfg):
    n, h, w, c = x_nhwc.shape
    p = jax_pack_params(
        params["norm1"]["weight"], params["norm1"]["bias"],
        params["conv1"]["kernel"], params["conv1"]["bias"],
        params["conv2"]["kernel"], params["conv2"]["bias"],
        params["sca_conv"]["kernel"], params["sca_conv"]["bias"],
        params["conv3"]["kernel"], params["conv3"]["bias"],
        params["norm2"]["weight"], params["norm2"]["bias"],
        params["conv4"]["kernel"], params["conv4"]["bias"],
        params["conv5"]["kernel"], params["conv5"]["bias"],
        params["beta"], params["gamma"])
    xf = jnp.transpose(jnp.asarray(x_nhwc), (0, 3, 1, 2)).reshape(n, c, h * w)
    return np.asarray(fused_nafblock(xf, p, cfg))


def _port_block(params, c, fused=True):
    blk = NAFBlock(c, fused=fused)
    blk.load_state_dict(block_state_from_jax(params), strict=True)
    return blk


def _flat(x_nhwc):
    n, h, w, c = x_nhwc.shape
    return torch.from_numpy(
        np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)).reshape(n, c, h * w))


@pytest.mark.parametrize("tiled", [False, True])
def test_plain_fused_matches_jax_fused_nafblock(tiled):
    c, h, w, n = 8, 16, 24, 2
    x = np.random.default_rng(0).normal(size=(n, h, w, c)).astype(np.float32)
    params = _jax_block_params(c, x)
    cfg = (BlockConfig(h, w, 4, c, 2 * c, 2 * c, 1, 2, 1, 1e-6, True)
           if tiled else make_block_config(h, w, c, 2, 2))
    assert cfg is not None and (cfg.th < h) == tiled
    ref = _jax_fused(params, x, cfg)
    with torch.no_grad():
        got = ops.nafblock_fwd_reference(
            _flat(x), _port_block(params, c).packed(), (h, w))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_sca_global_mean_spans_tiles():
    """Top half bright, bottom half dark: a per-tile SCA mean would differ
    from the whole-image one the JAX tiled kernel accumulates."""
    c, h, w, n = 8, 16, 8, 1
    rng = np.random.default_rng(3)
    x = np.zeros((n, h, w, c), np.float32)
    x[:, : h // 2] = rng.uniform(1, 2, (n, h // 2, w, c))
    x[:, h // 2 :] = rng.uniform(-0.1, 0.1, (n, h // 2, w, c))
    params = _jax_block_params(c, x)
    cfg = BlockConfig(h, w, 4, c, 2 * c, 2 * c, 1, 2, 1, 1e-6, True)
    ref = _jax_fused(params, x, cfg)
    with torch.no_grad():
        got = ops.nafblock_fwd(_flat(x), _port_block(params, c).packed(),
                               (h, w))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_eager_block_matches_plain_fused_function():
    c, h, w, n = 8, 12, 20, 2
    x = np.random.default_rng(5).normal(size=(n, h, w, c)).astype(np.float32)
    params = _jax_block_params(c, x, seed=7)
    blk = _port_block(params, c, fused=False)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        eager = blk(xt).reshape(n, c, h * w)
        fused = ops.nafblock_fwd_reference(_flat(x), blk.packed(), (h, w))
    np.testing.assert_allclose(eager.numpy(), fused.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_pack_params_are_views():
    blk = NAFBlock(8)
    p = blk.packed()
    assert p["W1"].shape == (16, 8) and p["kdw"].shape == (16, 9)
    assert p["W1"].data_ptr() == blk.conv1.weight.data_ptr()
    assert p["kdw"].data_ptr() == blk.conv2.weight.data_ptr()
    assert p["beta"].shape == (8,)
    # tap order kh*3+kw
    assert torch.equal(p["kdw"][:, 5], blk.conv2.weight[:, 0, 1, 2])


def test_cpu_dispatch_uses_plain_path_and_counts_no_launch():
    c, h, w = 8, 6, 10
    blk = NAFBlock(c)
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(1, c, h * w)).astype(np.float32))
    ops.reset_launch_counts()
    with torch.no_grad():
        g, sums = ops.call_a(x, blk.packed(), (h, w))
        g_ref, sums_ref = ops.plain_a(x, blk.packed(), (h, w))
        att = ops.sca_attention(sums, blk.packed(), h * w)
        out = ops.call_b(x, g, att, blk.packed())
        out_ref = ops.plain_b(x, g_ref, att, blk.packed())
    assert torch.equal(g, g_ref) and torch.equal(sums, sums_ref)
    assert torch.equal(out, out_ref)
    assert ops.call_a.launches == 0 and ops.call_b.launches == 0


def test_plain_bf16_rounds_operands_and_keeps_fp32_sums():
    """bf16 activations: g is stored in bf16, the SCA sums are fp32 sums of
    the unrounded gate (as the TPU kernel A sums before its store)."""
    c, h, w = 8, 6, 10
    blk = NAFBlock(c)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, c, h * w)).astype(np.float32))
    with torch.no_grad():
        g16, sums16 = ops.plain_a(x.bfloat16(), blk.packed(), (h, w))
        out16 = ops.nafblock_fwd_reference(x.bfloat16(), blk.packed(), (h, w))
    assert g16.dtype == torch.bfloat16 and out16.dtype == torch.bfloat16
    assert sums16.dtype == torch.float32
    assert not torch.equal(sums16, g16.float().sum(2))
