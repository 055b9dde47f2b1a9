"""The bf16 NAFBlock at channel counts that are no multiple of 16, tested on
the CPU:

- ``NAFBlockFunction`` grads (K3/K4 plain versions on the CPU) against
  ``jax.grad`` through the JAX ``fused_nafblock`` in Pallas interpret mode,
  in bf16 at C = 24, 40 and 12 (C = 8 is in
  ``test_torch_port_nafblock_bwd.py``), whole-image and multi-tile, 16x24,
  n=2: the block output and dx and all 18 parameter grads within 2^-6 *
  max|ref| (bf16 products round at other places in the two frameworks);
  the conv2 bias is zero, as the JAX kernel P2 leaves it out. The loss is
  ``sum(out * r)`` with a fixed numpy ``r``, so both backward passes get
  the same cotangent: under ``sum(sin(out))`` the cotangent ``cos(out)``
  of a bf16 ``out`` near 20 (one ulp: 0.125) differs between the two
  frameworks wherever their forward roundings do, which at C=40 moved dx
  by 7 % of max|dx| while the same cotangent gives 0.4 %;
- the route: at every C % 4 == 0 of {4, 8, 12, 24, 40, 72, 1024} (and
  F = C, 2C) a bf16 K3 and K4 get either a tensor-core tile or the FMA
  route with a tile that fits (``p1_geometry`` / ``p1_fma_pixels``,
  ``p2_geometry`` / ``p2_fma_pixels``): tensor cores exactly where C (and
  F) are multiples of 16, a refusal only where nothing fits (K3 at
  C=1024, F=2048); fp32 always takes the FMA route;
- the FMA route's shared-memory arithmetic (``(4C + 3F)`` and ``4C`` fp32
  rows of a pixel tile) at padded and odd C;
- the FMA route's matrix operands (``p1_operands(..., mma=False)``): fp32
  holding the bf16 values, ``plain_p1`` on them equal bit for bit.
Inputs come from numpy seeds.
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

H, W, N = 16, 24, 2
ROUTE_C = [4, 8, 12, 24, 40, 72, 1024]


def _jax_block_params(c, x, seed):
    """Flax NAFBlock params with non-trivial beta/gamma/norms (conv2 bias
    zero)."""
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


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("c", [24, 40, 12])
def test_bf16_block_grads_match_jax_fused_vjp(c, tiled):
    x = np.random.default_rng(c).normal(size=(N, H, W, c)).astype(np.float32)
    params = _jax_block_params(c, x, seed=c + 1)
    assert not np.any(params["conv2"]["bias"])
    cfg = (BlockConfig(H, W, 4, c, 2 * c, 2 * c, 1, 2, 1, 1e-6, True)
           if tiled else make_block_config(H, W, c, 2, 2))
    assert cfg is not None and (cfg.th < H) == tiled

    r = np.random.default_rng(c + 2).normal(size=(N, c, H * W)).astype(
        np.float32)

    def loss(p, xf):
        out = fused_nafblock(xf, _jax_pack(p), cfg)
        return jnp.sum(out.astype(jnp.float32) * r)

    xf = np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(N, c, H * W)
    xb = jnp.asarray(xf, jnp.bfloat16)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, xb)
    ref_p = block_state_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    ref = {"out": np.asarray(fused_nafblock(xb, _jax_pack(params), cfg),
                             np.float32),
           "dx": np.asarray(gx, np.float32),
           **{k: v.numpy() for k, v in ref_p.items()}}

    blk = NAFBlock(c)
    blk.load_state_dict(block_state_from_jax(params), strict=True)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    out = ops.nafblock_fwd(xt, blk.packed(), (H, W))
    names = [k for k, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out.float() * torch.from_numpy(r)).sum(),
                                [xt, *blk.parameters()])
    assert out.dtype == grads[0].dtype == torch.bfloat16
    got = {"out": out.detach().float().numpy(),
           "dx": grads[0].float().numpy(),
           **{k: g.numpy() for k, g in zip(names, grads[1:])}}
    assert set(got) == set(ref) and len(got) == 20
    for k, g in got.items():
        scale = float(np.abs(ref[k]).max())
        err = float(np.abs(g - ref[k]).max())
        assert err <= 2.0 ** -6 * scale, (k, err, scale)


@pytest.mark.parametrize("c", ROUTE_C)
def test_every_c_of_the_forward_gets_a_backward_route(c):
    n, side = 2, 64
    s = side * side
    mma = c % 16 == 0
    for f in (c, 2 * c):
        tile, grid = ops.p1_geometry(torch.bfloat16, n, c, f, s)
        assert ops.p1_geometry(torch.float32, n, c, f, s) == (0, 0)
        if (c, f) == (1024, 2048):
            # the one refusal: K3 fits in shared memory on neither route
            assert tile == 0 and ops.p1_fma_pixels(c, f) == 0
        elif mma:
            assert tile in ops.P1_TILES and 1 <= grid <= -(-s // tile)
        else:
            assert (tile, grid) == (0, 0) and ops.p1_fma_pixels(c, f) > 0
    tile, grid, dw = ops.p2_geometry(torch.bfloat16, n, c, side, side)
    if mma:
        assert tile in ops.P1_TILES and grid >= 1 and dw >= 1
    else:
        assert (tile, grid, dw) == (0, 0, 0) and ops.p2_fma_pixels(c) > 0
    assert ops.p2_geometry(torch.float32, n, c, side, side) == (0, 0, 0)
    # the forward takes the same route: K1 and K2 on the tensor cores
    # exactly where K3 and K4 are
    assert (ops.k1_geometry(torch.bfloat16, n, c, side, side)[0] > 0) == mma
    assert (ops.k2_geometry(torch.bfloat16, n, c, c, s)[0] > 0) == mma


@pytest.mark.parametrize("c,f,p1,p2", [
    (4, 4, 32, 32), (8, 16, 32, 32), (12, 12, 32, 32), (72, 144, 32, 32),
    (260, 260, 16, 32), (900, 900, 8, 16), (1028, 1028, 8, 8),
    (1032, 1032, 0, 8), (3600, 3600, 0, 0)])
def test_fma_route_shared_memory(c, f, p1, p2):
    assert ops.p1_fma_pixels(c, f) == p1
    assert ops.p2_fma_pixels(c) == p2
    if p1:
        assert (4 * c + 3 * f) * p1 * 4 <= ops.P1_SMEM_LIMIT
        if p1 < 32:
            assert (4 * c + 3 * f) * 2 * p1 * 4 > ops.P1_SMEM_LIMIT
    if p2:
        assert 4 * c * p2 * 4 <= ops.P1_SMEM_LIMIT


def test_fma_route_matrix_operands_keep_the_bits():
    c, f, s = 24, 48, 35
    rng = np.random.default_rng(5)
    blk = NAFBlock(c, ffn_expand=2 * f // c)
    p = ops.rounded_matrices(blk.packed(), torch.bfloat16)
    handed = dict(zip(ops._B_PARAMS,
                      ops.p1_operands(p, torch.bfloat16, mma=False)))
    for k, t in handed.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), k
        if k in ("W3", "W4", "W5"):
            assert torch.equal(t, p[k].float()), k
    x, g, dout = (torch.from_numpy(rng.standard_normal((2, c, s)).astype(
        np.float32)).bfloat16() for _ in range(3))
    att = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32))
    dz, da, grads = ops.plain_p1(x, g, dout, att, p)
    dz_h, da_h, grads_h = ops.plain_p1(x, g, dout, att, handed)
    assert torch.equal(dz, dz_h) and torch.equal(da, da_h)
    for k in grads:
        assert torch.equal(grads[k], grads_h[k]), k


# C % 4 != 0: the FMA kernels read the matrices' rows as float4, so the
# rows are zero-padded to a multiple of 4 once per block forward
# (ops.padded_matrices); the plain versions take padded or unpadded
# matrices alike.
ODD_C = [6, 10]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ffn", [2, 4], ids=["F=C", "F=2C"])
@pytest.mark.parametrize("c", ODD_C)
def test_padded_matrices_give_the_plain_k1_k4_results(c, ffn, dt):
    h, w = 10, 12
    rng = np.random.default_rng(c * ffn)
    blk = NAFBlock(c, ffn_expand=ffn)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.from_numpy(rng.normal(
                0, 0.5, tuple(prm.shape)).astype(np.float32)))
    p = ops.rounded_matrices(blk.packed(), dt)
    pp = ops.padded_matrices(p)
    f = c * ffn // 2
    assert {k: tuple(pp[k].shape) for k in ("W1", "W3", "W4", "W5")} == {
        "W1": (2 * c, ops.row_pitch(c)), "W3": (c, ops.row_pitch(c)),
        "W4": (2 * f, ops.row_pitch(c)), "W5": (c, ops.row_pitch(f))}
    for k in ("W1", "W3", "W4", "W5"):
        cols = p[k].shape[1]
        assert torch.equal(pp[k][:, :cols], p[k])
        assert not torch.any(pp[k][:, cols:])
    assert ops.padded_matrices(pp) is pp
    rnd = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))
    x, dout = rnd(2, c, h * w).to(dt), rnd(2, c, h * w).to(dt)
    att, dgc = rnd(2, c), rnd(2, c)
    same = lambda a, b: torch.equal(a, b)
    g, sums = ops.plain_a(x, p, (h, w))
    g_p, sums_p = ops.plain_a(x, pp, (h, w))
    assert same(g, g_p) and same(sums, sums_p)
    assert same(ops.plain_b(x, g, att, p), ops.plain_b(x, g, att, pp))
    dz, da, grads = ops.plain_p1(x, g, dout, att, p)
    dz_p, da_p, grads_p = ops.plain_p1(x, g, dout, att, pp)
    assert same(dz, dz_p) and same(da, da_p)
    dx, first = ops.plain_p2(x, dz, dgc, att, p, (h, w))
    dx_p, first_p = ops.plain_p2(x, dz, dgc, att, pp, (h, w))
    assert same(dx, dx_p)
    for a, b in ((grads, grads_p), (first, first_p)):
        assert set(a) == set(b)
        for k in a:
            assert same(a[k], b[k]), k
            assert a[k].shape == (p[k].shape if k in p else a[k].shape)
    # the whole block through NAFBlockFunction: forward and every grad
    xt = x.clone().requires_grad_(True)
    out = ops.nafblock_fwd(xt, blk.packed(), (h, w))
    assert same(out.detach(), ops.nafblock_fwd_reference(x, p, (h, w)))
    gr = torch.autograd.grad((out.float() * dout.float()).sum(),
                             [xt, *blk.parameters()])
    assert all(gi is not None and gi.shape == t.shape
               for gi, t in zip(gr, [xt, *blk.parameters()]))


@pytest.mark.parametrize("c", ODD_C + [4, 8])
def test_check_cuda_takes_any_c(c):
    blk = NAFBlock(c)
    x = torch.zeros(2, c, 20)
    for names in (ops._A_PARAMS, ops._B_PARAMS, ops._P2_PARAMS):
        ops._check_cuda(x, ops.padded_matrices(blk.packed()), names)
    with pytest.raises(TypeError):
        ops._check_cuda(x.half(), blk.packed(), ops._A_PARAMS)


@pytest.mark.parametrize("c", ODD_C)
def test_fp32_block_grads_match_jax_at_c_not_multiple_of_4(c):
    x = np.random.default_rng(c).normal(size=(N, H, W, c)).astype(np.float32)
    params = _jax_block_params(c, x, seed=c + 1)
    cfg = make_block_config(H, W, c, 2, 2)
    assert cfg is not None
    r = np.random.default_rng(c + 2).normal(size=(N, c, H * W)).astype(
        np.float32)

    def loss(p, xf):
        return jnp.sum(fused_nafblock(xf, _jax_pack(p), cfg) * r)

    xf = jnp.asarray(np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(
        N, c, H * W))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, xf)
    ref = {"out": np.asarray(fused_nafblock(xf, _jax_pack(params), cfg)),
           "dx": np.asarray(gx),
           **{k: v.numpy() for k, v in block_state_from_jax(
               jax.tree_util.tree_map(np.asarray, gp)).items()}}
    blk = NAFBlock(c)
    blk.load_state_dict(block_state_from_jax(params), strict=True)
    xt = torch.from_numpy(np.asarray(xf)).requires_grad_(True)
    out = ops.nafblock_fwd(xt, blk.packed(), (H, W))
    names = [k for k, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [xt, *blk.parameters()])
    got = {"out": out.detach().numpy(), "dx": grads[0].numpy(),
           **{k: g.numpy() for k, g in zip(names, grads[1:])}}
    assert set(got) == set(ref) and len(got) == 20
    for k, g in got.items():
        scale = float(np.abs(ref[k]).max())
        assert float(np.abs(g - ref[k]).max()) <= 1e-4 * scale, k
