"""What the redesign of K3 (bf16, tensor cores) and K5 (channels over
threads) moved into Python, tested on the CPU:

- the bf16 weight operands the K3 wrapper hands to its kernel
  (``p1_operands``): ``plain_p1`` on them equals ``plain_p1`` on the
  fp32-carried parameters bit for bit; and the one rounding of the four
  matrices that ``NAFBlockFunction`` shares between its kernels
  (``rounded_matrices``): the block's output and every gradient keep
  their bits;
- the pixel tiles and the grid chosen in Python (``p1_tile``, ``p1_grid``,
  ``ln_fwd_tile``): every shape ``chip_smoke.py`` holds the kernels at
  gets a legal tile that fits in shared memory, and at least 66 blocks
  (half the SMs of an H100) wherever N*H*W >= 1024;
- ``plain_p1`` against the JAX ``_call_p1`` (Pallas interpret mode) and
  ``plain_ln_fwd`` against the JAX ``_fwd_call`` at a channel count that is
  no multiple of 32 (C=48) and a pixel count that is no multiple of 8:
  fp32 within 1e-4 and bf16 within 2**-6 of max|ref| (summation order; in
  bf16 a rounding of an operand or of the stored result may land on the
  other side). Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lowlight_image_enhancement_tpu.ops.pallas import layernorm as jpl
from lowlight_image_enhancement_tpu.ops.pallas import nafblock as jnb
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-6

# (N, C, H*W) of every shape of chip_smoke.py's backward phase
P1_SHAPES = [(chip_smoke.BATCH, c, s * s) for c, s, _ in chip_smoke.TRAIN_PATH]
P1_SHAPES += [(chip_smoke.BATCH, chip_smoke.WIDE[0], chip_smoke.WIDE[1] ** 2),
              (chip_smoke.BATCH, chip_smoke.RAGGED[0],
               chip_smoke.RAGGED[1] ** 2),
              (chip_smoke.NAFSSR_BLOCK[0], chip_smoke.NAFSSR_BLOCK[1],
               chip_smoke.NAFSSR_BLOCK[2] * chip_smoke.NAFSSR_BLOCK[3])]
LN_SHAPES = [(n, c, h * w) for n, c, h, w, _, _ in chip_smoke.LN_SHAPES]
HALF_THE_SMS = 66


def _second_half(c, f, seed):
    """K3's ten parameters as numpy fp32, matrices ``[Cout, Cin]``."""
    rng = np.random.default_rng(seed)
    mat = lambda o, i: (rng.standard_normal((o, i)) / i ** 0.5).astype(
        np.float32)
    vec = lambda k, m=0.0: (m + 0.3 * rng.standard_normal(k)).astype(
        np.float32)
    return {"W3": mat(c, c), "b3": vec(c), "w2n": vec(c, 1.0), "b2n": vec(c),
            "W4": mat(2 * f, c), "b4": vec(2 * f), "W5": mat(c, f),
            "b5": vec(c), "beta": vec(c), "gamma": vec(c)}


def _p1_inputs(n, c, s, seed):
    rng = np.random.default_rng(seed)
    x, g, dout = (rng.standard_normal((n, c, s)).astype(np.float32)
                  for _ in range(3))
    att = rng.standard_normal((n, c)).astype(np.float32)
    return x, g, dout, att


def _close(got, ref, tol, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("c", [16, 48])
def test_bf16_weight_operands_give_the_same_bits(c):
    n, s = 2, 35
    p = {k: torch.from_numpy(v) for k, v in _second_half(c, c, 1).items()}
    x, g, dout, att = (torch.from_numpy(a) for a in _p1_inputs(n, c, s, 2))
    x, g, dout = x.bfloat16(), g.bfloat16(), dout.bfloat16()
    handed = dict(zip(ops._B_PARAMS, ops.p1_operands(p, torch.bfloat16)))
    for k, t in handed.items():
        want = torch.bfloat16 if k in ("W3", "W4", "W5") else torch.float32
        assert t.dtype == want and t.is_contiguous(), k
    dz, da, grads = ops.plain_p1(x, g, dout, att, p)
    dz_h, da_h, grads_h = ops.plain_p1(x, g, dout, att, handed)
    assert torch.equal(dz, dz_h) and torch.equal(da, da_h)
    for k in grads:
        assert torch.equal(grads[k], grads_h[k]), k
    # in fp32 the wrapper hands over what it was given
    for k, t in zip(ops._B_PARAMS, ops.p1_operands(p, torch.float32)):
        assert t.dtype == torch.float32 and torch.equal(t, p[k]), k


@pytest.mark.parametrize("n,c,s", P1_SHAPES)
def test_k3_tile_is_legal_and_fills_the_card(n, c, s):
    tile = ops.p1_tile(n, c, c, s)
    assert tile in ops.P1_TILES
    assert ops.p1_smem_bytes(c, c, tile) <= ops.P1_SMEM_LIMIT
    if n * s >= 1024:
        assert n * -(-s // tile) >= HALF_THE_SMS


@pytest.mark.parametrize("n,c,s", P1_SHAPES)
def test_k3_grid_is_one_round_of_blocks_over_the_card(n, c, s):
    tile = ops.p1_tile(n, c, c, s)
    per_sm = ops.p1_blocks_per_sm(c, c, tile)
    assert 1 <= per_sm <= 3
    assert per_sm * (ops.p1_smem_bytes(c, c, tile) + 3072) <= ops.SM_SMEM
    grid = ops.p1_grid(n, c, c, s, tile)
    assert 1 <= grid <= -(-s // tile)          # what the kernel checks
    assert n * grid <= max(n, ops.SM_COUNT * per_sm)
    if n * s >= 1024:
        assert n * grid >= HALF_THE_SMS


def test_rounded_matrices_are_shared_by_the_block_without_a_changed_bit():
    c, h, w = 16, 5, 7
    rng = np.random.default_rng(6)
    first = {"w1n": 1 + 0.3 * rng.standard_normal(c),
             "b1n": 0.3 * rng.standard_normal(c),
             "W1": rng.standard_normal((2 * c, c)) / c ** 0.5,
             "b1": 0.3 * rng.standard_normal(2 * c),
             "kdw": rng.standard_normal((2 * c, 9)) / 3,
             "bk": 0.3 * rng.standard_normal(2 * c),
             "Wsca": rng.standard_normal((c, c)) / c ** 0.5,
             "bsca": 0.3 * rng.standard_normal(c)}
    p = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in {**first, **_second_half(c, c, 7)}.items()}
    low = ops.rounded_matrices(p, torch.bfloat16)
    assert ops.rounded_matrices(p, torch.float32) is p
    for k, t in low.items():
        if k in ("W1", "W3", "W4", "W5"):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, p[k].to(torch.bfloat16)), k
        else:
            assert t is p[k], k

    x = torch.from_numpy(rng.standard_normal((2, c, h * w)).astype(
        np.float32)).bfloat16()
    dout = torch.from_numpy(rng.standard_normal((2, c, h * w)).astype(
        np.float32)).bfloat16()
    # the block through NAFBlockFunction (matrices rounded once) ...
    xg = x.clone().requires_grad_(True)
    views = [p[k].clone().requires_grad_(True) for k in ops.PARAM_ORDER]
    out = ops.nafblock_fwd(xg, dict(zip(ops.PARAM_ORDER, views)), (h, w))
    got = torch.autograd.grad(out, [xg, *views], dout)
    # ... and its kernels' plain versions on the parameters as given
    g, sums = ops.plain_a(x, p, (h, w))
    att = ops.sca_attention(sums, p, h * w)
    assert torch.equal(out, ops.plain_b(x, g, att, p))
    dz, da, grads = ops.plain_p1(x, g, dout, att, p)
    dwsca, dbsca, dgc = ops.sca_backward(da, sums / (h * w), p, h * w)
    dx, more = ops.plain_p2(x, dz, dgc, att, p, (h, w))
    grads.update(more, Wsca=dwsca, bsca=dbsca)
    assert torch.equal(got[0], dx)
    for k, gk in zip(ops.PARAM_ORDER, got[1:]):
        assert gk.dtype == torch.float32
        assert torch.equal(gk, grads[k].to(torch.float32)), k


def test_k3_tile_refuses_what_the_kernel_cannot_take():
    # C or F no multiple of 16: no tensor-core tile, the FMA route instead
    assert ops.p1_tile(2, 40, 40, 4096) == 0      # C no multiple of 16
    assert ops.p1_tile(2, 32, 24, 4096) == 0      # F no multiple of 16
    for c, f in ((40, 40), (32, 24), (4, 4), (8, 16), (24, 48), (72, 72)):
        assert ops.p1_geometry(torch.bfloat16, 2, c, f, 4096) == (0, 0)
        assert ops.p1_fma_pixels(c, f) == 32
    assert ops.p1_tile(2, 2048, 2048, 1024) == 0  # no tile fits
    assert ops.p1_fma_pixels(2048, 2048) == 0     # nor on the FMA route
    # the tile only narrows as the image shrinks
    tiles = [ops.p1_tile(2, 64, 64, s) for s in (4096, 2048, 1024, 512, 64)]
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("n,c,s", LN_SHAPES)
def test_k5_tile_is_legal_and_fills_the_card(n, c, s):
    tile = ln.ln_fwd_tile(n, s)
    assert tile in (32, 16, 8)
    assert c * tile * 4 <= ops.P1_SMEM_LIMIT     # x tile as fp32 [C][tile]
    if n * s >= 1024:
        assert n * -(-s // tile) >= HALF_THE_SMS
    if tile > 8:                                 # wider only if it fills
        assert n * -(-s // tile) >= ln.LN_FWD_BLOCKS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_p1_matches_jax_call_p1_at_c48_ragged(dtype):
    n, c, h, w = 2, 48, 5, 7
    s = h * w
    pn = _second_half(c, c, 3)
    x, g, dout, att = _p1_inputs(n, c, s, 4)

    cfg = jnb.make_block_config(h, w, c, 2, 2, EPS)
    assert cfg is not None and cfg.th == h and cfg.interpret
    pj = {k: jnp.asarray(v if v.ndim == 2 else v[:, None])
          for k, v in pn.items()}
    xj, gj, dj = (jnp.asarray(a, JDT[dtype]) for a in (x, g, dout))
    (dz_j, da_j, dW3, db3, dw2n, db2n, dW4, db4, dW5, db5, dbeta,
     dgamma) = jnb._call_p1(xj, gj, dj, jnb._pern_wrap(jnp.asarray(att)), pj,
                            cfg, JDT[dtype])
    ref = {"W3": dW3, "b3": db3, "w2n": dw2n, "b2n": db2n, "W4": dW4,
           "b4": db4, "W5": dW5, "b5": db5, "beta": dbeta, "gamma": dgamma}

    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    xt, gt, dt = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, g, dout))
    dz, da, grads = ops.plain_p1(xt, gt, dt, torch.from_numpy(att), pt, EPS)
    assert dz.dtype == TDT[dtype] and da.dtype == torch.float32

    tol = TOL[dtype]
    _close(dz.float().numpy(), np.asarray(dz_j.astype(jnp.float32)), tol,
           "dz")
    _close(da.numpy(), np.asarray(da_j[:, :, 0]), tol, "da")
    for k, r in ref.items():
        _close(grads[k].numpy(), np.asarray(r).reshape(grads[k].shape), tol,
               f"d{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ln_fwd_matches_jax_fwd_call_at_c48_ragged(dtype):
    n, c, s = 2, 48, 7 * 13
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((n, c, s)) * 2 + 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bt = rng.standard_normal(c).astype(np.float32)

    # the JAX kernel takes rows [N*S, C] in tiles of 256: pad with rows that
    # are dropped again (the norm is per row)
    rows = np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(n * s, c)
    padded = np.concatenate(
        [rows, np.ones((-len(rows) % jpl.TILE_R, c), np.float32)])
    y_j, xhat_j, rstd_j = jpl._fwd_call(jnp.asarray(padded, JDT[dtype]),
                                        jnp.asarray(wt), jnp.asarray(bt), EPS)

    y, xhat, rstd = ln.plain_ln_fwd(torch.from_numpy(x).to(TDT[dtype]),
                                    torch.from_numpy(wt),
                                    torch.from_numpy(bt), EPS)
    as_rows = lambda t: t.float().permute(0, 2, 1).reshape(n * s, c).numpy()
    _close(as_rows(y), np.asarray(y_j.astype(jnp.float32))[:n * s],
           TOL[dtype], "y")
    _close(as_rows(xhat), np.asarray(xhat_j)[:n * s], 1e-4, "xhat")
    _close(rstd.numpy().reshape(-1), np.asarray(rstd_j)[:n * s, 0], 1e-4,
           "rstd")
