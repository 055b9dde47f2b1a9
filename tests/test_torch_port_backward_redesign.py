"""What the redesign of K6 (channel-LN backward, channels over threads) and
K4 (first-half backward, bf16 on the tensor cores) moved into Python,
tested on the CPU:

- the pixel tiles and grids chosen in Python (``ln_bwd_tile``,
  ``ln_bwd_grid``, ``p2_tile``, ``p2_grid``, ``p2_dw_grid``): every shape
  of ``chip_smoke.py``'s LN and backward phases gets a legal geometry that
  fits in shared memory, at most one round of blocks over the card, no
  more blocks than tiles, and at least 66 blocks (half the SMs of an H100)
  wherever N*H*W >= 1024;
- ``p2_tile`` refuses a C that is no multiple of 16 (one tensor-core step),
  which K4's FMA route takes instead (``p2_geometry``, ``p2_fma_pixels``);
- ``plain_ln_bwd`` against the JAX ``_bwd_call`` (Pallas interpret mode) at
  C=48 on a pixel count that is no multiple of 8 and at C=1024, and
  ``plain_p2`` against the JAX ``_call_p2`` at C=48 on a 12x20 image
  (a width that is no multiple of 8), whole-image and row-tiled, with the
  depthwise bias 0 (the JAX kernel leaves it out). Tolerances: the
  activation-type result within 1e-4 (fp32: summation order) or 2**-6
  (bf16: a rounding of an operand or of the stored result may land on the
  other side) of max|ref|; the fp32 weight grads of K6 within 1e-4 in
  either type; K4's grads at the activation type's tolerance (their bf16
  operands round at other places). Inputs come from numpy seeds.
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
HALF_THE_SMS = 66

# (N, C, H, W) of every shape of chip_smoke.py's LN phase and backward phase
LN_SHAPES = [(n, c, h, w) for n, c, h, w, _, _ in chip_smoke.LN_SHAPES]
BWD_SHAPES = [(chip_smoke.BATCH, c, s, s) for c, s, _ in chip_smoke.TRAIN_PATH]
BWD_SHAPES += [(chip_smoke.BATCH, chip_smoke.WIDE[0], chip_smoke.WIDE[1],
                chip_smoke.WIDE[1]),
               (chip_smoke.BATCH, chip_smoke.RAGGED[0], chip_smoke.RAGGED[1],
                chip_smoke.RAGGED[1]),
               tuple(chip_smoke.NAFSSR_BLOCK[:4])]


def _close(got, ref, tol, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,h,w", LN_SHAPES)
def test_k6_tile_and_grid_are_legal_and_fill_the_card(n, c, h, w):
    s = h * w
    tile = ln.ln_bwd_tile(n, c, s)
    assert tile in (32, 16, 8)
    cpt = ln.ln_bwd_channels(c, tile)
    assert cpt in (4, 8, 16, 32) and cpt * (256 // tile) >= c
    # registers, not shared memory, hold a thread's channels: at most 16
    # a thread wherever the tile is wider than 8
    assert tile == 8 or c * tile <= ln.LN_BWD_CHANNEL_PIXELS
    per_sm = ln.ln_bwd_blocks_per_sm(c, tile)
    grid = ln.ln_bwd_grid(n, c, s, tile)
    assert 1 <= grid <= -(-s // tile)          # what the kernel checks
    assert n * grid <= max(n, ln.SM_COUNT * per_sm)
    if n * s >= 1024:
        assert n * grid >= HALF_THE_SMS
    if tile > 8:                               # wider only if it fills
        assert n * -(-s // tile) >= ln.LN_FWD_BLOCKS


def test_k6_channels_per_thread_cover_every_c_up_to_1024():
    for c in range(1, ln.MAX_CHANNELS + 1):
        tile = ln.ln_bwd_tile(2, c, 4096)
        cpt = ln.ln_bwd_channels(c, tile)
        assert cpt and cpt * (256 // tile) >= c, c
        assert cpt == 4 or (cpt // 2) * (256 // tile) < c, c
    assert ln.ln_bwd_channels(2048, 8) == 0


@pytest.mark.parametrize("n,c,h,w", BWD_SHAPES)
def test_k4_tile_and_grids_are_legal_and_fill_the_card(n, c, h, w):
    s = h * w
    tile = ops.p2_tile(n, c, s)
    assert tile in ops.P1_TILES
    assert ops.p2_smem_bytes(c, tile) <= ops.P1_SMEM_LIMIT
    per_sm = ops.p2_blocks_per_sm(c, tile)
    assert 1 <= per_sm <= 4
    assert per_sm * (ops.p2_smem_bytes(c, tile) + 3072) <= ops.SM_SMEM
    grid = ops.p2_grid(n, c, s, tile)
    assert 1 <= grid <= -(-s // tile)          # what the kernel checks
    assert n * grid <= max(n, ops.SM_COUNT * per_sm)
    if n * s >= 1024:
        assert n * grid >= HALF_THE_SMS
    dw = ops.p2_dw_grid(n, c, h, w)
    th, tw = ops.P2_DW_TILE
    assert 1 <= dw <= -(-h // th) * -(-w // tw)
    assert n * c * dw <= max(n * c, ops.SM_COUNT * ops.P2_DW_BLOCKS_PER_SM)
    assert n * c * dw >= min(HALF_THE_SMS, n * c * -(-h // th) * -(-w // tw))


@pytest.mark.parametrize("c", [4, 8, 24, 40, 72])
def test_k4_tile_refuses_c_that_is_no_multiple_of_16(c):
    # no tensor-core tile: a bf16 K4 at such a C takes the FMA route, whose
    # back kernel fits the widest tile
    assert ops.p2_tile(2, c, 4096) == 0
    assert ops.p2_geometry(torch.bfloat16, 2, c, 64, 64) == (0, 0, 0)
    assert ops.p2_fma_pixels(c) == 32


def test_k4_tile_narrows_as_the_image_shrinks_and_fits_c1024():
    tiles = [ops.p2_tile(2, 64, s) for s in (65536, 4096, 1024, 256, 64)]
    assert tiles == sorted(tiles, reverse=True)
    assert ops.p2_tile(2, 1024, 1024) == 8
    assert ops.p2_tile(2, 4096, 1024) == 0     # no tile fits
    assert ops.p2_fma_pixels(4096) == 0        # nor on the FMA route


def test_k4_resident_weights_only_up_to_64_channels():
    ring = ops.P1_SLAB_BYTES
    assert ops.p2_smem_bytes(64, 8) == max(
        64 * 8 * 4 + 64 * 8 * 2 + 3 * 64 * 72 * 2,
        2 * 64 * 8 * 2 + 2 * 64 * 8 * 4 + 2 * 64 * 72 * 2)
    assert ops.p2_smem_bytes(128, 32) == max(
        128 * 32 * 4 + 128 * 40 * 2 + ring,
        2 * 128 * 40 * 2 + 2 * 128 * 32 * 4 + ring)
    for c in (16, 64, 128, 512):
        for tile in ops.P1_TILES:
            by_regs = ops.P2_BLOCKS_BY_REGISTERS[c <= 64, tile]
            assert ops.p2_blocks_per_sm(c, tile) <= by_regs


# ---------------------------------------------------------------------------
# K6: plain_ln_bwd against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c,s", [(2, 48, 7 * 13), (1, 1024, 96)],
                         ids=["c48_ragged", "c1024"])
def test_plain_ln_bwd_matches_jax_bwd_call(n, c, s, dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((n, c, s)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((n, c, s)).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bt = rng.standard_normal(c).astype(np.float32)
    _, xhat, rstd = ln.plain_ln_fwd(torch.from_numpy(x).to(TDT[dtype]),
                                    torch.from_numpy(wt),
                                    torch.from_numpy(bt), EPS)
    gt = torch.from_numpy(g).to(TDT[dtype])
    gx, gw, gb = ln.plain_ln_bwd(gt, xhat, rstd, torch.from_numpy(wt))
    assert gx.dtype == TDT[dtype] and gw.dtype == gb.dtype == torch.float32

    # the JAX kernel takes rows [N*S, C] in tiles of 256: pad with rows of
    # g = 0 (they add nothing to gw, gb) that are dropped again
    rows = lambda t: t.float().permute(0, 2, 1).reshape(n * s, c).numpy()
    pad = -(n * s) % jpl.TILE_R
    z = np.zeros((pad, c), np.float32)
    g_r = np.concatenate([rows(gt), z])
    xh_r = np.concatenate([rows(xhat), z])
    rs_r = np.concatenate([rstd.numpy().reshape(-1, 1),
                           np.ones((pad, 1), np.float32)])
    gx_j, gw_j, gb_j = jpl._bwd_call(jnp.asarray(g_r, JDT[dtype]),
                                     jnp.asarray(xh_r), jnp.asarray(rs_r),
                                     jnp.asarray(wt))
    _close(rows(gx), np.asarray(gx_j.astype(jnp.float32))[:n * s],
           TOL[dtype], "gx")
    _close(gw.numpy(), np.asarray(gw_j), 1e-4, "gw")
    _close(gb.numpy(), np.asarray(gb_j), 1e-4, "gb")


# ---------------------------------------------------------------------------
# K4: plain_p2 against the JAX kernel
# ---------------------------------------------------------------------------


def _first_half(c, seed):
    """K4's parameters as numpy fp32 (matrices ``[Cout, Cin]``, depthwise
    ``[2C, 9]``), depthwise bias 0."""
    rng = np.random.default_rng(seed)
    mat = lambda o, i: (rng.standard_normal((o, i)) / i ** 0.5).astype(
        np.float32)
    vec = lambda k, m=0.0: (m + 0.3 * rng.standard_normal(k)).astype(
        np.float32)
    return {"w1n": vec(c, 1.0), "b1n": vec(c), "W1": mat(2 * c, c),
            "b1": vec(2 * c), "kdw": mat(2 * c, 9) * 3 ** 0.5,
            "bk": np.zeros(2 * c, np.float32), "W3": mat(c, c),
            "beta": vec(c)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_plain_p2_matches_jax_call_p2_at_c48_on_12x20(tiled, dtype):
    n, c, h, w = 2, 48, 12, 20
    s = h * w
    pn = _first_half(c, 13)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((n, c, s)).astype(np.float32)
    dz = rng.standard_normal((n, c, s)).astype(np.float32)
    dgc = (0.1 * rng.standard_normal((n, c))).astype(np.float32)
    att = rng.standard_normal((n, c)).astype(np.float32)

    cfg = (jnb.BlockConfig(h, w, 4, c, 2 * c, 2 * c, 1, 2, 1, EPS, True)
           if tiled else jnb.make_block_config(h, w, c, 2, 2, EPS))
    assert cfg is not None and cfg.interpret and (cfg.th < h) == tiled
    pj = {k: jnp.asarray(v if v.ndim == 2 else v[:, None])
          for k, v in pn.items() if k != "bk"}
    xj, dzj = (jnp.asarray(a, JDT[dtype]) for a in (x, dz))
    dx_j, dW1, db1, dw1n, db1n, dkdw, dbk = jnb._call_p2(
        xj, dzj, jnb._pern_wrap(jnp.asarray(dgc)),
        jnb._pern_wrap(jnp.asarray(att)), pj, cfg, JDT[dtype])
    ref = {"W1": dW1, "b1": db1, "w1n": dw1n, "b1n": db1n, "kdw": dkdw,
           "bk": dbk}

    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    xt, dzt = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, dz))
    dx, grads = ops.plain_p2(xt, dzt, torch.from_numpy(dgc),
                             torch.from_numpy(att), pt, (h, w), EPS)
    assert dx.dtype == TDT[dtype]
    assert set(grads) == set(ref)

    tol = TOL[dtype]
    _close(dx.float().numpy(), np.asarray(dx_j.astype(jnp.float32)), tol,
           "dx")
    for k, r in ref.items():
        assert grads[k].dtype == torch.float32
        _close(grads[k].numpy(), np.asarray(r).reshape(grads[k].shape), tol,
               f"d{k}")
