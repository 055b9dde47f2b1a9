"""What the redesign of K1 and K2 (the NAFBlock forward, bf16 on the tensor
cores) moved into Python, tested on the CPU:

- the pixel tiles and grids chosen in Python (``k1_geometry``,
  ``k2_geometry``): every shape of ``chip_smoke.py``'s forward and backward
  phases gets a legal geometry that fits in shared memory, at most one
  round of blocks over the card, no more blocks than tiles, and at least
  66 blocks (half the SMs of an H100) wherever N*H*W >= 1024;
- the route: C (and F) a multiple of 16 gets a tile (the tensor-core
  kernels: bf16 products in bf16, 3xTF32 in fp32), C % 16 != 0 gets none
  in either dtype (the FMA kernels of the first port);
- ``plain_a``, its two stages ``plain_a_front`` -> ``plain_a_dw`` composed,
  and ``plain_b`` against the JAX ``_call_a`` / ``_call_b`` (Pallas
  interpret mode) at C=48 on a 12x20 image, whole-image and row-tiled, in
  fp32 and bf16, with a nonzero depthwise bias (the JAX kernel A adds it).
  Tolerances: within 1e-4 (fp32: summation order) or 2**-6 (bf16: a
  rounding of an operand or of the stored result may land on the other
  side) of max|ref|, for g and out and for the SCA sums alike;
- the repair: a ``NAFBlock(c, dw_expand=1)`` runs the module graph (the
  JAX package leaves such a block unfused), launches no K1/K2, and matches
  the JAX unfused block with bridged weights.

Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lowlight_image_enhancement_tpu.models.nafnet import NAFBlock as JaxNAFBlock
from lowlight_image_enhancement_tpu.ops.pallas import nafblock as jnb
from lowlight_image_enhancement_tpu_torch.models import nafnet
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from lowlight_image_enhancement_tpu_torch.weights import block_state_from_jax

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-6
HALF_THE_SMS = 66

# (N, C, H, W) of every shape of chip_smoke.py's forward and backward phases
SHAPES = [(chip_smoke.BATCH, c, s, s)
          for c, s, _ in chip_smoke.MAIN_PATH + chip_smoke.TRAIN_PATH]
SHAPES += [(chip_smoke.BATCH, chip_smoke.WIDE[0], chip_smoke.WIDE[1],
            chip_smoke.WIDE[1]),
           (chip_smoke.BATCH, chip_smoke.RAGGED[0], chip_smoke.RAGGED[1],
            chip_smoke.RAGGED[1]),
           tuple(chip_smoke.NAFSSR_BLOCK[:4])]


def _close(got, ref, tol, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _fills_the_card(n, s, tile, grid, per_sm):
    assert 1 <= grid <= -(-s // tile)          # what the kernel checks
    assert n * grid <= max(n, ops.SM_COUNT * per_sm)
    if n * s >= 1024:
        assert n * grid >= HALF_THE_SMS


# ---------------------------------------------------------------------------
# geometry and route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_k1_tile_and_grids_are_legal_and_fill_the_card(n, c, h, w):
    s = h * w
    tile, grid, dw = ops.k1_geometry(torch.bfloat16, n, c, h, w)
    assert tile in ops.P1_TILES
    smem = ops.k1_smem_bytes(c, tile)
    assert smem <= ops.P1_SMEM_LIMIT
    per_sm = ops.k1_blocks_per_sm(c, tile)
    assert 1 <= per_sm <= 8           # 64 warps an SM, 8 a block
    assert per_sm * (smem + ops.FWD_STATIC_SMEM + 1024) <= ops.SM_SMEM
    _fills_the_card(n, s, tile, grid, per_sm)
    th, tw = ops.K1_DW_TILE
    tiles = -(-h // th) * -(-w // tw)
    assert 1 <= dw <= tiles
    assert n * c * dw <= max(n * c, ops.SM_COUNT * ops.K1_DW_BLOCKS_PER_SM)
    assert n * c * dw >= min(HALF_THE_SMS, n * c * tiles)


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_k2_tile_and_grid_are_legal_and_fill_the_card(n, c, h, w):
    s = h * w
    tile, grid = ops.k2_geometry(torch.bfloat16, n, c, c, s)
    assert tile in ops.P1_TILES
    smem = ops.k2_smem_bytes(c, c, tile)
    assert smem <= ops.P1_SMEM_LIMIT
    per_sm = ops.k2_blocks_per_sm(c, c, tile)
    assert 1 <= per_sm <= 8           # 64 warps an SM, 8 a block
    assert per_sm * (smem + ops.FWD_STATIC_SMEM + 1024) <= ops.SM_SMEM
    _fills_the_card(n, s, tile, grid, per_sm)


def test_k1_tile_is_the_widest_that_gives_half_the_sms_a_block():
    assert ops.k1_tile(2, 32, 384 * 384) == 32
    assert ops.k1_tile(2, 256, 48 * 48) == 32     # 144 blocks
    assert ops.k1_tile(2, 512, 24 * 24) == 16     # 72 blocks; 32 gives 36
    assert ops.k1_tile(2, 64, 20 * 20) == 8       # none gives 66: narrowest
    assert ops.k1_tile(2, 1024, 32 * 32) == 16    # 32 does not fit
    assert ops.k1_smem_bytes(1024, 32) > ops.P1_SMEM_LIMIT


class _Built:
    """Stands in for the built ``nafblock_fwd`` library: every kernel
    reports ``per_sm`` blocks per SM, and the calls are counted."""

    def __init__(self, per_sm):
        self.per_sm, self.calls = per_sm, 0

    def _count(self, *args):
        self.calls += 1
        return self.per_sm

    nafblk_a_mma_blocks_per_sm = nafblk_a_dw_blocks_per_sm = _count
    nafblk_b_mma_blocks_per_sm = _count


@pytest.mark.parametrize("per_sm", [1, 2])
def test_built_geometry_reads_the_built_kernels_once(monkeypatch, per_sm):
    """On CUDA the wrappers take blocks per SM from the built kernels
    (once per shape); with one or two blocks an SM the grids stay one
    round of blocks and the K1 tile does not change."""
    lib = _Built(per_sm)
    monkeypatch.setattr(ops._build, "load", lambda name="nafblock_fwd": lib)
    monkeypatch.setattr(ops, "_BUILT_PER_SM", {})
    n, c, h, w = 2, 64, 96, 96
    s = h * w
    tile, grid, dw = ops.k1_geometry(torch.bfloat16, n, c, h, w, built=True)
    assert tile == ops.k1_tile(n, c, s)
    assert n * grid <= ops.SM_COUNT * per_sm and 1 <= grid <= -(-s // tile)
    assert n * c * dw <= max(n * c, ops.SM_COUNT * per_sm)
    tile2, grid2 = ops.k2_geometry(torch.bfloat16, n, c, c, s, built=True)
    assert n * grid2 <= ops.SM_COUNT * per_sm
    calls = lib.calls
    assert ops.k1_geometry(torch.bfloat16, n, c, h, w, built=True) == (
        tile, grid, dw)
    assert ops.k2_geometry(torch.bfloat16, n, c, c, s, built=True) == (
        tile2, grid2)
    assert lib.calls == calls


def test_built_geometry_raises_when_no_block_fits(monkeypatch):
    monkeypatch.setattr(ops._build, "load",
                        lambda name="nafblock_fwd": _Built(-1))
    monkeypatch.setattr(ops, "_BUILT_PER_SM", {})
    with pytest.raises(RuntimeError, match="no block fits"):
        ops.k2_geometry(torch.bfloat16, 2, 64, 64, 1024, built=True)


def test_k2_tile_narrows_to_8_pixels_at_c1024():
    """At 2x1024@32^2 q (fp32 [2F][tile]) and z leave room for 8 pixels."""
    assert ops.k2_geometry(torch.bfloat16, 2, 1024, 1024, 1024)[0] == 8
    assert ops.k2_smem_bytes(1024, 1024, 16) > ops.P1_SMEM_LIMIT


def test_weights_resident_only_up_to_64_channels():
    ring = ops.P1_SLAB_BYTES
    assert ops.k1_smem_bytes(64, 32) == 64 * 32 * 4 + 64 * 40 * 2 + \
        2 * 64 * 72 * 2
    assert ops.k1_smem_bytes(128, 32) == 128 * 32 * 4 + 128 * 40 * 2 + ring
    assert ops.k2_smem_bytes(64, 64, 8) == 64 * 8 * 2 + \
        (192 * 72 + 64 * 72) * 2 + 192 * 8 * 4
    assert ops.k2_smem_bytes(128, 128, 16) == 128 * 24 * 2 + ring + \
        384 * 16 * 4


@pytest.mark.parametrize("c", [16, 32, 48, 64, 512, 1024])
def test_bf16_with_c_a_multiple_of_16_takes_the_tensor_cores(c):
    tile, grid, dw = ops.k1_geometry(torch.bfloat16, 2, c, 32, 32)
    assert tile in ops.P1_TILES and grid >= 1 and dw >= 1
    tile, grid = ops.k2_geometry(torch.bfloat16, 2, c, c, 1024)
    assert tile in ops.P1_TILES and grid >= 1


@pytest.mark.parametrize("dtype,c", [(torch.float32, 24), (torch.float32, 40),
                                     (torch.float32, 8), (torch.bfloat16, 8),
                                     (torch.bfloat16, 24),
                                     (torch.bfloat16, 40)])
def test_fp32_and_bf16_off_16_take_the_fma_kernels(dtype, c):
    assert ops.k1_geometry(dtype, 2, c, 32, 32) == (0, 0, 0)
    assert ops.k2_geometry(dtype, 2, c, c, 1024) == (0, 0)


@pytest.mark.parametrize("c", [32, 48])
def test_fp32_at_c_a_multiple_of_16_takes_the_tensor_cores(c):
    # 3xTF32 (csrc/nafblock_fwd_tf32.cuh); the FMA kernels only off 16
    tile, grid, dw = ops.k1_geometry(torch.float32, 2, c, 32, 32)
    assert tile in ops.P1_TILES and grid >= 1 and dw >= 1
    tile, grid = ops.k2_geometry(torch.float32, 2, c, c, 1024)
    assert tile in ops.P1_TILES and grid >= 1


def test_k2_with_f_off_16_takes_the_fma_kernel():
    assert ops.k2_geometry(torch.bfloat16, 2, 32, 24, 1024) == (0, 0)


def test_call_a_on_cpu_returns_the_plain_stages():
    rng = np.random.default_rng(5)
    pt = {k: torch.from_numpy(v) for k, v in _block(16, 6).items()}
    x = torch.from_numpy(rng.standard_normal((2, 16, 48)).astype(np.float32))
    g, sums, t = ops.call_a(x, pt, (6, 8), EPS, return_t=True)
    assert torch.equal(t, ops.plain_a_front(x, pt, EPS))
    g2, sums2 = ops.plain_a(x, pt, (6, 8), EPS)
    assert torch.equal(g, g2) and torch.equal(sums, sums2)


# ---------------------------------------------------------------------------
# plain_a (and its stages) and plain_b against the JAX kernels A and B
# ---------------------------------------------------------------------------


def _block(c, seed):
    """The block's kernel parameters as numpy fp32 (matrices
    ``[Cout, Cin]``, depthwise ``[2C, 9]``), every bias nonzero."""
    rng = np.random.default_rng(seed)
    mat = lambda o, i: (rng.standard_normal((o, i)) / i ** 0.5).astype(
        np.float32)
    vec = lambda k, m=0.0: (m + 0.3 * rng.standard_normal(k)).astype(
        np.float32)
    return {"w1n": vec(c, 1.0), "b1n": vec(c), "W1": mat(2 * c, c),
            "b1": vec(2 * c), "kdw": mat(2 * c, 9) * 3 ** 0.5,
            "bk": vec(2 * c), "W3": mat(c, c), "b3": vec(c),
            "w2n": vec(c, 1.0), "b2n": vec(c), "W4": mat(2 * c, c),
            "b4": vec(2 * c), "W5": mat(c, c), "b5": vec(c), "beta": vec(c),
            "gamma": vec(c)}


def _config(h, w, c, tiled):
    cfg = (jnb.BlockConfig(h, w, 4, c, 2 * c, 2 * c, 1, 2, 1, EPS, True)
           if tiled else jnb.make_block_config(h, w, c, 2, 2, EPS))
    assert cfg is not None and cfg.interpret and (cfg.th < h) == tiled
    return cfg


def _jax_params(pn):
    return {k: jnp.asarray(v if v.ndim == 2 else v[:, None])
            for k, v in pn.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_plain_a_and_its_stages_match_jax_call_a_at_c48_on_12x20(tiled,
                                                                  dtype):
    n, c, h, w = 2, 48, 12, 20
    pn = _block(c, 21)
    assert np.any(pn["bk"])
    x = np.random.default_rng(22).standard_normal((n, c, h * w)).astype(
        np.float32)
    g_j, m_j = jnb._call_a(jnp.asarray(x, JDT[dtype]), _jax_params(pn),
                           _config(h, w, c, tiled), JDT[dtype])

    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    xt = torch.from_numpy(x).to(TDT[dtype])
    g, sums = ops.plain_a(xt, pt, (h, w), EPS)
    t = ops.plain_a_front(xt, pt, EPS)
    assert t.dtype == torch.float32 and t.shape == (n, 2 * c, h * w)
    g2, sums2 = ops.plain_a_dw(t, pt, (h, w), TDT[dtype])
    assert torch.equal(g, g2) and torch.equal(sums, sums2)
    assert g.dtype == TDT[dtype] and sums.dtype == torch.float32

    tol = TOL[dtype]
    _close(g.float().numpy(), np.asarray(g_j.astype(jnp.float32)), tol, "g")
    _close(sums.numpy(), np.asarray(m_j)[:, :, 0], tol, "sums")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_plain_b_matches_jax_call_b_at_c48_on_12x20(tiled, dtype):
    n, c, h, w = 2, 48, 12, 20
    pn = _block(c, 23)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((n, c, h * w)).astype(np.float32)
    g = rng.standard_normal((n, c, h * w)).astype(np.float32)
    att = rng.standard_normal((n, c)).astype(np.float32)
    out_j = jnb._call_b(jnp.asarray(x, JDT[dtype]), jnp.asarray(g, JDT[dtype]),
                        jnb._pern_wrap(jnp.asarray(att)), _jax_params(pn),
                        _config(h, w, c, tiled), JDT[dtype])

    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    out = ops.plain_b(torch.from_numpy(x).to(TDT[dtype]),
                      torch.from_numpy(g).to(TDT[dtype]),
                      torch.from_numpy(att), pt, EPS)
    assert out.dtype == TDT[dtype]
    _close(out.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
           TOL[dtype], "out")


# ---------------------------------------------------------------------------
# the repair: a dw_expand != 2 block runs unfused, as in JAX
# ---------------------------------------------------------------------------


def test_dw_expand_1_block_runs_the_module_graph_and_matches_jax_unfused(
        monkeypatch):
    n, h, w, c = 2, 12, 20, 16
    x = np.random.default_rng(31).standard_normal((n, h, w, c)).astype(
        np.float32)
    net = JaxNAFBlock(c, dw_expand=1)
    params = dict(net.init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.default_rng(32)
    for name in ("beta", "gamma"):
        params[name] = jnp.asarray(rng.normal(size=(c,)), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = np.asarray(net.apply({"params": params}, x)).transpose(0, 3, 1, 2)

    blk = NAFBlock(c, dw_expand=1)
    assert blk.fused
    blk.load_state_dict(block_state_from_jax(params), strict=True)

    def fused_path(*args, **kwargs):
        raise AssertionError("a dw_expand=1 block reached NAFBlockFunction")

    monkeypatch.setattr(nafnet, "nafblock_fwd", fused_path)
    ops.reset_launch_counts()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        y = blk(xt)
        y_eager = blk.forward_eager(xt)
    assert ops.call_a.launches == 0 and ops.call_b.launches == 0
    assert torch.equal(y, y_eager)
    _close(y.numpy(), ref, 1e-4, "out")
