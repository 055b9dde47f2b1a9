"""K1 and K2 in fp32 on the tensor cores (3xTF32), tested on the CPU:

- the route's geometry (``k1_geometry`` / ``k2_geometry`` with dtype
  fp32, ``k1_smem_bytes`` / ``k2_smem_bytes`` / ``*_blocks_per_sm`` in
  their fp32 forms): at every shape of ``chip_smoke.py``'s forward widths
  and ``BACKWARD_WIDTHS`` the tile is legal, fits ``P1_SMEM_LIMIT`` and the
  grid is one round of blocks that fills the card; C or F % 16 != 0 gets
  no tile (the FMA kernels); K2 at C = F = 1024 gets 8 pixels; the weights
  are resident only up to 64 channels, and above no shared memory goes to
  them; the fp32 and bf16 forms differ only where the dtype does; on CUDA
  the wrappers ask the built fp32 kernels for their blocks per SM;
- the numerics of the whole tile chain (``csrc/nafblock_fwd_tf32.cuh``): a
  numpy emulation of every product of K1 (conv1) and K2 (conv3, conv4,
  conv5) as the ``mma.m16n8k8`` TF32 chain of
  ``test_torch_port_fp32_tensor_cores.py``, LN and the gates in fp32, at
  C = 48 and 512 on seeded data with the residual scales of
  ``chip_smoke.py``: with 3xTF32 within ``chip_smoke.TOL[float32]`` (1e-4
  of max|ref|) of ``plain_a`` / ``plain_b``, with a single TF32 pass not;
- ``plain_a`` and ``plain_b`` against the JAX ``_call_a`` / ``_call_b``
  (Pallas interpret mode) in fp32 at C = 80 on a 12x20 image, whole-image
  and row-tiled: the side of the 64-channel boundary where the kernels
  read their weights from global memory (C = 48 is held in
  ``test_torch_port_forward_redesign.py``).

The kernels themselves run only on the card (``chip_smoke.py``'s forward
and backward phases hold them against the plain versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from lowlight_image_enhancement_tpu.ops.pallas import nafblock as jnb
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from test_torch_port_fp32_tensor_cores import mma_chain

F32 = torch.float32
BF16 = torch.bfloat16
EPS = 1e-6
TOL = chip_smoke.TOL[F32]

# (N, C, H, W) of chip_smoke.py's forward phase (the serving widths and
# C=1024) and of its backward phase (the training widths at N = 2 and 1,
# C=1024@32^2, the ragged 64@20^2, NAFSSR, NAFNetTPU's 1024@12^2)
SHAPES = [(chip_smoke.BATCH, c, s, s) for c, s, _ in chip_smoke.MAIN_PATH]
SHAPES += [(chip_smoke.BATCH, *chip_smoke.WIDE, chip_smoke.WIDE[1])]
SHAPES += [(n, c, h, w) for n, c, h, w, *_ in chip_smoke.BACKWARD_WIDTHS]


def _holds_one_round(n, s, tile, grid, per_sm):
    tiles = -(-s // tile)
    assert 1 <= grid <= tiles                       # what the kernel checks
    assert grid == ln.one_round(n, s, tile, per_sm)
    assert n * grid <= max(n, ln.SM_COUNT * per_sm)
    # every SM gets a block where the image has the tiles for it (less the
    # rounding of one round down to whole blocks per image)
    assert n * grid >= min(n * tiles, ln.SM_COUNT * per_sm - n + 1)


def _fits(smem, per_sm):
    assert smem <= ops.P1_SMEM_LIMIT
    assert 1 <= per_sm <= 8           # 64 warps an SM, 8 a block
    assert per_sm * (smem + ops.FWD_STATIC_SMEM + 1024) <= ops.SM_SMEM


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_fp32_k1_tile_is_legal_and_fills_the_card(n, c, h, w):
    s = h * w
    tile, grid, dw = ops.k1_geometry(F32, n, c, h, w)
    assert tile in ops.P1_TILES
    per_sm = ops.k1_blocks_per_sm(c, tile, dtype=F32)
    _fits(ops.k1_smem_bytes(c, tile, F32), per_sm)
    _holds_one_round(n, s, tile, grid, per_sm)
    # the depthwise kernel (g in fp32) takes the bf16 route's grid
    assert dw == ops.k1_dw_grid(n, c, h, w)


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_fp32_k2_tile_is_legal_and_fills_the_card(n, c, h, w):
    s = h * w
    tile, grid = ops.k2_geometry(F32, n, c, c, s)
    assert tile in ops.P1_TILES
    per_sm = ops.k2_blocks_per_sm(c, c, tile, dtype=F32)
    _fits(ops.k2_smem_bytes(c, c, tile, F32), per_sm)
    _holds_one_round(n, s, tile, grid, per_sm)


@pytest.mark.parametrize("c,f", [(8, 8), (8, 16), (12, 12), (24, 24),
                                 (24, 48), (40, 40), (72, 72), (16, 24),
                                 (48, 40)])
def test_fp32_tile_refused_at_c_or_f_no_multiple_of_16(c, f):
    # no tensor-core tile: such an fp32 K2 (and K1 at C % 16 != 0) takes
    # the FMA kernel
    assert ops.k2_geometry(F32, 2, c, f, 4096) == (0, 0)
    if c % 16:
        assert ops.k1_geometry(F32, 2, c, 64, 64) == (0, 0, 0)


def test_fp32_k2_takes_8_pixels_at_c1024():
    """At C = F = 1024 only 8 pixels fit: v|h2|wv [1024][8], z [1024][8]
    and q [2048][8] fp32 are 128 KB; 16 pixels would need 288 KB."""
    assert ops.k2_geometry(F32, 2, 1024, 1024, 1024)[0] == 8
    assert ops.k2_geometry(F32, 2, 1024, 1024, 144)[0] == 8
    assert ops.k2_smem_bytes(1024, 1024, 8, F32) == 128 * 1024
    assert ops.k2_smem_bytes(1024, 1024, 16, F32) == 288 * 1024
    assert ops.k2_smem_bytes(1024, 1024, 16, F32) > ops.P1_SMEM_LIMIT
    # K1's front kernel keeps x and h: 16 pixels fit at C = 1024, 32 do not
    assert ops.k1_geometry(F32, 2, 1024, 32, 32)[0] == 16
    assert ops.k1_smem_bytes(1024, 32, F32) > ops.P1_SMEM_LIMIT


@pytest.mark.parametrize("c", [16, 48, 64, 80, 128, 512])
def test_fp32_weights_resident_only_up_to_64_channels(c):
    f = c
    for tile in ops.P1_TILES:
        ldb = tile if tile == 8 else tile + 8
        k1 = (c * tile + c * ldb) * 4
        k2 = (max(c, f) * ldb + (c + 2 * f) * tile) * 4
        if c <= 64:
            k1 += 2 * c * (c + 8) * 4                          # W1
            k2 += ((c + 2 * f) * (c + 8) + c * (f + 8)) * 4    # W3, W4, W5
        assert ops.k1_smem_bytes(c, tile, F32) == k1
        assert ops.k2_smem_bytes(c, f, tile, F32) == k2
        resident = c <= 64
        assert (ops.k1_blocks_per_sm(c, tile, dtype=F32)
                <= ops.K1_TF32_BLOCKS_BY_REGISTERS[resident, tile])
        assert (ops.k2_blocks_per_sm(c, f, tile, dtype=F32)
                <= ops.K2_TF32_BLOCKS_BY_REGISTERS[resident, tile])


def test_fp32_and_bf16_forms_differ_only_in_dtype():
    # the bf16 geometry keeps its numbers: the default dtype is bf16
    for c in (32, 48, 128, 512):
        for tile in ops.P1_TILES:
            assert ops.k1_smem_bytes(c, tile) == ops.k1_smem_bytes(c, tile,
                                                                   BF16)
            assert (ops.k2_smem_bytes(c, c, tile)
                    == ops.k2_smem_bytes(c, c, tile, BF16))
            assert (ops.k1_blocks_per_sm(c, tile)
                    == ops.k1_blocks_per_sm(c, tile, dtype=BF16))
            assert (ops.k2_blocks_per_sm(c, c, tile)
                    == ops.k2_blocks_per_sm(c, c, tile, dtype=BF16))
            # fp32 operands and weights take twice the bf16 bytes where
            # both keep the weights resident
            if c <= 64:
                ldb = tile if tile == 8 else tile + 8
                assert (ops.k1_smem_bytes(c, tile, F32)
                        - ops.k1_smem_bytes(c, tile, BF16)
                        == (c * ldb + 2 * c * (c + 8)) * 2)
    assert ops.k1_geometry(BF16, 16, 48, 30, 90) == (
        ops.k1_tile(16, 48, 2700),
        ops.k1_grid(16, 48, 2700, ops.k1_tile(16, 48, 2700)),
        ops.k1_dw_grid(16, 48, 30, 90))
    # K1 picks its tile by the same rule in both dtypes: wherever every tile
    # fits in both, the same tile
    for n, c, h, w in SHAPES:
        if all(ops.k1_smem_bytes(c, t, F32) <= ops.P1_SMEM_LIMIT
               for t in ops.P1_TILES):
            assert (ops.k1_geometry(F32, n, c, h, w)[0]
                    == ops.k1_geometry(BF16, n, c, h, w)[0])


class _Built:
    """Stands in for the built ``nafblock_fwd`` library: the fp32 kernels
    report ``per_sm`` blocks per SM (the bf16 ones fail), and the calls are
    counted."""

    def __init__(self, per_sm):
        self.per_sm, self.calls = per_sm, 0

    def _count(self, *args):
        self.calls += 1
        return self.per_sm

    def _bf16(self, *args):
        raise AssertionError("the fp32 geometry asked a bf16 kernel")

    nafblk_a_tf32_blocks_per_sm = nafblk_a_tf32_dw_blocks_per_sm = _count
    nafblk_b_tf32_blocks_per_sm = _count
    nafblk_a_mma_blocks_per_sm = nafblk_a_dw_blocks_per_sm = _bf16
    nafblk_b_mma_blocks_per_sm = _bf16


@pytest.mark.parametrize("per_sm", [1, 2])
def test_fp32_built_geometry_reads_the_fp32_kernels_once(monkeypatch,
                                                         per_sm):
    lib = _Built(per_sm)
    monkeypatch.setattr(ops._build, "load", lambda name="nafblock_fwd": lib)
    monkeypatch.setattr(ops, "_BUILT_PER_SM", {})
    n, c, h, w = 16, 48, 30, 90
    s = h * w
    tile, grid, dw = ops.k1_geometry(F32, n, c, h, w, built=True)
    assert tile == ops.k1_tile(n, c, s, F32)
    assert grid == ln.one_round(n, s, tile, per_sm)
    assert n * c * dw <= max(n * c, ops.SM_COUNT * per_sm)
    tile2, grid2 = ops.k2_geometry(F32, n, c, c, s, built=True)
    assert grid2 == ln.one_round(n, s, tile2, per_sm)
    calls = lib.calls
    assert ops.k1_geometry(F32, n, c, h, w, built=True) == (tile, grid, dw)
    assert ops.k2_geometry(F32, n, c, c, s, built=True) == (tile2, grid2)
    assert lib.calls == calls


# ---------------------------------------------------------------------------
# the whole K1 and K2 tile chain in numpy: 3xTF32 products, fp32 elsewhere
# ---------------------------------------------------------------------------


def _block(c, seed):
    """Seeded fp32 block parameters as ``chip_smoke.randomize_`` draws them
    for the kernel phases (residual scales 1): matrices N(0, 1/fan_in),
    norm weights 1 + 0.2 N, biases 0.1 N, beta and gamma N(0, 1)."""
    rng = np.random.default_rng(seed)
    mat = lambda o, i: (rng.standard_normal((o, i)) / np.sqrt(i)).astype(
        np.float32)
    vec = lambda k, m=0.0, s=0.1: (m + s * rng.standard_normal(k)).astype(
        np.float32)
    return {"w1n": vec(c, 1.0, 0.2), "b1n": vec(c), "W1": mat(2 * c, c),
            "b1": vec(2 * c), "kdw": mat(2 * c, 9), "bk": vec(2 * c),
            "W3": mat(c, c), "b3": vec(c), "w2n": vec(c, 1.0, 0.2),
            "b2n": vec(c), "W4": mat(2 * c, c), "b4": vec(2 * c),
            "W5": mat(c, c), "b5": vec(c), "beta": vec(c, 0.0, 1.0),
            "gamma": vec(c, 0.0, 1.0)}


def _ln(v, w, b):
    """LN over channels of fp32 ``[C, P]`` as ``ln_stats`` takes it: the
    mean, then the centred variance, all in fp32."""
    mu = v.sum(0, dtype=np.float32) / np.float32(v.shape[0])
    d = v - mu
    var = (d * d).sum(0, dtype=np.float32) / np.float32(v.shape[0])
    rstd = np.float32(1.0) / np.sqrt(var + np.float32(EPS))
    return (d * rstd) * w[:, None] + b[:, None]


def emulate_a(x, p, hw, three):
    """fp32 K1 on one image ``x [C, S]``: h in fp32, t = W1 h + b1 by the
    TF32 chain, the depthwise step and the gate in fp32 -> ``(g, sums)``."""
    c = x.shape[0]
    h = _ln(x, p["w1n"], p["b1n"]).astype(np.float32)
    t = mma_chain(p["W1"], h, three) + p["b1"][:, None]
    u = F.conv2d(torch.from_numpy(t).view(1, 2 * c, *hw),
                 torch.from_numpy(p["kdw"]).view(2 * c, 1, 3, 3),
                 torch.from_numpy(p["bk"]), padding=1, groups=2 * c)[0]
    g = (u[:c] * u[c:]).reshape(c, -1).numpy()
    return g, g.sum(1)


def emulate_b(x, g, att, p, three):
    """fp32 K2 on one image: every product by the TF32 chain, z, LN2, q and
    the gate in fp32 -> ``out [C, S]``."""
    f = p["W4"].shape[0] // 2
    v = g * att[:, None]
    z = x + p["beta"][:, None] * (mma_chain(p["W3"], v, three)
                                  + p["b3"][:, None])
    h2 = _ln(z, p["w2n"], p["b2n"]).astype(np.float32)
    q = mma_chain(p["W4"], h2, three) + p["b4"][:, None]
    wv = q[:f] * q[f:]
    return z + p["gamma"][:, None] * (mma_chain(p["W5"], wv, three)
                                      + p["b5"][:, None])


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("c", [48, 512])
def test_k1_chain_3xtf32_meets_the_fp32_tolerance_one_pass_does_not(c):
    hw = (6, 16)
    p = _block(c, c)
    x = np.random.default_rng(c + 1).standard_normal(
        (1, c, hw[0] * hw[1])).astype(np.float32)
    g_ref, s_ref = ops.plain_a(torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in p.items()},
                               hw, EPS)
    g_ref, s_ref = g_ref[0].numpy(), s_ref[0].numpy()
    errs = {}
    for three in (True, False):
        g, sums = emulate_a(x[0], p, hw, three)
        errs[three] = max(_rel(g, g_ref), _rel(sums / g.shape[1],
                                               s_ref / g.shape[1]))
    assert errs[True] <= TOL, errs
    assert errs[False] > TOL, errs


@pytest.mark.parametrize("c", [48, 512])
def test_k2_chain_3xtf32_meets_the_fp32_tolerance_one_pass_does_not(c):
    s = 96
    p = _block(c, c + 2)
    rng = np.random.default_rng(c + 3)
    x = rng.standard_normal((1, c, s)).astype(np.float32)
    g = rng.standard_normal((1, c, s)).astype(np.float32)
    att = rng.standard_normal((1, c)).astype(np.float32)
    ref = ops.plain_b(torch.from_numpy(x), torch.from_numpy(g),
                      torch.from_numpy(att),
                      {k: torch.from_numpy(v) for k, v in p.items()},
                      EPS)[0].numpy()
    errs = {three: _rel(emulate_b(x[0], g[0], att[0], p, three), ref)
            for three in (True, False)}
    assert errs[True] <= TOL, errs
    assert errs[False] > TOL, errs


# ---------------------------------------------------------------------------
# plain_a and plain_b against JAX at C = 80: weights past the resident 64
# ---------------------------------------------------------------------------


def _jax_block(c, seed):
    """The block's kernel parameters as numpy fp32, every bias nonzero (the
    draws of ``test_torch_port_forward_redesign.py``)."""
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


def _close(got, ref, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_plain_a_matches_jax_call_a_in_fp32_at_c80_on_12x20(tiled):
    n, c, h, w = 2, 80, 12, 20
    assert c > ops.FWD_RESIDENT_MAX and ops.k1_geometry(F32, n, c, h, w)[0]
    pn = _jax_block(c, 41)
    x = np.random.default_rng(42).standard_normal((n, c, h * w)).astype(
        np.float32)
    g_j, m_j = jnb._call_a(jnp.asarray(x), _jax_params(pn),
                           _config(h, w, c, tiled), jnp.float32)
    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    g, sums = ops.plain_a(torch.from_numpy(x), pt, (h, w), EPS)
    _close(g.numpy(), np.asarray(g_j), "g")
    _close(sums.numpy(), np.asarray(m_j)[:, :, 0], "sums")


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_plain_b_matches_jax_call_b_in_fp32_at_c80_on_12x20(tiled):
    n, c, h, w = 2, 80, 12, 20
    assert c > ops.FWD_RESIDENT_MAX and ops.k2_geometry(F32, n, c, c, h * w)[0]
    pn = _jax_block(c, 43)
    rng = np.random.default_rng(44)
    x = rng.standard_normal((n, c, h * w)).astype(np.float32)
    g = rng.standard_normal((n, c, h * w)).astype(np.float32)
    att = rng.standard_normal((n, c)).astype(np.float32)
    out_j = jnb._call_b(jnp.asarray(x), jnp.asarray(g),
                        jnb._pern_wrap(jnp.asarray(att)), _jax_params(pn),
                        _config(h, w, c, tiled), jnp.float32)
    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    out = ops.plain_b(torch.from_numpy(x), torch.from_numpy(g),
                      torch.from_numpy(att), pt, EPS)
    _close(out.numpy(), np.asarray(out_j), "out")
