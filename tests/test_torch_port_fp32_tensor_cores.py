"""K3 and K4 in fp32 on the tensor cores (3xTF32), tested on the CPU:

- the route's geometry (``p1_geometry`` / ``p2_geometry`` with dtype fp32,
  ``p1_smem_bytes`` / ``p2_smem_bytes`` / ``*_blocks_per_sm`` in their fp32
  forms): at every shape of ``chip_smoke.BACKWARD_WIDTHS`` the tile is
  legal, fits ``P1_SMEM_LIMIT`` and the grid is one round of blocks that
  fills the card; fp32 at C or F % 16 != 0 gets no tile (the FMA route,
  whose tile fits); the weights are resident only up to 64 channels, and
  above no shared memory goes to them;
- the numerics of the split (``csrc/nafblock_tf32.cuh``): a numpy
  emulation of ``cvt.rna.tf32.f32`` (round to nearest, ties away from
  zero, to 10 mantissa bits, by bit operations) and of the
  ``mma.m16n8k8`` chain (fp32 accumulators, one rounding per step of 8),
  applied to K3's products (the six of a pixel tile and the three weight
  gradients) and K4's (three of a tile, dW1) at C = 48 and C = 512 on
  seeded data: 3xTF32 within 1e-5 of the fp64 product's max|ref|, while
  a single TF32 pass exceeds 1e-4, the fp32 tolerance of
  ``chip_smoke.py`` (``TOL``) -- which is why the design takes three.

The kernels themselves run only on the card (``chip_smoke.py``'s
backward phase holds them against the plain versions). ``plain_p1`` and
``plain_p2`` against JAX are held in ``test_torch_port_kernel_redesign.py``
and ``test_torch_port_backward_redesign.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops

F32 = torch.float32
SHAPES = [(n, c, h, w) for n, c, h, w, *_ in chip_smoke.BACKWARD_WIDTHS]
SHAPES += [(2, 16, 64, 64), (2, 48, 30, 91)]


def _holds_one_round(n, s, tile, grid, per_sm):
    tiles = -(-s // tile)
    assert 1 <= grid <= tiles                       # what the kernel checks
    assert grid == ln.one_round(n, s, tile, per_sm)
    assert n * grid <= max(n, ln.SM_COUNT * per_sm)
    # every SM gets a block where the image has the tiles for it (less the
    # rounding of one round down to whole blocks per image)
    assert n * grid >= min(n * tiles, ln.SM_COUNT * per_sm - n + 1)


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_fp32_k3_tile_is_legal_and_fills_the_card(n, c, h, w):
    s = h * w
    tile, grid = ops.p1_geometry(F32, n, c, c, s)
    assert tile in ops.P1_TILES
    assert ops.p1_smem_bytes(c, c, tile, F32) <= ops.P1_SMEM_LIMIT
    per_sm = ops.p1_blocks_per_sm(c, c, tile, F32)
    assert 1 <= per_sm <= 3
    assert per_sm * (ops.p1_smem_bytes(c, c, tile, F32) + 3072) <= ops.SM_SMEM
    _holds_one_round(n, s, tile, grid, per_sm)


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_fp32_k4_tile_is_legal_and_fills_the_card(n, c, h, w):
    s = h * w
    tile, grid, dw = ops.p2_geometry(F32, n, c, h, w)
    assert tile in ops.P1_TILES
    assert ops.p2_smem_bytes(c, tile, F32) <= ops.P1_SMEM_LIMIT
    per_sm = ops.p2_blocks_per_sm(c, tile, F32)
    assert 1 <= per_sm <= 3
    assert per_sm * (ops.p2_smem_bytes(c, tile, F32) + 3072) <= ops.SM_SMEM
    _holds_one_round(n, s, tile, grid, per_sm)
    # the depthwise kernel's grid is the bf16 route's
    assert dw == ops.p2_dw_grid(n, c, h, w)


@pytest.mark.parametrize("c,f", [(8, 8), (8, 16), (12, 12), (24, 24),
                                 (24, 48), (40, 40), (72, 72), (16, 24),
                                 (48, 40)])
def test_fp32_tile_refused_at_c_or_f_no_multiple_of_16(c, f):
    # no tensor-core tile: such an fp32 K3 (and K4 at C % 16 != 0) takes
    # the FMA route, whose tile fits
    assert ops.p1_geometry(F32, 2, c, f, 4096) == (0, 0)
    assert ops.p1_fma_pixels(c, f) > 0
    if c % 16:
        assert ops.p2_geometry(F32, 2, c, 64, 64) == (0, 0, 0)
        assert ops.p2_fma_pixels(c) > 0


def test_fp32_refuses_what_fits_no_route_and_takes_c1024():
    # K3 at C=1024 fits with 8 pixels only because no shared memory goes to
    # the weights above 64 channels; F = 2C fits nowhere
    assert ops.p1_geometry(F32, 2, 1024, 1024, 144) == (8, 18)
    assert ops.p1_smem_bytes(1024, 1024, 8, F32) <= ops.P1_SMEM_LIMIT
    assert ops.p1_smem_bytes(1024, 1024, 16, F32) > ops.P1_SMEM_LIMIT
    assert ops.p1_geometry(F32, 2, 1024, 2048, 4096) == (0, 0)
    assert ops.p1_fma_pixels(1024, 2048) == 0
    assert ops.p2_geometry(F32, 2, 1024, 12, 12)[0] == 8


@pytest.mark.parametrize("c", [16, 48, 64, 80, 128, 512])
def test_fp32_weights_resident_only_up_to_64_channels(c):
    f = c
    for tile in ops.P1_TILES:
        ldb = tile if tile == 8 else tile + 8
        operands = ((max(c + f, 2 * f) + c) * ldb + (2 * c + 2 * f) * tile) * 4
        k4_front = (c * tile + c * ldb) * 4
        k4_back = (2 * c * ldb + 2 * c * tile) * 4
        if c <= 64:
            # W3 [C][C+8], W4 [2F][C+8], W5 [C][F+8] and 13C + 4F vectors
            weights = ((c + 2 * f) * (c + 8) + c * (f + 8) + 13 * c
                       + 4 * f) * 4
            assert weights >= 4 * 4 * c * c       # 36 KB of matrices at 48
            k4_front += 3 * c * (c + 8) * 4       # W1, W3
            k4_back += 2 * c * (c + 8) * 4        # W1
        else:
            weights = 0
        assert ops.p1_smem_bytes(c, f, tile, F32) == operands + weights
        assert ops.p2_smem_bytes(c, tile, F32) == max(k4_front, k4_back)
        table = ops.P1_TF32_BLOCKS_BY_REGISTERS[c <= 64, tile]
        assert ops.p1_blocks_per_sm(c, f, tile, F32) <= table
        table = ops.P2_TF32_BLOCKS_BY_REGISTERS[c <= 64, tile]
        assert ops.p2_blocks_per_sm(c, tile, F32) <= table


def test_fp32_and_bf16_forms_differ_only_in_dtype():
    # the bf16 geometry keeps its numbers: the default dtype is bf16
    for c in (32, 48, 128):
        for tile in ops.P1_TILES:
            assert (ops.p1_smem_bytes(c, c, tile)
                    == ops.p1_smem_bytes(c, c, tile, torch.bfloat16))
            assert (ops.p2_blocks_per_sm(c, tile)
                    == ops.p2_blocks_per_sm(c, tile, torch.bfloat16))
    assert ops.p1_geometry(torch.bfloat16, 16, 48, 48, 2700) == (
        ops.p1_tile(16, 48, 48, 2700),
        ops.p1_grid(16, 48, 48, 2700, ops.p1_tile(16, 48, 48, 2700)))


# ---------------------------------------------------------------------------
# 3xTF32 in numpy
# ---------------------------------------------------------------------------


def tf32(x) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round the fp32 significand to 10 bits, to the
    nearest, ties away from zero (the sign is apart, so adding half an ulp
    of the kept bits to the magnitude's bits rounds away)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """``x = hi + lo`` with both TF32; ``x - hi`` is exact in fp32."""
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_chain(a: np.ndarray, b: np.ndarray, three: bool) -> np.ndarray:
    """``a [M, K] @ b [K, N]`` as a chain of m16n8k8 TF32 steps into fp32
    accumulators (a TF32 product is exact in fp32; each step's sum is
    rounded once): 3xTF32 adds lo.hi, hi.lo, hi.hi in that order, a single
    pass hi.hi."""
    ah, al = split(a)
    bh, bl = split(b)
    passes = [(al, bh), (ah, bl), (ah, bh)] if three else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in passes:
            step = (x[:, k0:k0 + 8].astype(np.float64)
                    @ y[k0:k0 + 8].astype(np.float64))
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -11], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                    np.float32)
    assert np.array_equal(tf32(x), want)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(4096).astype(np.float32)
    hi, lo = split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi + lo keeps ~22 bits of each value
    err = np.abs(hi.astype(np.float64) + lo - v.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(v)).all()


def _products(c: int, seed: int) -> dict:
    """K3's and K4's products at C = F = ``c`` on seeded data, as
    ``(A [M, K], B [K, N])``: weights N(0, 1/fan_in), activations N(0, 1),
    the gate ``wv = q1 q2`` (heavier tails); a pixel tile of 64, the
    weight gradients over 512 pixels."""
    rng = np.random.default_rng(seed)
    f, p, s = c, 64, 512
    w = lambda o, i: (rng.standard_normal((o, i)) / np.sqrt(i)).astype(
        np.float32)
    act = lambda r, n: rng.standard_normal((r, n)).astype(np.float32)
    W1, W3, W4, W5 = w(2 * c, c), w(c, c), w(2 * f, c), w(c, f)
    q = act(2 * f, p)
    return {
        "K3 conv3 W3 v": (W3, act(c, p)),
        "K3 conv4 W4 h2": (W4, act(c, p)),
        "K3 conv5 W5 wv": (W5, q[:f] * q[f:]),
        "K3 W5^T ds": (W5.T, act(c, p)),
        "K3 W4^T dq": (W4.T, act(2 * f, p)),
        "K3 W3^T dp": (W3.T, act(c, p)),
        "K3 dW3 dp v^T": (act(c, s), act(s, c)),
        "K3 dW4 dq h2^T": (act(2 * f, s), act(s, c)),
        "K3 dW5 ds wv^T": (act(c, s), act(s, f)),
        "K4 conv1 W1 h": (W1, act(c, p)),
        "K4 W3^T pr": (W3.T, act(c, p)),
        "K4 W1^T dt": (W1.T, act(2 * c, p)),
        "K4 dW1 dt h^T": (act(2 * c, s), act(s, c)),
    }


PRODUCTS = list(_products(16, 0))


@pytest.mark.parametrize("c", [48, 512])
@pytest.mark.parametrize("name", PRODUCTS)
def test_3xtf32_meets_the_fp32_tolerance_where_one_pass_does_not(c, name):
    a, b = _products(c, c)[name]
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    three = np.abs(mma_chain(a, b, True) - ref).max() / scale
    one = np.abs(mma_chain(a, b, False) - ref).max() / scale
    assert three <= 1e-5, (name, three)
    assert one > chip_smoke.TOL[torch.float32], (name, one)
