"""K7's geometry (``ops/pool.py:pool_fwd_geometry``), tested on the CPU by
walking the mapping that ``csrc/pool.cu:relu_pool_fwd_kernel`` makes of it:

- thread (tx, ty) of block (i, j) takes group ``j bx + tx`` of an output
  row (outputs ``[Q g, min(Q g + Q, Wo))``, Q = 16 bytes of outputs) and
  the output rows ``i by + ty + k gx by``: every output of ``[NC, H//2,
  W//2]`` is written exactly once, at the VGG19 pool shapes, an odd 37x51,
  W=50 (a 100-byte bf16 row pitch), W % 16 == 8 and 1x1 outputs, in fp32
  and bf16, with x at a 16-byte boundary and one element past it, and
  with one or six blocks an SM;
- every load and store is aligned to its width, a group's loads and
  stores cover its outputs exactly (``lv`` divides twice their count,
  ``sv`` divides it), and output row r starts in x at input row
  ``2 r + plane * (H % 2)``, the top row of its windows;
- the VGG19 shapes get 16-byte loads and stores and fill the card (at
  least one block on each of the 132 SMs, at most two rounds of blocks);
- a numpy walk of the kernel's arithmetic on small seeded inputs with
  NaNs, ties and signed zeros equals ``plain_relu_pool_fwd``.
"""

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu_torch.ops import pool
from lowlight_image_enhancement_tpu_torch.ops.layernorm import SM_COUNT

VGG = [(2, 64, 384, 384), (2, 128, 192, 192), (2, 256, 96, 96),
       (2, 512, 48, 48)]
SHAPES = VGG + [(2, 64, 37, 51), (2, 64, 50, 50), (2, 64, 40, 40),
                (2, 64, 2, 2), (1, 3, 3, 3), (3, 2, 9, 24), (1, 1, 4, 1030)]
DTYPES = [torch.float32, torch.bfloat16]


def _pairs(q):
    return {(q, q), (q, q // 2), (2, 2), (2, 1), (1, 1)}


def _rows_walk(rows, geo):
    """How often each output row is taken by the blocks' row walk."""
    starts = (np.arange(geo.gx)[:, None] * geo.by
              + np.arange(geo.by)[None, :]).ravel()
    step = geo.gx * geo.by
    hits = np.zeros(rows, np.int64)
    for k in range(-(-rows // step) + 1):
        r = starts + k * step
        np.add.at(hits, r[r < rows], 1)
    return hits


def _groups(geo, groups):
    g = (np.arange(geo.gy)[:, None] * geo.bx
         + np.arange(geo.bx)[None, :]).ravel()
    return g[g < groups]


@pytest.mark.parametrize("per_sm", [1, 6])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k7_mapping_covers_every_output_once(shape, dtype, per_sm):
    n, c, h, w = shape
    es = 2 if dtype == torch.bfloat16 else 4
    q = 16 // es
    ho, wo = h // 2, w // 2
    for offset in (0, es):
        geo = pool.pool_fwd_geometry(dtype, n * c, h, w, per_sm, offset)
        assert (geo.lv, geo.sv) in _pairs(q)
        assert w % geo.lv == 0 and offset % (geo.lv * es) == 0
        assert wo % geo.sv == 0
        assert geo.bx * geo.by <= pool.POOL_FWD_THREADS
        groups = -(-wo // q)
        assert geo.gy * geo.bx >= groups
        rounds = pool.POOL_FWD_ROUNDS * SM_COUNT * per_sm
        assert geo.gx * geo.gy < rounds + geo.gy
        # columns: each output of a row in exactly one group
        cols = np.zeros(wo, np.int64)
        for g in _groups(geo, groups):
            out_n = min(q, wo - g * q)
            assert (2 * out_n) % geo.lv == 0 and out_n % geo.sv == 0
            assert ((g * q) % geo.sv == 0 and (2 * g * q) % geo.lv == 0)
            cols[g * q:g * q + out_n] += 1
        assert (cols == 1).all()
        # rows: each output row taken once by the walk
        rows = n * c * ho
        assert (_rows_walk(rows, geo) == 1).all()
        # output row r reads input rows 2 r + plane (H % 2) and the next
        r = np.arange(rows)
        plane, oh = r // ho, r % ho
        row0 = 2 * r + (plane if h % 2 else 0)
        assert (row0 == plane * h + 2 * oh).all()
        assert (2 * oh + 1 < h).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", VGG, ids=lambda s: "x".join(map(str, s)))
def test_k7_vgg_shapes_move_16_bytes_and_fill_the_card(shape, dtype):
    n, c, h, w = shape
    q = 16 // (2 if dtype == torch.bfloat16 else 4)
    for per_sm in (1, 4, 8):
        geo = pool.pool_fwd_geometry(dtype, n * c, h, w, per_sm)
        assert geo.lv == geo.sv == q and geo.gy == 1
        assert geo.gx * geo.gy >= SM_COUNT
        assert geo.gx <= pool.POOL_FWD_ROUNDS * SM_COUNT * per_sm


def _walk(x: torch.Tensor, geo) -> torch.Tensor:
    """The kernel's arithmetic in numpy: every load a group issues (zeros
    past the end of its vectors), the fp32 NaN-passing max, the stores."""
    n, c, h, w = x.shape
    ho, wo = h // 2, w // 2
    q = 16 // x.element_size()
    xf = x.float().numpy().reshape(-1)
    y = np.full(n * c * ho * wo, np.inf, np.float32)
    groups = -(-wo // q)

    def nan_max(a, b):
        return a if (a > b or a != a) else b

    for g in _groups(geo, groups):
        in_n = 2 * min(q, wo - g * q)
        for r in range(n * c * ho):
            row0 = 2 * r + (r // ho if h % 2 else 0)
            base = row0 * w + 2 * g * q
            v0 = np.zeros(2 * q, np.float32)
            v1 = np.zeros(2 * q, np.float32)
            for k in range(2 * q // geo.lv):
                if k * geo.lv < in_n:
                    sl = slice(k * geo.lv, (k + 1) * geo.lv)
                    v0[sl] = xf[base + k * geo.lv:base + (k + 1) * geo.lv]
                    v1[sl] = xf[base + w + k * geo.lv:
                                base + w + (k + 1) * geo.lv]
            for i in range(q):
                if 2 * (i // geo.sv) * geo.sv < in_n:
                    m = nan_max(nan_max(v0[2 * i], v0[2 * i + 1]),
                                nan_max(v1[2 * i], v1[2 * i + 1]))
                    y[r * wo + g * q + i] = nan_max(m, np.float32(0.0))
    return torch.from_numpy(y.reshape(n, c, ho, wo)).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 2, 5, 7), (2, 1, 4, 20), (1, 3, 6, 50),
                                   (1, 1, 3, 34)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k7_walk_equals_plain_version(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.1] = np.nan
    x[rng.random(shape) < 0.1] = -0.0
    x[rng.random(shape) < 0.1] = 0.5
    xt = torch.from_numpy(x).to(dtype)
    n, c, h, w = shape
    for offset in (0, xt.element_size()):
        geo = pool.pool_fwd_geometry(dtype, n * c, h, w, 1, offset)
        got, ref = _walk(xt, geo), pool.plain_relu_pool_fwd(xt)
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(got.nan_to_num(7.0), ref.nan_to_num(7.0))
