// K1 and K2 in bf16: the NAFBlock forward on the tensor cores, included by
// nafblock_fwd.cu. See that file's header for what K1 and K2 compute and
// their bound.
//
//   k1_front_kernel (tensor cores, pixel tiles of P pixels of one image with
//     every channel): LN1 of x (the mean, then the centred variance, fp32)
//     -> h = bf16(xhat w1n + b1n) -> t = W1 h + b1, written as fp32
//     [N, 2C, HWp] (the TPU kernel keeps t in fp32 before the depthwise
//     step; so does this one).
//   k1_dw_kernel (CUDA cores, 2-D tiles of 32 x 32 pixels, one channel pair
//     (j, C + j) a block): u = dw3x3(t) + bk with t zero outside the image,
//     g = u1 u2 written in bf16 (in fp32 for the fp32 K1 of
//     nafblock_fwd_tf32.cuh, which shares this kernel), and the fp32 sum of
//     g (before it is rounded) over every tile the block walks: one partial
//     row a block, added by sum_rows in a fixed order (no float atomics).
//   k2_mma_kernel (tensor cores, pixel tiles): v = bf16(g att) -> conv3 ->
//     z = x + beta (W3 v + b3) (fp32) -> LN2 -> conv4 -> the gate in fp32,
//     rounded to bf16 -> conv5 -> out = z + gamma (W5 wv + b5), stored in
//     bf16 16 bytes a thread.
// Every product is tile_gemm / tile_gemm_resident of nafblock_p1_mma.cuh
// (mma.sync m16n8k16 fed by ldmatrix): a warp owns 16 output rows and all P
// pixels of a tile. Up to 64 channels the weights stay in shared memory for
// every tile a block walks; above, they pass through the ring of slabs.
// The gate pairs rows f and F + f of conv4, which lie in different warp
// tiles, so q waits in shared memory (fp32 [2F][P]) for the gate pass.

#pragma once

#include "nafblock_p1_mma.cuh"

namespace nafblk {

// Blocks of the resident kernels that share an SM (launch bounds): a tile
// is a chain of short phases, which only more blocks in flight hide.
constexpr int kFwdResidentBlocks = 3;

// W1 [2C][C] (rows padded by 8) stays in shared memory up to 64 channels:
// tile_gemm_resident takes at most 128 output rows.
__host__ __device__ inline bool k1_resident(int C) {
  return C <= kResidentMax;
}

// Dynamic shared memory of k1_front_kernel with P pixels: x fp32 [C][P],
// h bf16 [C][ldb], and W1 or the slabs.
inline size_t k1_front_smem(int C, int P) {
  const size_t w = k1_resident(C)
                       ? (size_t)2 * C * ldr_of(C) * sizeof(bf16)
                       : (size_t)kStages * kSlab * sizeof(bf16);
  return (size_t)C * P * sizeof(float) + (size_t)C * ldb_of(P) * sizeof(bf16) +
         w;
}

// Dynamic shared memory of k2_mma_kernel with P pixels: v, h2, then wv
// bf16 [max(C, F)][ldb]; the weights (W3, W4, W5 resident, or the slabs);
// z fp32 [C][P] and q fp32 [2F][P].
inline size_t k2_mma_smem(int C, int F, int P) {
  const size_t w = resident(C, F) ? resident_elems(C, F) * sizeof(bf16)
                                  : (size_t)kStages * kSlab * sizeof(bf16);
  return (size_t)imax(C, F) * ldb_of(P) * sizeof(bf16) + w +
         (size_t)(C + 2 * F) * P * sizeof(float);
}

struct K1Mma {
  const bf16* x;
  const float *w1n, *b1n, *b1, *kdw, *bk;
  const bf16* W1;
  bf16* g;
  float* t;     // [N, 2C, HWp]
  float* part;  // [N, DX, C]: the depthwise blocks' sums of g
  int C, H, W;
  long long HW, HWp;
  int tiles;  // pixel tiles per image
  int vec;    // x rows allow 16-byte loads
  float eps;
};

// ---------------------------------------------------------------------------
// k1_front_kernel: grid (BX, N), block kThreads; block (bx, n) walks the
// pixel tiles bx, bx + BX, ... of image n.
// ---------------------------------------------------------------------------

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kFwdResidentBlocks : 2)
    k1_front_kernel(const K1Mma a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);          // [C][P]
  bf16* h_s = reinterpret_cast<bf16*>(x_s + (size_t)C * P);  // [C][LDB]
  bf16* wts = h_s + (size_t)C * LDB;  // slabs, or W1 [2C] rows
  const int ld = ldr_of(C);
  __shared__ float red_s[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const bf16* xn = a.x + (long long)n * C * HW;
  float* tn = a.t + (long long)n * 2 * C * HWp;
  const bool vec = a.vec != 0;

  if (RES) {
    const int ch = C / 8;
    for (int i = tid; i < 2 * C * ch; i += kThreads)
      cp_async16(wts + (i / ch) * ld + (i % ch) * 8,
                 a.W1 + (long long)(i / ch) * C + (i % ch) * 8);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;
    const bool valid = p0 + px < HW;

    // ---- x -> x_s; LN1 statistics; h = bf16(xhat w1n + b1n) -> h_s
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8];
      load8(xn + (long long)c * HW, p0 + j, HW, vec, xv);
      float4* xr = reinterpret_cast<float4*>(x_s + c * P + j);
      xr[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
      xr[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
    }
    __syncthreads();
    float mu, rstd;
    ln_stats<P>(x_s, C, red_s, grp, px, a.eps, mu, rstd);
    for (int c = grp; c < C; c += G) {
      const float xh = (x_s[c * P + px] - mu) * rstd;
      h_s[c * LDB + px] =
          __float2bfloat16_rn(valid ? fmaf(xh, a.w1n[c], a.b1n[c]) : 0.f);
    }
    __syncthreads();

    // ---- t = W1 h + b1 (fp32 out; the product ends with a barrier, so
    //      the next tile may refill x_s and h_s)
    auto epi = [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = row0 + gq + 8 * hh;
        const float bb = a.b1[o];
        float* trow = tn + (long long)o * HWp + p0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = 8 * nt + 2 * tq;
          if (p0 + col < HWp)
            *reinterpret_cast<float2*>(trow + col) = make_float2(
                acc[nt][2 * hh] + bb, acc[nt][2 * hh + 1] + bb);
        }
      }
    };
    if constexpr (RES)
      tile_gemm_resident<P, false>(wts, ld, 2 * C, C, h_s, epi);
    else
      tile_gemm<P, false>(a.W1, C, 2 * C, C, h_s, wts, epi);
  }
}

// ---------------------------------------------------------------------------
// k1_dw_kernel: grid (C, DX, N), block kThreads. Block (j, d, n) takes the
// channel pair (j, C + j) of image n and walks its 2-D tiles d, d + DX, ...
// of kK1DwH x kK1DwW output pixels (kK1DwRows a thread, 8 rows apart).
// Writes its partial sum of g at part[n * DX + d][j]. Bound by bytes (t in:
// 8 C bytes a pixel, g out: 2 C); all loads of a tile are issued before the
// first store to shared memory, so they are in flight together.
// Args is K1Mma (g out in bf16) or K1Tf32 of nafblock_fwd_tf32.cuh (g out
// in fp32).
// ---------------------------------------------------------------------------

constexpr int kK1DwRows = 4;  // output rows a thread (8 rows apart)
constexpr int kK1DwH = 8 * kK1DwRows, kK1DwW = 32;   // output tile
constexpr int kK1DwTH = kK1DwH + 2, kK1DwTW = kK1DwW + 2;  // t with its ring
constexpr int kK1DwLoads = (2 * kK1DwTH * kK1DwTW + kThreads - 1) / kThreads;
constexpr int kK1DwBlocks = 3;

__host__ __device__ inline int k1_dw_tiles(int H, int W) {
  return ((H + kK1DwH - 1) / kK1DwH) * ((W + kK1DwW - 1) / kK1DwW);
}

__device__ __forceinline__ void store_g(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_g(float* p, float v) { *p = v; }

template <typename Args>
__global__ void __launch_bounds__(kThreads, kK1DwBlocks)
    k1_dw_kernel(const Args a) {
  __shared__ float t_s[2][kK1DwTH * kK1DwTW];
  __shared__ float red_s[kThreads / 32];

  const int C = a.C, H = a.H, W = a.W;
  const long long HWp = a.HWp;
  const int j = blockIdx.x, n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tiles_x = (W + kK1DwW - 1) / kK1DwW;
  const int tiles = k1_dw_tiles(H, W);
  const float* ta = a.t + ((long long)n * 2 * C + j) * HWp;
  const float* tb = ta + (long long)C * HWp;
  auto* gj = a.g + ((long long)n * C + j) * a.HW;

  float ka[9], kb[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    ka[k] = a.kdw[j * 9 + k];
    kb[k] = a.kdw[(C + j) * 9 + k];
  }
  const float bka = a.bk[j], bkb = a.bk[C + j];
  float sum = 0.f;  // of g over this thread's pixels, every tile

  const int r = tid / kK1DwW, cl = tid % kK1DwW;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int r0 = (tile / tiles_x) * kK1DwH, c0 = (tile % tiles_x) * kK1DwW;
    float tv[kK1DwLoads];
#pragma unroll
    for (int it = 0; it < kK1DwLoads; ++it) {
      const int i = tid + it * kThreads;
      const int ch = i / (kK1DwTH * kK1DwTW), q = i % (kK1DwTH * kK1DwTW);
      const int gr = r0 - 1 + q / kK1DwTW, gc = c0 - 1 + q % kK1DwTW;
      const bool in = i < 2 * kK1DwTH * kK1DwTW && gr >= 0 && gr < H &&
                      gc >= 0 && gc < W;
      tv[it] = in ? __ldg((ch ? tb : ta) + (long long)gr * W + gc) : 0.f;
    }
    __syncthreads();  // the last tile's readers are done with t_s
#pragma unroll
    for (int it = 0; it < kK1DwLoads; ++it) {
      const int i = tid + it * kThreads;
      if (i < 2 * kK1DwTH * kK1DwTW) (&t_s[0][0])[i] = tv[it];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kK1DwRows; ++i) {
      const int rl = r + 8 * i;
      const int gr = r0 + rl, gc = c0 + cl;
      if (gr >= H || gc >= W) continue;
      float ua = bka, ub = bkb;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int o = (rl + kh) * kK1DwTW + cl + kw;
          ua = fmaf(ka[kh * 3 + kw], t_s[0][o], ua);
          ub = fmaf(kb[kh * 3 + kw], t_s[1][o], ub);
        }
      const float gv = ua * ub;
      sum += gv;
      store_g(gj + (long long)gr * W + gc, gv);
    }
  }

  // the block's sum: warps by shuffle, then the 8 warps in order
  const float s = warp_sum(sum);
  if ((tid & 31) == 0) red_s[tid / 32] = s;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red_s[w];
    a.part[((long long)n * gridDim.y + blockIdx.y) * C + j] = total;
  }
}

// ---------------------------------------------------------------------------
// k2_mma_kernel: grid (BX, N), block kThreads; block (bx, n) walks the pixel
// tiles bx, bx + BX, ... of image n, P pixels each. RES (C, F <= 64): W3,
// W4, W5 stay in shared memory from the first tile to the last.
// ---------------------------------------------------------------------------

struct K2Mma {
  const bf16 *x, *g;
  const float* att;
  const bf16 *W3, *W4, *W5;
  const float *b3, *w2n, *b2n, *b4, *b5, *beta, *gamma;
  bf16* out;
  int C, F;
  long long HW;
  int tiles;  // pixel tiles per image
  int vec;    // x, g, out rows allow 16-byte loads and stores
  float eps;
};

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kFwdResidentBlocks : 2)
    k2_mma_kernel(const K2Mma a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C, F = a.F;
  const long long HW = a.HW;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hq_s = reinterpret_cast<bf16*>(smem_raw);  // v, h2, then wv
  bf16* wts = hq_s + (size_t)imax(C, F) * LDB;     // slabs, or W3, W4, W5
  const int ld_c = ldr_of(C), ld_f = ldr_of(F);
  bf16* W3_s = wts;
  bf16* W4_s = W3_s + (size_t)C * ld_c;
  bf16* W5_s = W4_s + (size_t)2 * F * ld_c;
  float* z_s = reinterpret_cast<float*>(
      wts + (RES ? resident_elems(C, F) : (size_t)kStages * kSlab));
  float* q_s = z_s + (size_t)C * P;  // [2F][P]
  __shared__ float red_s[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* attn = a.att + (long long)n * C;
  const bf16* xn = a.x + (long long)n * C * HW;
  const bf16* gn = a.g + (long long)n * C * HW;
  bf16* on = a.out + (long long)n * C * HW;
  const bool vec = a.vec != 0;

  if (RES) {
    auto fill = [&](bf16* dst, const bf16* src, int rows, int cols, int ld) {
      const int ch = cols / 8;
      for (int i = tid; i < rows * ch; i += kThreads)
        cp_async16(dst + (i / ch) * ld + (i % ch) * 8,
                   src + (long long)(i / ch) * cols + (i % ch) * 8);
    };
    fill(W3_s, a.W3, C, C, ld_c);
    fill(W4_s, a.W4, 2 * F, C, ld_c);
    fill(W5_s, a.W5, C, F, ld_f);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // the product W act of this tile: from the resident copy of W, or from W
  // in global memory through the ring
  auto product = [&](const bf16* Wg, const bf16* Ws, int cols, int M, int K,
                     auto&& epi) {
    if constexpr (RES)
      tile_gemm_resident<P, false>(Ws, ldr_of(cols), M, K, hq_s, epi);
    else
      tile_gemm<P, false>(Wg, cols, M, K, hq_s, wts, epi);
  };

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;

    // ---- load: v = bf16(g att) -> hq; z = x
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8], gv[8];
      load8(xn + (long long)c * HW, p0 + j, HW, vec, xv);
      load8(gn + (long long)c * HW, p0 + j, HW, vec, gv);
      const float at = attn[c];
#pragma unroll
      for (int e = 0; e < 8; ++e) gv[e] *= at;
      *reinterpret_cast<uint4*>(hq_s + c * LDB + j) = pack8(gv);
      float4* zr = reinterpret_cast<float4*>(z_s + c * P + j);
      zr[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
      zr[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
    }
    __syncthreads();

    // ---- conv3: z = x + beta (W3 v + b3)
    product(a.W3, W3_s, C, C, C, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + gq + 8 * h;
        const float bb = a.b3[o], be = a.beta[o];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float2* zz = reinterpret_cast<float2*>(z_s + o * P + 8 * nt + 2 * tq);
          float2 zv = *zz;
          zv.x = fmaf(be, acc[nt][2 * h] + bb, zv.x);
          zv.y = fmaf(be, acc[nt][2 * h + 1] + bb, zv.y);
          *zz = zv;
        }
      }
    });

    // ---- LN2: h2 = bf16(xhat2 w2n + b2n) -> hq (v is dead: the product
    //      ended with a barrier)
    float mu, rstd;
    ln_stats<P>(z_s, C, red_s, grp, px, a.eps, mu, rstd);
    for (int c = grp; c < C; c += G)
      hq_s[c * LDB + px] = __float2bfloat16_rn(
          fmaf((z_s[c * P + px] - mu) * rstd, a.w2n[c], a.b2n[c]));
    __syncthreads();

    // ---- conv4: q = W4 h2 + b4 -> q_s
    product(a.W4, W4_s, C, 2 * F, C, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + gq + 8 * h;
        const float bb = a.b4[o];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(q_s + o * P + 8 * nt + 2 * tq) =
              make_float2(acc[nt][2 * h] + bb, acc[nt][2 * h + 1] + bb);
      }
    });

    // ---- gate: wv = bf16(q1 q2) -> hq (h2 is dead)
    for (int f = grp; f < F; f += G)
      hq_s[f * LDB + px] =
          __float2bfloat16_rn(q_s[f * P + px] * q_s[(F + f) * P + px]);
    __syncthreads();

    // ---- conv5: out = z + gamma (W5 wv + b5) -> z_s
    product(a.W5, W5_s, F, C, F, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + gq + 8 * h;
        const float bb = a.b5[o], gm = a.gamma[o];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float2* zz = reinterpret_cast<float2*>(z_s + o * P + 8 * nt + 2 * tq);
          float2 zv = *zz;
          zv.x = fmaf(gm, acc[nt][2 * h] + bb, zv.x);
          zv.y = fmaf(gm, acc[nt][2 * h + 1] + bb, zv.y);
          *zz = zv;
        }
      }
    });

    // ---- store out in bf16, 16 bytes a thread where the row allows it
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      const long long p = p0 + j;
      if (p >= HW) continue;
      const float4* zr = reinterpret_cast<const float4*>(z_s + c * P + j);
      const float4 u0 = zr[0], u1 = zr[1];
      const float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      bf16* dst = on + (long long)c * HW + p;
      if (vec && p + 8 <= HW) {
        *reinterpret_cast<uint4*>(dst) = pack8(v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (p + e < HW) dst[e] = __float2bfloat16_rn(v[e]);
      }
    }
    __syncthreads();  // z_s is read above and refilled by the next tile
  }
}

}  // namespace nafblk
