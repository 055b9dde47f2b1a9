// K1 and K2 in fp32 on the tensor cores, as three TF32 products each
// ("3xTF32"), included by nafblock_fwd.cu. See that file's header for what
// K1 and K2 compute and their bounds. The kernels follow the bf16 design of
// nafblock_fwd_mma.cuh step by step; every product is tile_gemm_tf32 of
// tf32_mma.cuh (the split a = hi + lo once per fragment load, lo.hi +
// hi.lo + hi.hi into fp32 accumulators, as K3 and K4 in fp32 take it), and
// every operand stays fp32:
//
//   k1_front_tf32_kernel (pixel tiles of P pixels of one image with every
//     channel): LN1 of x -> h = xhat w1n + b1n (fp32 [C][ldb]) -> t = W1 h
//     + b1, written as fp32 [N, 2C, HWp];
//   k1_dw_kernel<K1Tf32> (nafblock_fwd_mma.cuh): the depthwise step, the
//     gate g stored in fp32 and the fp32 partial sums of g, then sum_rows;
//   k2_tf32_kernel (pixel tiles): v = g att -> z = x + beta (W3 v + b3) ->
//     LN2 -> h2 -> q = W4 h2 + b4 (fp32 [2F][P]) -> wv = q1 q2 -> out =
//     z + gamma (W5 wv + b5), stored in fp32 16 bytes a thread.
//
// Shared memory. The operands are fp32 [channels][ldb_of(P)]: a row pitch
// that is an odd multiple of 8 words, so the 32 lanes of a B fragment hit
// 32 banks. Up to C = F = 64 the weights stay resident in fp32 (rows of
// ldr_of(cols) words); above, each warp reads its A fragments from global
// memory (L2) and no shared memory goes to weights, so K2 fits at
// C = F = 1024 with 8 pixels (128 KB).

#pragma once

#include "nafblock_fwd_mma.cuh"
#include "tf32_mma.cuh"

namespace nafblk {

// Dynamic shared memory of k1_front_tf32_kernel with P pixels: x fp32
// [C][P], h fp32 [C][ldb], and W1 fp32 [2C][ldr] while resident.
inline size_t k1_front_tf32_smem(int C, int P) {
  const size_t w = k1_resident(C) ? (size_t)2 * C * ldr_of(C) : 0;
  return ((size_t)C * P + (size_t)C * ldb_of(P) + w) * sizeof(float);
}

// Dynamic shared memory of k2_tf32_kernel with P pixels: v, h2, then wv
// fp32 [max(C, F)][ldb]; W3, W4, W5 fp32 while resident; z fp32 [C][P] and
// q fp32 [2F][P].
inline size_t k2_tf32_smem(int C, int F, int P) {
  const size_t w = resident(C, F) ? resident_elems(C, F) : 0;
  return ((size_t)imax(C, F) * ldb_of(P) + w + (size_t)(C + 2 * F) * P) *
         sizeof(float);
}

struct K1Tf32 {
  const float* x;
  const float *w1n, *b1n, *b1, *kdw, *bk;
  const float* W1;
  float* g;
  float* t;     // [N, 2C, HWp]
  float* part;  // [N, DX, C]: the depthwise blocks' sums of g
  int C, H, W;
  long long HW, HWp;
  int tiles;  // pixel tiles per image
  int vec;    // x rows allow 16-byte loads
  float eps;
};

// ---------------------------------------------------------------------------
// k1_front_tf32_kernel: grid (BX, N), block kThreads; block (bx, n) walks
// the pixel tiles bx, bx + BX, ... of image n. RES (C <= 64): W1 stays in
// shared memory from the first tile to the last.
// ---------------------------------------------------------------------------

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kFwdResidentBlocks : 2)
    k1_front_tf32_kernel(const K1Tf32 a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);  // [C][P]
  float* h_s = x_s + (size_t)C * P;                 // [C][LDB]
  float* W1_s = h_s + (size_t)C * LDB;              // RES: W1 [2C][ld]
  const int ld = ldr_of(C);
  __shared__ float red_s[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* xn = a.x + (long long)n * C * HW;
  float* tn = a.t + (long long)n * 2 * C * HWp;
  const bool vec = a.vec != 0;

  if (RES) {
    fill_rows_f(W1_s, a.W1, 2 * C, C, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;
    const bool valid = p0 + px < HW;

    // ---- x -> x_s; LN1 statistics; h = xhat w1n + b1n -> h_s
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8];
      load8f(xn + (long long)c * HW, p0 + j, HW, vec, xv);
      store8f(x_s + c * P + j, xv);
    }
    __syncthreads();
    float mu, rstd;
    ln_stats<P>(x_s, C, red_s, grp, px, a.eps, mu, rstd);
    for (int c = grp; c < C; c += G) {
      const float xh = (x_s[c * P + px] - mu) * rstd;
      h_s[c * LDB + px] = valid ? fmaf(xh, a.w1n[c], a.b1n[c]) : 0.f;
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
      tile_gemm_tf32<P, false, false>(W1_s, ld, 2 * C, C, h_s, epi);
    else
      tile_gemm_tf32<P, false, true>(a.W1, C, 2 * C, C, h_s, epi);
  }
}

// ---------------------------------------------------------------------------
// k2_tf32_kernel: grid (BX, N), block kThreads; block (bx, n) walks the
// pixel tiles bx, bx + BX, ... of image n, P pixels each. RES (C, F <= 64):
// W3, W4, W5 stay in shared memory from the first tile to the last.
// ---------------------------------------------------------------------------

struct K2Tf32 {
  const float *x, *g;
  const float* att;
  const float *W3, *W4, *W5;
  const float *b3, *w2n, *b2n, *b4, *b5, *beta, *gamma;
  float* out;
  int C, F;
  long long HW;
  int tiles;  // pixel tiles per image
  int vec;    // x, g, out rows allow 16-byte loads and stores
  float eps;
};

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kFwdResidentBlocks : 2)
    k2_tf32_kernel(const K2Tf32 a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int CH4 = P / 4;  // 16-byte chunks of a tile row
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C, F = a.F;
  const long long HW = a.HW;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hq_s = reinterpret_cast<float*>(smem_raw);  // v, h2, then wv
  float* wts = hq_s + (size_t)imax(C, F) * LDB;      // RES: W3, W4, W5
  const int ld_c = ldr_of(C), ld_f = ldr_of(F);
  float* W3_s = wts;
  float* W4_s = W3_s + (size_t)C * ld_c;
  float* W5_s = W4_s + (size_t)2 * F * ld_c;
  float* z_s = wts + (RES ? resident_elems(C, F) : 0);  // [C][P]
  float* q_s = z_s + (size_t)C * P;                     // [2F][P]
  __shared__ float red_s[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* attn = a.att + (long long)n * C;
  const float* xn = a.x + (long long)n * C * HW;
  const float* gn = a.g + (long long)n * C * HW;
  float* on = a.out + (long long)n * C * HW;
  const bool vec = a.vec != 0;

  if (RES) {
    fill_rows_f(W3_s, a.W3, C, C, ld_c);
    fill_rows_f(W4_s, a.W4, 2 * F, C, ld_c);
    fill_rows_f(W5_s, a.W5, C, F, ld_f);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // the product W act of this tile: from the resident copy of W, or from W
  // in global memory
  auto product = [&](const float* Wg, const float* Ws, int cols, int M,
                     int K, auto&& epi) {
    if constexpr (RES)
      tile_gemm_tf32<P, false, false>(Ws, ldr_of(cols), M, K, hq_s, epi);
    else
      tile_gemm_tf32<P, false, true>(Wg, cols, M, K, hq_s, epi);
  };

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;

    // ---- load: v = g att -> hq; z = x
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8], gv[8];
      load8f(xn + (long long)c * HW, p0 + j, HW, vec, xv);
      load8f(gn + (long long)c * HW, p0 + j, HW, vec, gv);
      const float at = attn[c];
#pragma unroll
      for (int e = 0; e < 8; ++e) gv[e] *= at;
      store8f(hq_s + c * LDB + j, gv);
      store8f(z_s + c * P + j, xv);
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

    // ---- LN2: h2 = xhat2 w2n + b2n -> hq (v is dead: the product ended
    //      with a barrier)
    float mu, rstd;
    ln_stats<P>(z_s, C, red_s, grp, px, a.eps, mu, rstd);
    for (int c = grp; c < C; c += G)
      hq_s[c * LDB + px] =
          fmaf((z_s[c * P + px] - mu) * rstd, a.w2n[c], a.b2n[c]);
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

    // ---- gate: wv = q1 q2 -> hq (h2 is dead)
    for (int f = grp; f < F; f += G)
      hq_s[f * LDB + px] = q_s[f * P + px] * q_s[(F + f) * P + px];
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

    // ---- store out in fp32, 16 bytes a thread where the row allows it
    for (int idx = tid; idx < C * CH4; idx += kThreads) {
      const int c = idx / CH4, j = (idx % CH4) * 4;
      const long long p = p0 + j;
      if (p >= HW) continue;
      const float4 v = *reinterpret_cast<const float4*>(z_s + c * P + j);
      float* dst = on + (long long)c * HW + p;
      if (vec && p + 4 <= HW) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (p + k < HW) dst[k] = e[k];
      }
    }
    __syncthreads();  // z_s is read above and refilled by the next tile
  }
}

}  // namespace nafblk
