// K3 and K4 in fp32 on the tensor cores, as three TF32 products each
// ("3xTF32"), included by nafblock_bwd.cu. See that file's header for what
// K3 and K4 compute and their bounds. The kernels follow the bf16 design of
// nafblock_p1_mma.cuh and nafblock_p2_mma.cuh step by step; what differs:
//
// The product. One TF32 product keeps 11 bits of each operand, which the
// 1e-4 tolerance of fp32 does not allow. Each operand is split in
// registers, a = hi(a) + lo(a) with hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna), once per fragment load, and three
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 add lo.hi + hi.lo +
// hi.hi into the fp32 accumulators (the small terms first): ~22 bits of
// each product, at a third of the card's 495 TFLOP/s of TF32, still 2.5x
// the 67 TFLOP/s of fp32 FMA that bounds the first port's kernels.
// Fragment layout (PTX ISA, mma.m16n8k8 .tf32, g = lane / 4, t = lane % 4):
//   a0 (row g, k t)  a1 (row g + 8, k t)  a2 (row g, k t + 4)  a3 (g + 8, t + 4)
//   b0 (k t, col g)  b1 (k t + 4, col g)
//   c0, c1 (row g, cols 2t, 2t + 1)  c2, c3 (row g + 8, same cols)
// so the accumulators, and every epilogue, are those of the bf16 kernels.
//
// Shared memory. Every operand is fp32 [channels][P] (twice the bytes of
// bf16). ldmatrix.trans moves 16-bit elements only, so fragments are
// loaded by 32-bit ld.shared: the rows of the operand arrays (ldb_of) and
// of the resident weights (ldr_of) are an odd multiple of 8 words apart,
// so the 32 lanes of a B fragment, or of the A fragment of a transposed
// weight (row t, column g), hit the 32 banks 8t + g; the A fragment of a
// weight as it lies (row g, column t) meets two-way conflicts. Up to
// C = F = 64 the weights stay resident, 4 C^2 fp32 for K3 (36 KB at
// C = 48); above, a warp reads its A fragments straight from global memory
// (L2: every tile reads each weight once, as the bf16 ring of slabs does,
// and a slab is read by one warp only), 16 contraction indices ahead, and
// no shared memory goes to weights: K3 fits at C = F = 1024 with 8 pixels.
//
// Streams and sums. The operand streams of the weight gradients are fp32
// [N, rows, HWp]; every vector gradient is a fixed-order sum of per-block
// partial rows (sum_rows), no float atomics: two runs give the same bits.

#pragma once

#include <cstdint>
#include <type_traits>

#include "nafblock_p2_mma.cuh"
#include "tf32_mma.cuh"

namespace nafblk {

// ---------------------------------------------------------------------------
// K3 in fp32: k3_tf32_kernel, the counterpart of k3_mma_kernel (same grid,
// phases, partials and streams; every operand fp32)
// ---------------------------------------------------------------------------

// Dynamic shared memory of k3_tf32_kernel with P pixels per tile:
// v|h2, wv -> dq (max(C + F, 2F) rows) and ds -> dp (C rows) at the
// operand stride, z, pth (C rows each) and q (2F rows) at P, and the
// resident weights with the vectors and partials (RES only).
inline size_t k3_tf32_smem(int C, int F, int P) {
  const size_t hq_rows = (size_t)imax(C + F, 2 * F);
  const size_t weights =
      resident(C, F) ? resident_elems(C, F) + resident_floats(C, F) : 0;
  return ((hq_rows + C) * ldb_of(P) + (size_t)(2 * C + 2 * F) * P + weights) *
         sizeof(float);
}

struct K3Tf32 {
  const float *x, *g, *dout;
  const float* att;
  const float *W3, *W4, *W5;
  const float *b3, *w2n, *b2n, *b4, *b5, *beta, *gamma;
  float *dz, *v_o, *h2_o, *wv_o, *ds_o, *dq_o, *dp_o;
  float *vpart, *dapart;
  int C, F;
  long long HW, HWp;
  int tiles;
  int vec;  // x, g, dout rows allow 16-byte loads
  float eps;
};

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kResidentBlocks : 2)
    k3_tf32_kernel(const K3Tf32 a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;  // 8-pixel chunks per channel row
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C, F = a.F;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hq_s = reinterpret_cast<float*>(smem_raw);  // v | h2, wv, then dq
  float* d_s = hq_s + (size_t)imax(C + F, 2 * F) * LDB;  // ds, then dp
  float* z_s = d_s + (size_t)C * LDB;  // z, then xhat2
  float* p_s = z_s + (size_t)C * P;    // pth
  float* q_s = p_s + (size_t)C * P;    // q [2F], then dh2 [C]
  const int ld_c = ldr_of(C), ld_f = ldr_of(F);
  float* W3_s = q_s + (size_t)2 * F * P;  // RES: W3, W4, W5, then vectors
  float* W4_s = W3_s + (size_t)C * ld_c;
  float* W5_s = W4_s + (size_t)2 * F * ld_c;
  float* par_s = W5_s + (size_t)C * ld_f;
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* attn = a.att + (long long)n * C;
  float* vp_g = a.vpart + ((long long)n * gridDim.x + blockIdx.x) *
                              (6 * C + 2 * F);
  float* dap_g = a.dapart + ((long long)n * gridDim.x + blockIdx.x) * C;
  const float* xn = a.x + (long long)n * C * HW;
  const float* gn = a.g + (long long)n * C * HW;
  const float* don = a.dout + (long long)n * C * HW;
  float* dzn = a.dz + (long long)n * C * HW;
  const bool vec = a.vec != 0;

  const float *b3 = a.b3, *w2n = a.w2n, *b2n = a.b2n, *b4 = a.b4, *b5 = a.b5,
              *beta = a.beta, *gamma = a.gamma;
  float *vp = vp_g, *dap = dap_g;
  if (RES) {
    float* f = par_s;
    auto take = [&](const float* src, int count) {
      for (int i = tid; i < count; i += kThreads) f[i] = src[i];
      const float* got = f;
      f += count;
      return got;
    };
    b3 = take(a.b3, C);
    w2n = take(a.w2n, C);
    b2n = take(a.b2n, C);
    b4 = take(a.b4, 2 * F);
    b5 = take(a.b5, C);
    beta = take(a.beta, C);
    gamma = take(a.gamma, C);
    vp = f;
    dap = vp + 6 * C + 2 * F;
    for (int i = tid; i < 7 * C + 2 * F; i += kThreads) vp[i] = 0.f;
    fill_rows_f(W3_s, a.W3, C, C, ld_c);
    fill_rows_f(W4_s, a.W4, 2 * F, C, ld_c);
    fill_rows_f(W5_s, a.W5, C, F, ld_f);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // the product W act (or W^T act) of this tile: from the resident copy
  // of W, or from W in global memory
  auto product = [&](auto trans, const float* Wg, const float* Ws, int cols,
                     int M, int K, const float* Bs, auto&& epi) {
    constexpr bool T = decltype(trans)::value;
    if constexpr (RES)
      tile_gemm_tf32<P, T, false>(Ws, ldr_of(cols), M, K, Bs, epi);
    else
      tile_gemm_tf32<P, T, true>(Wg, cols, M, K, Bs, epi);
  };
  constexpr std::false_type as_is{};
  constexpr std::true_type transposed{};

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const bool first = !RES && tile == (int)blockIdx.x;
    const long long p0 = (long long)tile * P;
    auto put = [&](float* dst, float v) {
      *dst = first ? v : *dst + v;
    };

    // ---- load: v = g * att -> hq[0, C); z = x; ds = gamma * dout -> d;
    //      db5 = sum ds
    const int chunks = C * CH;
    for (int i0 = 0; i0 < chunks; i0 += kThreads) {
      const int idx = i0 + tid;
      const bool ok = idx < chunks;
      const int c = ok ? idx / CH : 0, j = (idx % CH) * 8;
      float xv[8], gv[8], dv[8];
      load8f(xn + (long long)c * HW, p0 + j, ok ? HW : 0, vec, xv);
      load8f(gn + (long long)c * HW, p0 + j, ok ? HW : 0, vec, gv);
      load8f(don + (long long)c * HW, p0 + j, ok ? HW : 0, vec, dv);
      const float at = attn[c], gm = gamma[c];
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        gv[e] *= at;
        dv[e] *= gm;
        sum += dv[e];
      }
      // the CH lanes of one channel row are neighbours
#pragma unroll
      for (int o = CH / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (ok) {
        store8f(hq_s + c * LDB + j, gv);
        store8f(d_s + c * LDB + j, dv);
        store8f(z_s + c * P + j, xv);
        if (j == 0) put(vp + C + c, sum);
      }
    }
    __syncthreads();
    store_stream_f<P>(a.v_o + (long long)n * C * HWp, hq_s, C, p0, HWp);
    store_stream_f<P>(a.ds_o + (long long)n * C * HWp, d_s, C, p0, HWp);

    // ---- conv3: pth = W3 v + b3; z = x + beta * pth
    product(
        as_is, a.W3, W3_s, C, C, C, hq_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = row0 + gq + 8 * h;
            const float bb = b3[o], be = beta[o];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = 8 * nt + 2 * tq;
              const float u0 = acc[nt][2 * h] + bb;
              const float u1 = acc[nt][2 * h + 1] + bb;
              *reinterpret_cast<float2*>(p_s + o * P + col) =
                  make_float2(u0, u1);
              float2* zz = reinterpret_cast<float2*>(z_s + o * P + col);
              float2 zv = *zz;
              zv.x = fmaf(be, u0, zv.x);
              zv.y = fmaf(be, u1, zv.y);
              *zz = zv;
            }
          }
        });

    // ---- LN2: xhat2 (kept in z), h2 -> hq[0, C)
    float mu, rstd;
    ln_stats<P>(z_s, C, red_s, grp, px, a.eps, mu, rstd);
    for (int c = grp; c < C; c += G) {
      const float xh = (z_s[c * P + px] - mu) * rstd;
      z_s[c * P + px] = xh;
      hq_s[c * LDB + px] = fmaf(xh, w2n[c], b2n[c]);
    }
    __syncthreads();
    store_stream_f<P>(a.h2_o + (long long)n * C * HWp, hq_s, C, p0, HWp);

    // ---- conv4: q = W4 h2 + b4
    product(
        as_is, a.W4, W4_s, C, 2 * F, C, hq_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = row0 + gq + 8 * h;
            const float bb = b4[o];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              *reinterpret_cast<float2*>(q_s + o * P + 8 * nt + 2 * tq) =
                  make_float2(acc[nt][2 * h] + bb, acc[nt][2 * h + 1] + bb);
          }
        });

    // ---- gate: wv = q1 * q2 -> hq[C, C + F)
    float* wv_s = hq_s + (size_t)C * LDB;
    for (int f = grp; f < F; f += G)
      wv_s[f * LDB + px] = q_s[f * P + px] * q_s[(F + f) * P + px];
    __syncthreads();
    store_stream_f<P>(a.wv_o + (long long)n * F * HWp, wv_s, F, p0, HWp);

    // ---- conv5: s = W5 wv + b5; dgamma = sum dout * s
    product(
        as_is, a.W5, W5_s, F, C, F, wv_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = row0 + gq + 8 * h;
            const float bb = b5[o];
            const float* drow = don + (long long)o * HW;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const long long p = p0 + 8 * nt + 2 * tq;
              const float d0 = p < HW ? __ldg(drow + p) : 0.f;
              const float d1 = p + 1 < HW ? __ldg(drow + p + 1) : 0.f;
              sum = fmaf(d0, acc[nt][2 * h] + bb, sum);
              sum = fmaf(d1, acc[nt][2 * h + 1] + bb, sum);
            }
            sum = quad_sum(sum);
            if (tq == 0) put(vp + o, sum);
          }
        });

    // ---- dwv = W5^T ds; dq = (dwv * q2, dwv * q1) -> hq[0, 2F); db4
    product(
        transposed, a.W5, W5_s, F, F, C, d_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = row0 + gq + 8 * h;
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = 8 * nt + 2 * tq;
              const float2 q1 =
                  *reinterpret_cast<const float2*>(q_s + f * P + col);
              const float2 q2 =
                  *reinterpret_cast<const float2*>(q_s + (F + f) * P + col);
              const float a0 = acc[nt][2 * h] * q2.x;
              const float a1 = acc[nt][2 * h + 1] * q2.y;
              const float c0 = acc[nt][2 * h] * q1.x;
              const float c1 = acc[nt][2 * h + 1] * q1.y;
              s1 += a0 + a1;
              s2 += c0 + c1;
              *reinterpret_cast<float2*>(hq_s + f * LDB + col) =
                  make_float2(a0, a1);
              *reinterpret_cast<float2*>(hq_s + (F + f) * LDB + col) =
                  make_float2(c0, c1);
            }
            s1 = quad_sum(s1);
            s2 = quad_sum(s2);
            if (tq == 0) {
              put(vp + 2 * C + f, s1);
              put(vp + 2 * C + F + f, s2);
            }
          }
        });
    store_stream_f<P>(a.dq_o + (long long)n * 2 * F * HWp, hq_s, 2 * F, p0,
                      HWp);

    // ---- dh2 = W4^T dq -> q[0, C) (q is dead); dw2n, db2n
    product(
        transposed, a.W4, W4_s, C, C, 2 * F, hq_s,
        [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = row0 + gq + 8 * h;
            float sw = 0.f, sb = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = 8 * nt + 2 * tq;
              const float2 xh =
                  *reinterpret_cast<const float2*>(z_s + c * P + col);
              const float d0 = acc[nt][2 * h], d1 = acc[nt][2 * h + 1];
              sw = fmaf(d0, xh.x, sw);
              sw = fmaf(d1, xh.y, sw);
              sb += d0 + d1;
              *reinterpret_cast<float2*>(q_s + c * P + col) =
                  make_float2(d0, d1);
            }
            sw = quad_sum(sw);
            sb = quad_sum(sb);
            if (tq == 0) {
              put(vp + 2 * C + 2 * F + c, sw);
              put(vp + 3 * C + 2 * F + c, sb);
            }
          }
        });

    // ---- LN2 backward: dz = dout + LN2^T(dh2); dbeta, dp -> d, db3
    float sg = 0.f, sgx = 0.f;
    for (int c = grp; c < C; c += G) {
      const float gxh = q_s[c * P + px] * w2n[c];
      sg += gxh;
      sgx = fmaf(gxh, z_s[c * P + px], sgx);
    }
    groups_sum2<P>(sg, sgx, red_s, grp, px);
    const float mean_g = sg / C, mean_gx = sgx / C;
    const bool valid = p0 + px < HW;
    const int it_g = (C + G - 1) / G;
    for (int it = 0; it < it_g; ++it) {
      const int c = it * G + grp;
      const bool ok = c < C;
      float dzv = 0.f, pth = 0.f, dp = 0.f;
      if (ok && valid) {
        const long long o = (long long)c * HW + p0 + px;
        const float gxh = q_s[c * P + px] * w2n[c];
        dzv = __ldg(don + o) +
              (gxh - mean_g - z_s[c * P + px] * mean_gx) * rstd;
        pth = p_s[c * P + px];
        dp = beta[c] * dzv;
        dzn[o] = dzv;
      }
      const float s_beta = group_sum<P>(dzv * pth);
      const float s_b3 = group_sum<P>(dp);
      if (ok) {
        d_s[c * LDB + px] = dp;
        if (px == 0) {
          put(vp + 4 * C + 2 * F + c, s_beta);
          put(vp + 5 * C + 2 * F + c, s_b3);
        }
      }
    }
    __syncthreads();
    store_stream_f<P>(a.dp_o + (long long)n * C * HWp, d_s, C, p0, HWp);

    // ---- dv = W3^T dp; da[n, c] = sum_p dv * g
    product(
        transposed, a.W3, W3_s, C, C, C, d_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = row0 + gq + 8 * h;
            const float* grow = gn + (long long)c * HW;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const long long p = p0 + 8 * nt + 2 * tq;
              const float g0 = p < HW ? __ldg(grow + p) : 0.f;
              const float g1 = p + 1 < HW ? __ldg(grow + p + 1) : 0.f;
              sum = fmaf(acc[nt][2 * h], g0, sum);
              sum = fmaf(acc[nt][2 * h + 1], g1, sum);
            }
            sum = quad_sum(sum);
            if (tq == 0) put(dap + c, sum);
          }
        });
  }
  if (RES) {  // the last product ended with a barrier
    for (int i = tid; i < 6 * C + 2 * F; i += kThreads) vp_g[i] = vp[i];
    for (int i = tid; i < C; i += kThreads) dap_g[i] = dap[i];
  }
}

// ---------------------------------------------------------------------------
// wgrad_tf32_kernel: the weight gradients of K3 (three products) or K4
// (one) in one launch, the counterpart of wgrad_mma_kernel: the same grid,
// tiles, pixel chunks and partial rows, fp32 streams [N, rows, HWp] staged
// 32 pixels at a time by cp.async, double-buffered, with a row stride of
// 36 words (the 32 lanes of a fragment, row g and word t, hit bank
// 4g + t).
// ---------------------------------------------------------------------------

constexpr int kGLdF = kGK + 4;  // fp32 stage row stride (words)

struct WgradTf32Product {
  const float *A, *B;
  int M, Nc;
  long long off;  // offset of out_q in a partial row
  int tile0;      // first block index of this product
};

struct WgradTf32 {
  WgradTf32Product prod[3];
  float* part;
  long long V;  // floats in a partial row
  long long HWp, L;
};

__global__ void __launch_bounds__(kThreads) wgrad_tf32_kernel(
    const WgradTf32 a) {
  __shared__ __align__(16) float As[2][kGT * kGLdF];
  __shared__ __align__(16) float Bs[2][kGT * kGLdF];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int q = (int)blockIdx.x >= a.prod[2].tile0
                    ? 2 : ((int)blockIdx.x >= a.prod[1].tile0 ? 1 : 0);
  const WgradTf32Product pr = a.prod[q];
  const int tile = blockIdx.x - pr.tile0;
  const int tiles_c = (pr.Nc + kGT - 1) / kGT;
  const int i0 = (tile / tiles_c) * kGT, j0 = (tile % tiles_c) * kGT;
  const int s = blockIdx.y, n = blockIdx.z;
  const long long pa = (long long)s * a.L;
  const long long pb = pa + a.L < a.HWp ? pa + a.L : a.HWp;
  const float* An = pr.A + (long long)n * pr.M * a.HWp;
  const float* Bn = pr.B + (long long)n * pr.Nc * a.HWp;

  // two 16-byte chunks (4 pixels) of A and of B per thread and stage
  auto stage = [&](long long k0, int b) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * kThreads;
      const int lr = idx >> 3, lc = (idx & 7) * 4;
      const bool okp = k0 + lc < pb;
      float* da = &As[b][lr * kGLdF + lc];
      float* db = &Bs[b][lr * kGLdF + lc];
      if (okp && i0 + lr < pr.M)
        cp_async16(da, An + (long long)(i0 + lr) * a.HWp + k0 + lc);
      else
        *reinterpret_cast<float4*>(da) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (okp && j0 + lr < pr.Nc)
        cp_async16(db, Bn + (long long)(j0 + lr) * a.HWp + k0 + lc);
      else
        *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;

  const int stages = (int)((pb - pa + kGK - 1) / kGK);
  if (stages > 0) stage(pa, 0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      stage(pa + (long long)(st + 1) * kGK, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ab = As[st & 1] + (wm + gq) * kGLdF + tq;
    const float* Bb = Bs[st & 1] + (wn + gq) * kGLdF + tq;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 8) {
      const float av[4] = {Ab[kk], Ab[8 * kGLdF + kk], Ab[kk + 4],
                           Ab[8 * kGLdF + kk + 4]};
      const FragA af = split_a(av);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = Bb + nt * 8 * kGLdF + kk;
        mma_3xtf32(acc[nt], af, bp[0], bp[4]);
      }
    }
    __syncthreads();
  }

  float* out = a.part + ((long long)n * gridDim.y + s) * a.V + pr.off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wm + gq + 8 * h;
    if (i >= pr.M) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + wn + 8 * nt + 2 * tq;
      if (j < pr.Nc)
        *reinterpret_cast<float2*>(out + (long long)i * pr.Nc + j) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 in fp32: k4_front_tf32_kernel -> k4_dw_kernel<K4Tf32> ->
// k4_back_tf32_kernel -> wgrad_tf32_kernel, the counterparts of the bf16
// kernels of nafblock_p2_mma.cuh with fp32 streams h, dt.
// ---------------------------------------------------------------------------

// Dynamic shared memory of the two pixel-tile kernels with P pixels.
//   front: x fp32 [C][P], h then pr fp32 [C][ldb], W1 and W3 (RES)
//   back:  dt fp32 [2C][ldb] (then dz [C][P]), xhat and dh fp32 [C][P]
//   each, W1 (RES)
inline size_t k4_front_tf32_smem(int C, int P) {
  const size_t w = p2_resident(C) ? (size_t)3 * C * ldr_of(C) : 0;
  return ((size_t)C * P + (size_t)C * ldb_of(P) + w) * sizeof(float);
}
inline size_t k4_back_tf32_smem(int C, int P) {
  const size_t w = p2_resident(C) ? (size_t)2 * C * ldr_of(C) : 0;
  return ((size_t)2 * C * ldb_of(P) + (size_t)2 * C * P + w) * sizeof(float);
}

struct K4Tf32 {
  const float *x, *dz;
  const float *dgc, *att, *w1n, *b1n, *b1, *kdw, *bk, *beta;
  const float *W1, *W3;
  float* dx;
  float *h_o, *dt_o;     // operand streams [N, rows, HWp]
  float *t_o, *dg_o;     // [N, 2C, HWp], [N, C, HWp]
  float *mu_o, *rstd_o;  // [N, HW]
  float *dwpart, *bpart;  // [N * DX][11][2C], [N * BX][2C]
  int C, H, W;
  long long HW, HWp;
  int tiles;  // pixel tiles per image
  int vec;    // x, dz rows allow 16-byte loads
  float eps;
};

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kP2ResidentBlocks : 2)
    k4_front_tf32_kernel(const K4Tf32 a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);  // [C][P]
  float* h_s = x_s + (size_t)C * P;                 // [C][LDB]: h, then pr
  const int ld = ldr_of(C);
  float* W1_s = h_s + (size_t)C * LDB;  // RES: W1 [2C] and W3 [C] rows
  float* W3_s = W1_s + (size_t)2 * C * ld;
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* xn = a.x + (long long)n * C * HW;
  const float* dzn = a.dz + (long long)n * C * HW;
  float* hn = a.h_o + (long long)n * C * HWp;
  float* dtn = a.dt_o + (long long)n * 2 * C * HWp;
  float* tn = a.t_o + (long long)n * 2 * C * HWp;
  float* dgn = a.dg_o + (long long)n * C * HWp;
  const float* attn = a.att + (long long)n * C;
  const float* dgcn = a.dgc + (long long)n * C;
  const bool vec = a.vec != 0;

  if (RES) {
    fill_rows_f(W1_s, a.W1, 2 * C, C, ld);
    fill_rows_f(W3_s, a.W3, C, C, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  auto product = [&](auto trans, const float* Wg, const float* Ws, int M,
                     int K, const float* Bs, auto&& epi) {
    constexpr bool T = decltype(trans)::value;
    if constexpr (RES)
      tile_gemm_tf32<P, T, false>(Ws, ld, M, K, Bs, epi);
    else
      tile_gemm_tf32<P, T, true>(Wg, C, M, K, Bs, epi);
  };
  constexpr std::false_type as_is{};
  constexpr std::true_type transposed{};

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;
    const long long p = p0 + px;
    const bool valid = p < HW;

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
    if (grp == 0 && valid) {
      a.mu_o[(long long)n * HW + p] = mu;
      a.rstd_o[(long long)n * HW + p] = rstd;
    }
    // dt at the padding pixels [HW, HWp) of this tile: 0 (dW1's operand)
    const long long pad0 = p0 > HW ? p0 : HW;
    const long long pad1 = p0 + P < HWp ? p0 + P : HWp;
    if (pad0 < pad1) {
      const int w = (int)(pad1 - pad0);
      for (int i = tid; i < 2 * C * w; i += kThreads)
        dtn[(long long)(i / w) * HWp + pad0 + i % w] = 0.f;
    }
    __syncthreads();
    store_stream_f<P>(hn, h_s, C, p0, HWp);

    // ---- t = W1 h + b1 (fp32 out)
    product(as_is, a.W1, W1_s, 2 * C, C, h_s,
            [&](int row0, float(&acc)[NT][4]) {
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
            });

    // ---- pr = beta dz -> h_s (h is dead: the product ended with a
    //      barrier)
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float dv[8];
      load8f(dzn + (long long)c * HW, p0 + j, HW, vec, dv);
      const float be = a.beta[c];
#pragma unroll
      for (int e = 0; e < 8; ++e) dv[e] *= be;
      store8f(h_s + c * LDB + j, dv);
    }
    __syncthreads();

    // ---- dv = W3^T pr; dg = dv att + dgc (fp32 out)
    product(transposed, a.W3, W3_s, C, C, h_s,
            [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int j = row0 + gq + 8 * hh;
                const float at = attn[j], dc = dgcn[j];
                float* grow = dgn + (long long)j * HWp + p0;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  const int col = 8 * nt + 2 * tq;
                  if (p0 + col < HWp)
                    *reinterpret_cast<float2*>(grow + col) =
                        make_float2(fmaf(acc[nt][2 * hh], at, dc),
                                    fmaf(acc[nt][2 * hh + 1], at, dc));
                }
              }
            });
  }
}

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kP2ResidentBlocks : 2)
    k4_back_tf32_kernel(const K4Tf32 a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int CH4 = P / 4;  // 16-byte chunks of a stream row
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);  // [2C][LDB]
  float* x_s = dt_s + (size_t)2 * C * LDB;           // xhat [C][P]
  float* dh_s = x_s + (size_t)C * P;
  float* wts = dh_s + (size_t)C * P;  // RES: W1 [2C][ld]
  const int ld = ldr_of(C);
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const float* xn = a.x + (long long)n * C * HW;
  const float* dzn = a.dz + (long long)n * C * HW;
  const float* dtn = a.dt_o + (long long)n * 2 * C * HWp;
  const float* mun = a.mu_o + (long long)n * HW;
  const float* rsn = a.rstd_o + (long long)n * HW;
  float* dxn = a.dx + (long long)n * C * HW;
  float* vp = a.bpart + ((long long)n * gridDim.x + blockIdx.x) * 2 * C;
  const bool vec = a.vec != 0;

  if (RES) {
    fill_rows_f(wts, a.W1, 2 * C, C, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const long long p0 = (long long)tile * P;
    auto put = [&](float* dst, float v) { *dst = first ? v : *dst + v; };

    // ---- dt -> dt_s (16 bytes a thread); xhat = (x - mu) rstd -> x_s
    for (int idx = tid; idx < 2 * C * CH4; idx += kThreads) {
      const int rw = idx / CH4, j = (idx % CH4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p0 + j < HWp)
        v = *reinterpret_cast<const float4*>(dtn + (long long)rw * HWp + p0 +
                                             j);
      *reinterpret_cast<float4*>(dt_s + rw * LDB + j) = v;
    }
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8];
      load8f(xn + (long long)c * HW, p0 + j, HW, vec, xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long q = p0 + j + e;
        xv[e] = q < HW ? (xv[e] - mun[q]) * rsn[q] : 0.f;
      }
      store8f(x_s + c * P + j, xv);
    }
    __syncthreads();

    // ---- dh = W1^T dt -> dh_s; dw1n = sum dh xhat, db1n = sum dh
    auto epi = [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = row0 + gq + 8 * hh;
        float sw = 0.f, sb = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = 8 * nt + 2 * tq;
          const float2 xh = *reinterpret_cast<const float2*>(x_s + c * P + col);
          const float d0 = acc[nt][2 * hh], d1 = acc[nt][2 * hh + 1];
          sw = fmaf(d0, xh.x, sw);
          sw = fmaf(d1, xh.y, sw);
          sb += d0 + d1;
          *reinterpret_cast<float2*>(dh_s + c * P + col) = make_float2(d0, d1);
        }
        sw = quad_sum(sw);
        sb = quad_sum(sb);
        if (tq == 0) {
          put(vp + c, sw);
          put(vp + C + c, sb);
        }
      }
    };
    if constexpr (RES)
      tile_gemm_tf32<P, true, false>(wts, ld, C, 2 * C, dt_s, epi);
    else
      tile_gemm_tf32<P, true, true>(a.W1, C, C, 2 * C, dt_s, epi);

    // ---- LN1 backward: dx = LN1^T(dh) + dz. dz goes to the space of dt_s
    //      (free since the product's last barrier) as fp32 [C][P], its
    //      loads in flight while the per-pixel sums are taken
    float* dz_s = dt_s;
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float dv[8];
      load8f(dzn + (long long)c * HW, p0 + j, HW, vec, dv);
      store8f(dz_s + c * P + j, dv);
    }
    float sg = 0.f, sgx = 0.f;
    for (int c = grp; c < C; c += G) {
      const float gxh = dh_s[c * P + px] * a.w1n[c];
      sg += gxh;
      sgx = fmaf(gxh, x_s[c * P + px], sgx);
    }
    groups_sum2<P>(sg, sgx, red_s, grp, px);
    const float mean_g = sg / C, mean_gx = sgx / C;
    const long long p = p0 + px;
    if (p < HW) {
      const float r = rsn[p];
      for (int c = grp; c < C; c += G) {
        const long long o = (long long)c * HW + p;
        const float gxh = dh_s[c * P + px] * a.w1n[c];
        dxn[o] = (gxh - mean_g - x_s[c * P + px] * mean_gx) * r +
                 dz_s[c * P + px];
      }
    }
    __syncthreads();  // x_s, dh_s are read above and refilled next tile
  }
}

}  // namespace nafblk
