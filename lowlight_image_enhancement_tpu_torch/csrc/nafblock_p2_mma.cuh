// K4 in bf16: the NAFBlock's first-half backward in three kernels split
// where the depthwise stencil's halo is, plus one weight-gradient product
// (wgrad_mma_kernel of nafblock_p1_mma.cuh), included by nafblock_bwd.cu.
// See that file's header for what K4 computes and its bound.
//
//   k4_front_kernel (tensor cores, pixel tiles of P pixels of one image with
//     every channel): LN1 of x (mean, then the centred variance) ->
//     h = bf16(xhat w1n + b1n) -> t = W1 h + b1 (fp32 out); pr = bf16(beta
//     dz) -> dv = W3^T pr -> dg = dv att + dgc (fp32 out); LN1's mu and rstd
//     out. h also goes out as the bf16 operand stream of dW1.
//   k4_dw_kernel (CUDA cores, 2-D tiles of 32 x 32 pixels, one channel pair
//     (j, C + j) a block): u = dw3x3(t) + bk (t zero outside the image),
//     du = (dg u2, dg u1) (dg zero outside), dt = the adjoint with the
//     flipped taps (bf16 out), and the tap grads, dbk and db1 summed in
//     registers over every tile the block walks.
//   k4_back_kernel (tensor cores, pixel tiles): dh = W1^T dt; xhat from x
//     with the saved mu, rstd; dw1n, db1n as row sums inside a warp (a warp
//     owns 16 rows and all P pixels: a quad shuffle); LN1 backward's two
//     per-pixel means across the warps through shared memory;
//     dx = LN1^T(dh) + dz in dz's type.
//   dW1 = dt h^T: one wgrad_mma_kernel product.
// Every product is computed once per pixel (the old 2-D halo tiles
// recomputed LN1 and conv1 for every block of 16 gate channels). Vector
// grads go into one partial row per block, added by sum_rows in a fixed
// order: no float atomics, two calls give the same bits.
//
// The workspace streams: h and dt bf16 [N, rows, HWp], t and dg fp32
// [N, rows, HWp] (HWp = HW rounded up to 8, so rows stay 16-byte aligned);
// h is 0 and dt is 0 at the pixels in [HW, HWp), so dW1 sums nothing there.

#pragma once

#include "nafblock_p1_mma.cuh"

namespace nafblk {

// Up to this many channels W1 and W3 (3 C^2 bf16 values, rows padded by 8)
// stay in shared memory for every tile a block walks; above, the weights
// pass through the ring of slabs of tile_gemm.
constexpr int kP2ResidentMax = 64;
constexpr int kP2ResidentBlocks = 3;

__host__ __device__ inline bool p2_resident(int C) {
  return C <= kP2ResidentMax;
}

// Dynamic shared memory of the two pixel-tile kernels with P pixels.
//   front: x fp32 [C][P], h then pr bf16 [C][ldb], weights (W1 and W3, or
//   the slabs)
//   back:  dt bf16 [2C][ldb] (then dz fp32 [C][P]), xhat and dh fp32
//   [C][P] each, weights (W1, or the slabs)
inline size_t k4_front_smem(int C, int P) {
  const size_t w = p2_resident(C)
                       ? (size_t)3 * C * ldr_of(C) * sizeof(bf16)
                       : (size_t)kStages * kSlab * sizeof(bf16);
  return (size_t)C * P * sizeof(float) + (size_t)C * ldb_of(P) * sizeof(bf16) +
         w;
}
inline size_t k4_back_smem(int C, int P) {
  const size_t w = p2_resident(C)
                       ? (size_t)2 * C * ldr_of(C) * sizeof(bf16)
                       : (size_t)kStages * kSlab * sizeof(bf16);
  return (size_t)2 * C * ldb_of(P) * sizeof(bf16) +
         (size_t)2 * C * P * sizeof(float) + w;
}

struct K4Mma {
  const bf16 *x, *dz;
  const float *dgc, *att, *w1n, *b1n, *b1, *kdw, *bk, *beta;
  const bf16 *W1, *W3;
  bf16* dx;
  bf16 *h_o, *dt_o;   // operand streams [N, rows, HWp]
  float *t_o, *dg_o;  // [N, 2C, HWp], [N, C, HWp]
  float *mu_o, *rstd_o;  // [N, HW]
  float *dwpart, *bpart;  // [N * DX][11][2C], [N * BX][2C]
  int C, H, W;
  long long HW, HWp;
  int tiles;  // pixel tiles per image
  int vec;    // x, dz rows allow 16-byte loads
  float eps;
};

// ---------------------------------------------------------------------------
// k4_front_kernel: grid (BX, N), block kThreads; block (bx, n) walks the
// pixel tiles bx, bx + BX, ... of image n.
// ---------------------------------------------------------------------------

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kP2ResidentBlocks : 2)
    k4_front_kernel(const K4Mma a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);          // [C][P]
  bf16* h_s = reinterpret_cast<bf16*>(x_s + (size_t)C * P);  // h, then pr
  bf16* wts = h_s + (size_t)C * LDB;  // slabs, or W1 [2C] and W3 [C] rows
  const int ld = ldr_of(C);
  bf16* W1_s = wts;
  bf16* W3_s = wts + (size_t)2 * C * ld;
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const bf16* xn = a.x + (long long)n * C * HW;
  const bf16* dzn = a.dz + (long long)n * C * HW;
  bf16* hn = a.h_o + (long long)n * C * HWp;
  bf16* dtn = a.dt_o + (long long)n * 2 * C * HWp;
  float* tn = a.t_o + (long long)n * 2 * C * HWp;
  float* dgn = a.dg_o + (long long)n * C * HWp;
  const float* attn = a.att + (long long)n * C;
  const float* dgcn = a.dgc + (long long)n * C;
  const bool vec = a.vec != 0;

  if (RES) {
    auto fill = [&](bf16* dst, const bf16* src, int rows) {
      const int ch = C / 8;
      for (int i = tid; i < rows * ch; i += kThreads)
        cp_async16(dst + (i / ch) * ld + (i % ch) * 8,
                   src + (long long)(i / ch) * C + (i % ch) * 8);
    };
    fill(W1_s, a.W1, 2 * C);
    fill(W3_s, a.W3, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  auto product = [&](auto trans, const bf16* Wg, const bf16* Ws, int M,
                     int K, const bf16* Bs, auto&& epi) {
    constexpr bool T = decltype(trans)::value;
    if constexpr (RES)
      tile_gemm_resident<P, T>(Ws, ld, M, K, Bs, epi);
    else
      tile_gemm<P, T>(Wg, C, M, K, Bs, wts, epi);
  };
  constexpr std::false_type as_is{};
  constexpr std::true_type transposed{};

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * P;
    const long long p = p0 + px;
    const bool valid = p < HW;

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
        dtn[(long long)(i / w) * HWp + pad0 + i % w] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    store_stream<P>(hn, h_s, C, p0, HWp);

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

    // ---- pr = bf16(beta dz) -> h_s (h is dead: the product ended with a
    //      barrier)
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float dv[8];
      load8(dzn + (long long)c * HW, p0 + j, HW, vec, dv);
      const float be = a.beta[c];
#pragma unroll
      for (int e = 0; e < 8; ++e) dv[e] *= be;
      *reinterpret_cast<uint4*>(h_s + c * LDB + j) = pack8(dv);
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

// ---------------------------------------------------------------------------
// k4_dw_kernel: grid (C, DX, N), block kThreads. Block (j, d, n) takes the
// channel pair (j, C + j) of image n and walks its 2-D tiles d, d + DX, ...
// of kDwH x kDwW output pixels (kDwRows a thread, 8 rows apart). Writes
// its partial row dwpart[n * DX + d] at [k][j] and [k][C + j] for k < 9
// (the tap grads), k = 9 (dbk) and k = 10 (db1). Bound by bytes (t, dg in,
// dt out: 16 C bytes a pixel); a block's tile is a chain of three phases
// (loads, u and du on the ring, the own pixels), so a thread takes 4
// output pixels and issues all of a phase's loads at once.
// Args is K4Mma (dt out in bf16) or K4Tf32 of nafblock_tf32.cuh (dt out
// in fp32, the operand of the 3xTF32 products).
// ---------------------------------------------------------------------------

constexpr int kDwRows = 4;  // output rows a thread (8 rows apart)
constexpr int kDwH = 8 * kDwRows, kDwW = 32;     // output tile
constexpr int kDwTH = kDwH + 4, kDwTW = kDwW + 4;  // t with its 2-ring
constexpr int kDwUH = kDwH + 2, kDwUW = kDwW + 2;  // du with its 1-ring
constexpr int kDwRed = 22;  // per channel pair: 2 x (9 taps, dbk, db1)
// loads a thread issues per tile: t of both channels with its 2-ring, dg
// with its 1-ring
constexpr int kDwTLoads = (2 * kDwTH * kDwTW + kThreads - 1) / kThreads;
constexpr int kDwULoads = (kDwUH * kDwUW + kThreads - 1) / kThreads;
constexpr int kDwBlocks = 3;

__host__ __device__ inline int dw_tiles(int H, int W) {
  return ((H + kDwH - 1) / kDwH) * ((W + kDwW - 1) / kDwW);
}

__device__ __forceinline__ void store_dt(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_dt(float* p, float v) { *p = v; }

template <typename Args>
__global__ void __launch_bounds__(kThreads, kDwBlocks)
    k4_dw_kernel(const Args a) {
  __shared__ float t_s[2][kDwTH * kDwTW];
  __shared__ float du_s[2][kDwUH * kDwUW];
  __shared__ float red_s[kThreads / 32][kDwRed];

  const int C = a.C, H = a.H, W = a.W;
  const long long HWp = a.HWp;
  const int j = blockIdx.x, n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tiles_x = (W + kDwW - 1) / kDwW;
  const int tiles = dw_tiles(H, W);
  const float* ta = a.t_o + ((long long)n * 2 * C + j) * HWp;
  const float* tb = ta + (long long)C * HWp;
  const float* dgr = a.dg_o + ((long long)n * C + j) * HWp;
  auto* dta = a.dt_o + ((long long)n * 2 * C + j) * HWp;
  auto* dtb = dta + (long long)C * HWp;

  float ka[9], kb[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    ka[k] = a.kdw[j * 9 + k];
    kb[k] = a.kdw[(C + j) * 9 + k];
  }
  const float bka = a.bk[j], bkb = a.bk[C + j];
  // the pair's sums over the block's pixels: taps 0..8, dbk, db1 of j, then
  // of C + j
  float acc[kDwRed];
#pragma unroll
  for (int k = 0; k < kDwRed; ++k) acc[k] = 0.f;

  const int r = tid / kDwW, cl = tid % kDwW;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int r0 = (tile / tiles_x) * kDwH, c0 = (tile % tiles_x) * kDwW;
    // every load of a phase is issued before its first store to shared
    // memory (a store could alias a later load for the compiler, which
    // would then wait out each load in turn)
    float tv[kDwTLoads], dgv[kDwULoads];
#pragma unroll
    for (int it = 0; it < kDwTLoads; ++it) {
      const int i = tid + it * kThreads;
      const int ch = i / (kDwTH * kDwTW), q = i % (kDwTH * kDwTW);
      const int gr = r0 - 2 + q / kDwTW, gc = c0 - 2 + q % kDwTW;
      const bool in = i < 2 * kDwTH * kDwTW && gr >= 0 && gr < H && gc >= 0 &&
                      gc < W;
      tv[it] = in ? __ldg((ch ? tb : ta) + (long long)gr * W + gc) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kDwULoads; ++it) {
      const int q = tid + it * kThreads;
      const int gr = r0 - 1 + q / kDwUW, gc = c0 - 1 + q % kDwUW;
      const bool in = q < kDwUH * kDwUW && gr >= 0 && gr < H && gc >= 0 &&
                      gc < W;
      dgv[it] = in ? __ldg(dgr + (long long)gr * W + gc) : 0.f;
    }
    __syncthreads();  // the last tile's readers are done with t_s, du_s
#pragma unroll
    for (int it = 0; it < kDwTLoads; ++it) {
      const int i = tid + it * kThreads;
      if (i < 2 * kDwTH * kDwTW) (&t_s[0][0])[i] = tv[it];
    }
    __syncthreads();
    // u = dw3x3(t) + bk and du = (dg u2, dg u1) on the 1-ring; 0 outside
    // (dg is 0 there)
#pragma unroll
    for (int it = 0; it < kDwULoads; ++it) {
      const int q = tid + it * kThreads;
      if (q >= kDwUH * kDwUW) break;
      const int rr = q / kDwUW, cc = q % kDwUW;
      float ua = bka, ub = bkb;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int o = (rr + kh) * kDwTW + cc + kw;
          ua = fmaf(ka[kh * 3 + kw], t_s[0][o], ua);
          ub = fmaf(kb[kh * 3 + kw], t_s[1][o], ub);
        }
      du_s[0][q] = dgv[it] * ub;
      du_s[1][q] = dgv[it] * ua;
    }
    __syncthreads();
    // the thread's own pixels: dt (the flipped taps), tap grads, dbk, db1
#pragma unroll 1
    for (int i = 0; i < kDwRows; ++i) {
      const int rl = r + 8 * i;
      const int gr = r0 + rl, gc = c0 + cl;
      if (gr >= H || gc >= W) continue;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const float du = du_s[ch][(rl + 1) * kDwUW + cl + 1];
        float dt = 0.f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            dt = fmaf(ch ? kb[kh * 3 + kw] : ka[kh * 3 + kw],
                      du_s[ch][(rl + 2 - kh) * kDwUW + cl + 2 - kw], dt);
            acc[ch * 11 + kh * 3 + kw] =
                fmaf(du, t_s[ch][(rl + 1 + kh) * kDwTW + cl + 1 + kw],
                     acc[ch * 11 + kh * 3 + kw]);
          }
        acc[ch * 11 + 9] += du;
        acc[ch * 11 + 10] += dt;
        store_dt((ch ? dtb : dta) + (long long)gr * W + gc, dt);
      }
    }
  }

  // the block's sums: warps by shuffle, then the 8 warps in order
  const int warp = tid / 32;
#pragma unroll
  for (int k = 0; k < kDwRed; ++k) {
    const float v = warp_sum(acc[k]);
    if ((tid & 31) == 0) red_s[warp][k] = v;
  }
  __syncthreads();
  if (tid < kDwRed) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red_s[w][tid];
    const int ch = tid / 11, k = tid % 11;
    a.dwpart[((long long)n * gridDim.y + blockIdx.y) * 22 * C +
             (long long)k * 2 * C + ch * C + j] = s;
  }
}

// ---------------------------------------------------------------------------
// k4_back_kernel: grid (BX, N), block kThreads, the pixel tiles of
// k4_front_kernel. Partial row bpart[n * BX + bx] = [dw1n C | db1n C], the
// block's tiles added in order.
// ---------------------------------------------------------------------------

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kP2ResidentBlocks : 2)
    k4_back_kernel(const K4Mma a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dt_s = reinterpret_cast<bf16*>(smem_raw);  // [2C][LDB]
  float* x_s = reinterpret_cast<float*>(dt_s + (size_t)2 * C * LDB);  // xhat
  float* dh_s = x_s + (size_t)C * P;
  bf16* wts = reinterpret_cast<bf16*>(dh_s + (size_t)C * P);  // slabs or W1
  const int ld = ldr_of(C);
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int px = tid % P, grp = tid / P;
  const int n = blockIdx.y;
  const bf16* xn = a.x + (long long)n * C * HW;
  const bf16* dzn = a.dz + (long long)n * C * HW;
  const bf16* dtn = a.dt_o + (long long)n * 2 * C * HWp;
  const float* mun = a.mu_o + (long long)n * HW;
  const float* rsn = a.rstd_o + (long long)n * HW;
  bf16* dxn = a.dx + (long long)n * C * HW;
  float* vp = a.bpart + ((long long)n * gridDim.x + blockIdx.x) * 2 * C;
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
    const bool first = tile == (int)blockIdx.x;
    const long long p0 = (long long)tile * P;
    auto put = [&](float* dst, float v) { *dst = first ? v : *dst + v; };

    // ---- dt -> dt_s (16 bytes a thread); xhat = (x - mu) rstd -> x_s
    for (int idx = tid; idx < 2 * C * CH; idx += kThreads) {
      const int rw = idx / CH, j = (idx % CH) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + j < HWp)
        v = *reinterpret_cast<const uint4*>(dtn + (long long)rw * HWp + p0 +
                                            j);
      *reinterpret_cast<uint4*>(dt_s + rw * LDB + j) = v;
    }
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float xv[8];
      load8(xn + (long long)c * HW, p0 + j, HW, vec, xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long q = p0 + j + e;
        xv[e] = q < HW ? (xv[e] - mun[q]) * rsn[q] : 0.f;
      }
      float4* xr = reinterpret_cast<float4*>(x_s + c * P + j);
      xr[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
      xr[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
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
      tile_gemm_resident<P, true>(wts, ld, C, 2 * C, dt_s, epi);
    else
      tile_gemm<P, true>(a.W1, C, C, 2 * C, dt_s, wts, epi);

    // ---- LN1 backward: dx = LN1^T(dh) + dz. dz goes to the space of dt_s
    //      (free since the product's last barrier) as fp32 [C][P], its
    //      loads in flight while the per-pixel sums are taken
    float* dz_s = reinterpret_cast<float*>(dt_s);
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int c = idx / CH, j = (idx % CH) * 8;
      float dv[8];
      load8(dzn + (long long)c * HW, p0 + j, HW, vec, dv);
      float4* dr = reinterpret_cast<float4*>(dz_s + c * P + j);
      dr[0] = make_float4(dv[0], dv[1], dv[2], dv[3]);
      dr[1] = make_float4(dv[4], dv[5], dv[6], dv[7]);
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
        dxn[o] = __float2bfloat16_rn(
            (gxh - mean_g - x_s[c * P + px] * mean_gx) * r + dz_s[c * P + px]);
      }
    }
    __syncthreads();  // x_s, dh_s are read above and refilled next tile
  }
}

}  // namespace nafblk
