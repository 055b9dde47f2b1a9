// The 3xTF32 building blocks of the fp32 tensor-core kernels, included by
// nafblock_tf32.cuh (K3, K4) and nafblock_fwd_tf32.cuh (K1, K2): the split
// of an fp32 operand into two TF32 values, the m16n8k8 TF32 product, the
// product of a pixel tile by all 8 warps (tile_gemm_tf32) and the fp32 tile
// I/O. nafblock_tf32.cuh's header says why three TF32 products and how the
// fragments are laid out.

#pragma once

#include <cstdint>

#include "nafblock_p1_mma.cuh"

namespace nafblk {

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; x - hi is exact in fp32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment a0..a3 of one m16n8k8 step, split.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(const float (&v)[4]) {
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], f.hi[e], f.lo[e]);
  return f;
}

// c += A B for the fp32 values b0 (k t, col g) and b1 (k t + 4, col g)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, a.lo, h0, h1);
  mma_tf32(c, a.hi, l0, l1);
  mma_tf32(c, a.hi, h0, h1);
}

// ---------------------------------------------------------------------------
// One product out[M, P] = A[M, K] B[K, P] of a pixel tile, by all 8 warps.
//   TRANS = false: A = W [M, K] row-major (row stride ld);
//   TRANS = true:  A = W^T with W [K, M] row-major (row stride ld).
// GLOBAL: W lies in global memory (read-only path), else W is the resident
// copy in shared memory. B = Bs, fp32 [K][ldb_of(P)] in shared memory.
// Warp w owns rows [128 i + 16 w, + 16) of pass i and all P pixels.
// epi(row0, acc) as tile_gemm's; M a multiple of 16, K of 16. Ends with a
// block barrier, so what epi wrote is visible to every thread.
// ---------------------------------------------------------------------------

template <int P, bool TRANS, bool GLOBAL, typename Epi>
__device__ __forceinline__ void tile_gemm_tf32(const float* __restrict__ W,
                                               int ld, int M, int K,
                                               const float* __restrict__ Bs,
                                               Epi&& epi) {
  constexpr int NT = P / 8;
  constexpr int LDB = ldb_of(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // a1 is 8 rows of A past a0, a2 4 contraction indices; one step is 8
  const long long o_row = TRANS ? 8 : 8LL * ld;
  const long long o_k = TRANS ? 4LL * ld : 4;
  const long long k_step = TRANS ? 8LL * ld : 8;
  auto read = [&](const float* p) { return GLOBAL ? __ldg(p) : *p; };
  auto frag = [&](const float* p, float (&v)[4]) {
    v[0] = read(p);
    v[1] = read(p + o_row);
    v[2] = read(p + o_k);
    v[3] = read(p + o_row + o_k);
  };
  const float* b_lane = Bs + tq * LDB + gq;
  for (int m0 = 0; m0 < M; m0 += kMB) {
    const int row0 = m0 + warp * 16;
    if (row0 >= M) break;  // the same for every lane of the warp
    const float* a_lane = TRANS ? W + (long long)tq * ld + row0 + gq
                                : W + (long long)(row0 + gq) * ld + tq;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    // the A values of the next two steps, in flight while these compute
    float cur[2][4], nxt[2][4];
    frag(a_lane, cur[0]);
    frag(a_lane + k_step, cur[1]);
    for (int k0 = 0; k0 < K; k0 += 16) {
      if (k0 + 16 < K) {
        frag(a_lane + (k0 / 8 + 2) * k_step, nxt[0]);
        frag(a_lane + (k0 / 8 + 3) * k_step, nxt[1]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const FragA af = split_a(cur[s]);
        const float* brow = b_lane + (k0 + 8 * s) * LDB;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_3xtf32(acc[nt], af, brow[nt * 8], brow[4 * LDB + nt * 8]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[s][e] = nxt[s][e];
    }
    epi(row0, acc);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Tile I/O in chunks of 8 pixels
// ---------------------------------------------------------------------------

// 8 pixels [p, p + 8) of one channel row of an fp32 activation [.., HW];
// zeros beyond HW. Two 16-byte loads where the row allows them.
__device__ __forceinline__ void load8f(const float* __restrict__ row,
                                       long long p, long long HW, bool vec,
                                       float (&out)[8]) {
  if (vec && p + 8 <= HW) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(row + p));
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + p + 4));
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
    out[4] = v.x;
    out[5] = v.y;
    out[6] = v.z;
    out[7] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = p + e < HW ? __ldg(row + p + e) : 0.f;
  }
}

__device__ __forceinline__ void store8f(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Copies rows [0, rows) of an fp32 [rows][ldb_of(P)] shared array to the
// workspace stream dst [rows][HWp] at pixels [p0, p0 + P), 16 bytes a
// thread (HWp and p0 are multiples of 8).
template <int P>
__device__ __forceinline__ void store_stream_f(float* __restrict__ dst,
                                               const float* src, int rows,
                                               long long p0, long long HWp) {
  constexpr int CH = P / 4;
  constexpr int LDB = ldb_of(P);
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH, j = (idx % CH) * 4;
    if (p0 + j < HWp)
      *reinterpret_cast<float4*>(dst + (long long)r * HWp + p0 + j) =
          *reinterpret_cast<const float4*>(src + r * LDB + j);
  }
}

// rows x cols fp32 (cols a multiple of 4, rows contiguous) into shared
// memory with row stride ld, by cp.async; the caller commits and waits.
__device__ __forceinline__ void fill_rows_f(float* dst, const float* src,
                                            int rows, int cols, int ld) {
  const int ch = cols / 4;
  for (int i = threadIdx.x; i < rows * ch; i += kThreads)
    cp_async16(dst + (i / ch) * ld + (i % ch) * 4,
               src + (long long)(i / ch) * cols + (i % ch) * 4);
}

}  // namespace nafblk
