// K3 in bf16 on the tensor cores: k3_mma_kernel (recompute and input-side
// backward of the NAFBlock's second half) and wgrad_mma_kernel (its three
// weight gradients), included by nafblock_bwd.cu. See that file's header
// for what K3 computes, its bound and why the design is what it is.
//
// Every product is mma.sync.aligned.m16n8k16 (bf16 operands, fp32
// accumulators) fed by ldmatrix from shared memory:
//   - out[M, P] = W[M, K] act[K, P]: A = W, staged row-major; B = act,
//     kept channel-major [K][P] (pixels contiguous) and read with
//     ldmatrix.trans;
//   - out[M, P] = W^T act with W [K, M]: the same staged rows of W, read
//     with ldmatrix.trans, so no transposed copy of a weight exists;
//   - dW[M, Nc] = sum over pixels of a[M, p] b[Nc, p]: both operands have
//     the contraction index (the pixel) contiguous, the layout mma wants
//     for A (row) and for B (col); plain ldmatrix for both.
// Fragment layout (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   a0 (row g, k 2t..2t+1)  a1 (row g+8, same k)  a2, a3: k + 8
//   b0 (k 2t..2t+1, col g)  b1: k + 8
//   c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, same cols)

#pragma once

#include <cstdint>
#include <type_traits>

#include "nafblock_common.cuh"

namespace nafblk {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum over the four lanes that share a fragment row (t = 0..3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Geometry shared by host and device
// ---------------------------------------------------------------------------

constexpr int kMB = 128;  // output rows per pass: 8 warps x one 16-row tile
constexpr int kKS = 32;   // contraction slice per staged slab
constexpr int kSlab = kMB * kKS;  // elements of one staged slab of W
constexpr int kStages = 3;        // slabs in the ring: two loads in flight

// A slab holds 16-byte chunks (8 values) without padding; a chunk's place
// in its row is XORed with bits of the row so that the 8 rows of one
// ldmatrix phase fall into distinct banks.
//   W as it lies:   [128 rows][32 k], 4 chunks a row
//   W transposed:   [32 k][128 columns], 16 chunks a row
__device__ __forceinline__ int slab_n(int r, int chunk) {
  return r * kKS + ((chunk ^ ((r >> 1) & 3)) << 3);
}
__device__ __forceinline__ int slab_t(int r, int chunk) {
  return r * kMB + ((chunk ^ (r & 7)) << 3);
}

// Row stride (elements) of a bf16 [channels][P] operand array: 8 elements
// of padding keep the 8 rows of one ldmatrix phase in distinct banks.
__host__ __device__ constexpr int ldb_of(int P) { return P == 8 ? 8 : P + 8; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Up to this many channels (C and F) the three weight matrices stay in
// shared memory for the whole kernel ("resident": 4 C^2 bf16 values, 36 KB
// at 64), with the vectors and the block's vector partials beside them.
constexpr int kResidentMax = 64;
// Blocks of the resident kernel that share an SM: a tile there is a chain
// of short phases, which only more blocks in flight hide.
constexpr int kResidentBlocks = 3;

__host__ __device__ inline bool resident(int C, int F) {
  return C <= kResidentMax && F <= kResidentMax;
}

// Row stride (elements) of a resident [rows][cols] weight: padded like the
// operand arrays.
__host__ __device__ constexpr int ldr_of(int cols) { return cols + 8; }

// Resident weights W3 [C][C], W4 [2F][C], W5 [C][F] (elements), and the
// fp32 values beside them: b3, w2n, b2n, b5, beta, gamma (C each), b4
// (2F), the vector partials (6C + 2F) and the da partials (C).
__host__ __device__ inline size_t resident_elems(int C, int F) {
  return (size_t)(C + 2 * F) * ldr_of(C) + (size_t)C * ldr_of(F);
}
__host__ __device__ inline size_t resident_floats(int C, int F) {
  return (size_t)13 * C + 4 * F;
}

// Dynamic shared memory of k3_mma_kernel with P pixels per tile.
inline size_t k3_mma_smem(int C, int F, int P) {
  const size_t hq_rows = (size_t)imax(C + F, 2 * F);
  const size_t weights =
      resident(C, F) ? resident_elems(C, F) * sizeof(bf16) +
                           resident_floats(C, F) * sizeof(float)
                     : (size_t)kStages * kSlab * sizeof(bf16);
  return (hq_rows + C) * ldb_of(P) * sizeof(bf16)      // hq, d
         + (size_t)(2 * C + 2 * F) * P * sizeof(float)  // z, pth, q
         + weights;
}

// ---------------------------------------------------------------------------
// One product out[M, P] = A[M, K] B[K, P] of a pixel tile, by all 8 warps.
//   TRANS = false: A = Wg [M, K] row-major (row stride ldw).
//   TRANS = true:  A = Wg^T with Wg [K, M] row-major (row stride ldw).
// B = Bs, bf16 [K][ldb_of(P)] in shared memory. Warp w owns rows
// [128 i + 16 w, + 16) of pass i and all P pixels; W is staged in slabs of
// 128 output rows x 32 contraction indices by cp.async through a ring of
// kStages slabs (two loads in flight, one block barrier per slab).
// epi(row0, acc) gets the finished 16 x P tile of a warp: acc[nt][0..3] are
// c0..c3 of pixel columns 8 nt .. 8 nt + 7. M, K multiples of 16. Ends
// with a block barrier, so what epi wrote is visible to every thread.
// A slab is a few hundred tensor-core operations per warp, so the loop is
// bound by the instructions around them: every offset that does not
// change is computed once, and the slab counters advance by addition.
// ---------------------------------------------------------------------------

template <int P, bool TRANS, typename Epi>
__device__ __forceinline__ void tile_gemm(const bf16* __restrict__ Wg, int ldw,
                                          int M, int K,
                                          const bf16* __restrict__ Bs,
                                          bf16* slabs, Epi&& epi) {
  constexpr int NT = P / 8;
  constexpr int LDB = ldb_of(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this thread's two 16-byte chunks of a slab: where they lie in the slab,
  // where in W relative to the slab's corner, and their row / column there
  int s_off[2], r_in[2], c_in[2];
  long long g_off[2];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = TRANS ? idx >> 4 : idx >> 2;
    const int ch = TRANS ? idx & 15 : idx & 3;
    s_off[it] = TRANS ? slab_t(r, ch) : slab_n(r, ch);
    g_off[it] = (long long)r * ldw + ch * 8;
    r_in[it] = r;
    c_in[it] = ch * 8;
  }
  // the slab whose corner is output row m0, contraction index k0
  auto stage = [&](int m0, int k0, bf16* buf) {
    const bf16* src = TRANS ? Wg + (long long)k0 * ldw + m0
                            : Wg + (long long)m0 * ldw + k0;
    const int rows = TRANS ? K - k0 : M - m0;  // rows of W left
    const int cols = TRANS ? M - m0 : K - k0;  // columns of W left
#pragma unroll
    for (int it = 0; it < 2; ++it)
      if (r_in[it] < rows && c_in[it] < cols)
        cp_async16(buf + s_off[it], src + g_off[it]);
  };
  // A fragments of the warp's 16 rows for the two 16-deep steps of a slab,
  // B fragments of this lane
  int a_off[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    a_off[kk] = TRANS ? slab_t(kk * 16 + (lane & 7) + (lane >> 4) * 8,
                               warp * 2 + ((lane >> 3) & 1))
                      : slab_n(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               kk * 2 + (lane >> 4));
  const bf16* b_lane =
      Bs + (lane & 15) * LDB + (NT == 1 ? 0 : (lane >> 4) * 8);

  float acc[NT][4];
  // load side: the next slab to load and its place in the ring; always
  // one commit, so that "all but the newest group" is the slab computed on
  int im0 = 0, ik0 = 0, islot = 0;
  auto load_next = [&]() {
    if (im0 < M) {
      stage(im0, ik0, slabs + islot * kSlab);
      ik0 += kKS;
      if (ik0 >= K) {
        ik0 = 0;
        im0 += kMB;
      }
      islot = islot + 1 == kStages ? 0 : islot + 1;
    }
    cp_async_commit();
  };
  load_next();
  load_next();
  int slot = 0;
  for (int m0 = 0; m0 < M; m0 += kMB) {
    const int row0 = m0 + warp * 16;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKS) {
      cp_async_wait<1>();
      // this slab has landed for every thread, and every warp is done with
      // the one before it, whose place the next load takes
      __syncthreads();
      load_next();
      const bf16* buf = slabs + slot * kSlab;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      if (row0 < M) {  // the same for every lane of the warp
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (k0 + kk * 16 < K) {
            uint32_t a[4];
            if (TRANS)
              ldsm_x4_t(a, buf + a_off[kk]);
            else
              ldsm_x4(a, buf + a_off[kk]);
            const bf16* brow = b_lane + (k0 + kk * 16) * LDB;
            if (NT == 1) {
              uint32_t b[2];
              ldsm_x2_t(b, brow);
              mma_bf16(acc[0], a, b[0], b[1]);
            } else {
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                uint32_t b[4];
                ldsm_x4_t(b, brow + np * 16);
                mma_bf16(acc[2 * np], a, b[0], b[1]);
                mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
              }
            }
          }
        }
      }
    }
    if (row0 < M) epi(row0, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The same product with A resident in shared memory: Ws is W, row-major
// with row stride ld (padded), M <= 128. No staging and one barrier.
template <int P, bool TRANS, typename Epi>
__device__ __forceinline__ void tile_gemm_resident(const bf16* Ws, int ld,
                                                   int M, int K,
                                                   const bf16* Bs, Epi&& epi) {
  constexpr int NT = P / 8;
  constexpr int LDB = ldb_of(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  if (row0 < M) {  // the same for every lane of the warp
    const bf16* a_lane =
        TRANS ? Ws + ((lane & 7) + (lane >> 4) * 8) * ld + row0 +
                    ((lane >> 3) & 1) * 8
              : Ws + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                    (lane >> 4) * 8;
    const bf16* b_lane =
        Bs + (lane & 15) * LDB + (NT == 1 ? 0 : (lane >> 4) * 8);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      if (TRANS)
        ldsm_x4_t(a, a_lane + k0 * ld);
      else
        ldsm_x4(a, a_lane + k0);
      const bf16* brow = b_lane + k0 * LDB;
      if (NT == 1) {
        uint32_t b[2];
        ldsm_x2_t(b, brow);
        mma_bf16(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, brow + np * 16);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    epi(row0, acc);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Tile I/O in chunks of 8 pixels (16 bytes of bf16)
// ---------------------------------------------------------------------------

// 8 pixels [p, p + 8) of one channel row of an activation [.., HW]; zeros
// beyond HW. One 16-byte load where the row allows it.
__device__ __forceinline__ void load8(const bf16* __restrict__ row,
                                      long long p, long long HW, bool vec,
                                      float (&out)[8]) {
  if (vec && p + 8 <= HW) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = p + e < HW ? __bfloat162float(row[p + e]) : 0.f;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  return u;
}

// Copies rows [0, rows) of a bf16 [rows][ldb_of(P)] shared array to the
// workspace stream dst [rows][HWp] at pixels [p0, p0 + P), 16 bytes a
// thread (HWp and p0 are multiples of 8).
template <int P>
__device__ __forceinline__ void store_stream(bf16* __restrict__ dst,
                                             const bf16* src, int rows,
                                             long long p0, long long HWp) {
  constexpr int CH = P / 8;
  constexpr int LDB = ldb_of(P);
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH, j = (idx % CH) * 8;
    if (p0 + j < HWp)
      *reinterpret_cast<uint4*>(dst + (long long)r * HWp + p0 + j) =
          *reinterpret_cast<const uint4*>(src + r * LDB + j);
  }
}

// ---------------------------------------------------------------------------
// k3_mma_kernel: grid (BX, N), block kThreads. Block (bx, n) walks the
// pixel tiles bx, bx + BX, ... of image n, P pixels each.
// Per-block vector partials, V = 6C + 2F floats:
//   [dgamma C | db5 C | db4 2F | dw2n C | db2n C | dbeta C | db3 C]
// and the SCA grad partials da [N, BX, C]; a block adds its tiles in order.
// RES (C, F <= 64): the weights, the vectors and the block's partials stay
// in shared memory from the first tile to the last, so a tile costs no
// weight traffic and no round trip to global memory for a sum.
// The six operand streams go to the workspace as bf16 [N, rows, HWp] with
// HWp = HW rounded up to 8 (zeros, or finite values that meet zeros in
// their product, at pixels >= HW).
// ---------------------------------------------------------------------------

struct K3Mma {
  const bf16 *x, *g, *dout;
  const float* att;
  const bf16 *W3, *W4, *W5;
  const float *b3, *w2n, *b2n, *b4, *b5, *beta, *gamma;
  bf16 *dz, *v_o, *h2_o, *wv_o, *ds_o, *dq_o, *dp_o;
  float *vpart, *dapart;
  int C, F;
  long long HW, HWp;
  int tiles;
  int vec;  // x, g, dout rows allow 16-byte loads
  float eps;
};

template <int P, bool RES>
__global__ void __launch_bounds__(kThreads, RES ? kResidentBlocks : 1)
    k3_mma_kernel(const K3Mma a) {
  constexpr int NT = P / 8;
  constexpr int CH = P / 8;  // 16-byte chunks per channel row
  constexpr int LDB = ldb_of(P);
  constexpr int G = kThreads / P;
  const int C = a.C, F = a.F;
  const long long HW = a.HW, HWp = a.HWp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hq_s = reinterpret_cast<bf16*>(smem_raw);  // v | h2, wv, then dq
  bf16* d_s = hq_s + (size_t)imax(C + F, 2 * F) * LDB;  // ds, then dp
  // the weights: a ring of slabs, or W3, W4, W5 themselves (RES)
  bf16* slabs = d_s + (size_t)C * LDB;
  const int ld_c = ldr_of(C), ld_f = ldr_of(F);
  bf16* W3_s = slabs;
  bf16* W4_s = W3_s + (size_t)C * ld_c;
  bf16* W5_s = W4_s + (size_t)2 * F * ld_c;
  float* z_s = reinterpret_cast<float*>(
      slabs + (RES ? resident_elems(C, F) : (size_t)kStages * kSlab));
  float* p_s = z_s + (size_t)C * P;  // pth; z before it, then xhat2
  float* q_s = p_s + (size_t)C * P;  // q [2F], then dh2 [C]
  float* par_s = q_s + (size_t)2 * F * P;  // RES: vectors, then partials
  __shared__ float red_s[2 * kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int px = tid % P, grp = tid / P;    // pixel-per-lane mapping
  const int n = blockIdx.y;
  const float* attn = a.att + (long long)n * C;
  float* vp_g = a.vpart + ((long long)n * gridDim.x + blockIdx.x) *
                              (6 * C + 2 * F);
  float* dap_g = a.dapart + ((long long)n * gridDim.x + blockIdx.x) * C;
  const bf16* xn = a.x + (long long)n * C * HW;
  const bf16* gn = a.g + (long long)n * C * HW;
  const bf16* don = a.dout + (long long)n * C * HW;
  bf16* dzn = a.dz + (long long)n * C * HW;
  const bool vec = a.vec != 0;

  // the vectors and the block's partials: in global memory, or (RES) in
  // shared memory, filled here and written out after the last tile
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
  // the product W act (or W^T act) of this tile: from the resident copy
  // of W, or from W in global memory through the ring
  auto product = [&](auto trans, const bf16* Wg, const bf16* Ws, int cols,
                     int M, int K, const bf16* Bs, auto&& epi) {
    constexpr bool T = decltype(trans)::value;
    if constexpr (RES)
      tile_gemm_resident<P, T>(Ws, ldr_of(cols), M, K, Bs, epi);
    else
      tile_gemm<P, T>(Wg, cols, M, K, Bs, slabs, epi);
  };
  constexpr std::false_type as_is{};
  constexpr std::true_type transposed{};

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const bool first = !RES && tile == (int)blockIdx.x;
    const long long p0 = (long long)tile * P;
    // adds a tile's row sum to the block's partial
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
      load8(xn + (long long)c * HW, p0 + j, ok ? HW : 0, vec, xv);
      load8(gn + (long long)c * HW, p0 + j, ok ? HW : 0, vec, gv);
      load8(don + (long long)c * HW, p0 + j, ok ? HW : 0, vec, dv);
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
        *reinterpret_cast<uint4*>(hq_s + c * LDB + j) = pack8(gv);
        *reinterpret_cast<uint4*>(d_s + c * LDB + j) = pack8(dv);
        float4* zr = reinterpret_cast<float4*>(z_s + c * P + j);
        zr[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
        zr[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
        if (j == 0) put(vp + C + c, sum);
      }
    }
    __syncthreads();
    store_stream<P>(a.v_o + (long long)n * C * HWp, hq_s, C, p0, HWp);
    store_stream<P>(a.ds_o + (long long)n * C * HWp, d_s, C, p0, HWp);

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
      hq_s[c * LDB + px] = __float2bfloat16_rn(fmaf(xh, w2n[c], b2n[c]));
    }
    __syncthreads();
    store_stream<P>(a.h2_o + (long long)n * C * HWp, hq_s, C, p0, HWp);

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
    bf16* wv_s = hq_s + (size_t)C * LDB;
    for (int f = grp; f < F; f += G)
      wv_s[f * LDB + px] =
          __float2bfloat16_rn(q_s[f * P + px] * q_s[(F + f) * P + px]);
    __syncthreads();
    store_stream<P>(a.wv_o + (long long)n * F * HWp, wv_s, F, p0, HWp);

    // ---- conv5: s = W5 wv + b5; dgamma = sum dout * s
    product(
        as_is, a.W5, W5_s, F, C, F, wv_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = row0 + gq + 8 * h;
            const float bb = b5[o];
            const bf16* drow = don + (long long)o * HW;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const long long p = p0 + 8 * nt + 2 * tq;
              const float d0 = p < HW ? __bfloat162float(drow[p]) : 0.f;
              const float d1 =
                  p + 1 < HW ? __bfloat162float(drow[p + 1]) : 0.f;
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
              *reinterpret_cast<uint32_t*>(hq_s + f * LDB + col) =
                  pack_bf16(a0, a1);
              *reinterpret_cast<uint32_t*>(hq_s + (F + f) * LDB + col) =
                  pack_bf16(c0, c1);
            }
            s1 = quad_sum(s1);
            s2 = quad_sum(s2);
            if (tq == 0) {
              put(vp + 2 * C + f, s1);
              put(vp + 2 * C + F + f, s2);
            }
          }
        });
    store_stream<P>(a.dq_o + (long long)n * 2 * F * HWp, hq_s, 2 * F, p0,
                    HWp);

    // ---- dh2 = W4^T dq -> q[0, C) (q is dead); dw2n, db2n
    product(
        transposed, a.W4, W4_s, C, C, 2 * F, hq_s, [&](int row0, float(&acc)[NT][4]) {
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
        dzv = __bfloat162float(don[o]) +
              (gxh - mean_g - z_s[c * P + px] * mean_gx) * rstd;
        pth = p_s[c * P + px];
        dp = beta[c] * dzv;
        dzn[o] = __float2bfloat16_rn(dzv);
      }
      const float s_beta = group_sum<P>(dzv * pth);
      const float s_b3 = group_sum<P>(dp);
      if (ok) {
        d_s[c * LDB + px] = __float2bfloat16_rn(dp);
        if (px == 0) {
          put(vp + 4 * C + 2 * F + c, s_beta);
          put(vp + 5 * C + 2 * F + c, s_b3);
        }
      }
    }
    __syncthreads();
    store_stream<P>(a.dp_o + (long long)n * C * HWp, d_s, C, p0, HWp);

    // ---- dv = W3^T dp; da[n, c] = sum_p dv * g
    product(
        transposed, a.W3, W3_s, C, C, C, d_s, [&](int row0, float(&acc)[NT][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = row0 + gq + 8 * h;
            const bf16* grow = gn + (long long)c * HW;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const long long p = p0 + 8 * nt + 2 * tq;
              const float g0 = p < HW ? __bfloat162float(grow[p]) : 0.f;
              const float g1 =
                  p + 1 < HW ? __bfloat162float(grow[p + 1]) : 0.f;
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
// wgrad_mma_kernel: the three weight gradients of K3 in one launch.
// Product q: out_q[i, j] = sum over n, p of A_q[n, i, p] B_q[n, j, p] with
// the streams bf16 [N, rows, HWp]. grid (tiles of all three products, S, N),
// block kThreads: a 64 x 64 output tile (warp w: rows 16 (w % 4), columns
// 32 (w / 4)) over the pixels [s L, min((s + 1) L, HWp)) of image n, staged
// 32 pixels at a time by cp.async, double-buffered. Writes the fp32 partial
// part[n * S + s][off_q + i * Nc_q + j]; sum_rows adds the N * S rows in a
// fixed order (no float atomics: the same inputs give the same bits).
// ---------------------------------------------------------------------------

constexpr int kGT = 64;            // output tile side
constexpr int kGK = 32;            // pixels per stage
constexpr int kGLd = kGK + 8;      // stage row stride (elements)
constexpr int kGBlocks = 264;      // blocks to aim for (2 per SM)

struct WgradProduct {
  const bf16 *A, *B;
  int M, Nc;
  long long off;  // offset of out_q in a partial row
  int tile0;      // first block index of this product
};

struct WgradMma {
  WgradProduct prod[3];
  float* part;
  long long V;  // floats in a partial row
  long long HWp, L;
};

inline int wgrad_tiles(int M, int Nc) {
  return ((M + kGT - 1) / kGT) * ((Nc + kGT - 1) / kGT);
}

__global__ void __launch_bounds__(kThreads) wgrad_mma_kernel(
    const WgradMma a) {
  __shared__ __align__(16) bf16 As[2][kGT * kGLd];
  __shared__ __align__(16) bf16 Bs[2][kGT * kGLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = (int)blockIdx.x >= a.prod[2].tile0
                    ? 2 : ((int)blockIdx.x >= a.prod[1].tile0 ? 1 : 0);
  const WgradProduct pr = a.prod[q];
  const int tile = blockIdx.x - pr.tile0;
  const int tiles_c = (pr.Nc + kGT - 1) / kGT;
  const int i0 = (tile / tiles_c) * kGT, j0 = (tile % tiles_c) * kGT;
  const int s = blockIdx.y, n = blockIdx.z;
  const long long pa = (long long)s * a.L;
  const long long pb = pa + a.L < a.HWp ? pa + a.L : a.HWp;
  const bf16* An = pr.A + (long long)n * pr.M * a.HWp;
  const bf16* Bn = pr.B + (long long)n * pr.Nc * a.HWp;

  // one 16-byte chunk of A and of B per thread and stage
  const int lr = tid >> 2, lc = (tid & 3) * 8;
  auto stage = [&](long long k0, int b) {
    const bool okp = k0 + lc < pb;
    bf16* da = &As[b][lr * kGLd + lc];
    bf16* db = &Bs[b][lr * kGLd + lc];
    if (okp && i0 + lr < pr.M)
      cp_async16(da, An + (long long)(i0 + lr) * a.HWp + k0 + lc);
    else
      *reinterpret_cast<uint4*>(da) = make_uint4(0u, 0u, 0u, 0u);
    if (okp && j0 + lr < pr.Nc)
      cp_async16(db, Bn + (long long)(j0 + lr) * a.HWp + k0 + lc);
    else
      *reinterpret_cast<uint4*>(db) = make_uint4(0u, 0u, 0u, 0u);
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
    const bf16* Ab = As[st & 1];
    const bf16* Bb = Bs[st & 1];
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Ab + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * kGLd +
                      kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Bb + (wn + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                              kGLd +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();
  }

  float* out = a.part + ((long long)n * gridDim.y + s) * a.V + pr.off;
  const int gq = lane >> 2, tq = lane & 3;
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

}  // namespace nafblk
