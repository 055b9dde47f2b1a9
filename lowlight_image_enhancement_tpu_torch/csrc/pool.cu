// Fused ReLU + 2x2 / stride-2 max pool for Hopper (sm_90a): kernels K7
// (relu_pool_fwd) and K8 (pool_bwd), bound to Python through a plain C
// interface (ctypes).
//
// Layout: contiguous NCHW. x and dx are [N*C, H, W]; y and dy are
// [N*C, H/2, W/2] (integer division: an odd trailing row or column of x
// belongs to no window, is never read, and gets a zero gradient).
//
// K7 -- replaces lowlight_image_enhancement_tpu/ops/pallas/pool.py:
//       _fwd_kernel (pallas_call in _pool_fwd_impl).
//   y = maxpool2x2(relu(x)). A NaN in a window gives a NaN output, as
//   jnp.maximum does.
//   Bound: bytes. It reads x once and writes y: 1.25 s N C H W bytes for s
//   bytes per element, one compare per element.
//   Design: a thread makes Q = 16 / s consecutive outputs of one output row
//   (16 bytes of y) from 2Q elements of each of the window's two input
//   rows, which it reads in vectors of LV elements (16 bytes where the
//   rows allow it), issuing every load before the first compare; it writes
//   in vectors of SV elements. LV and SV follow the row pitch and x's
//   alignment (ops/pool.py:pool_fwd_geometry chooses them, with the block
//   and the grid): 16-byte loads and stores at the VGG19 shapes, 8-byte
//   stores where W % 16 == 8 in bf16, 2-element loads where W is even and
//   no multiple of 16 bytes, scalar ones where W is odd. The last group of
//   a row takes the vectors that lie inside it. A block is (groups of a
//   row) x (rows); it takes its rows once and walks them by addition, at
//   most two rounds of blocks over the card. Output row r = plane * Ho +
//   oh starts in x at input row 2 r + plane * (H % 2): no division where
//   H is even.
//
// K8 -- replaces lowlight_image_enhancement_tpu/ops/pallas/pool.py:
//       _bwd_kernel (pallas_call in _pool_bwd_impl).
//   Routes dy to the first window position, in the order (0,0), (0,1),
//   (1,0), (1,1), whose value equals the window max; the compares run in
//   fp32 (exact for bf16 values), and IEEE == makes -0.0 and +0.0 tie.
//   Position (1,1) takes the remainder (not "r11 == m"), so a window whose
//   max is NaN, where every == is false, still routes its gradient. With
//   relu != 0 the window is taken of relu(x) and the result is masked by
//   x > 0 (K7's backward); with relu == 0 it is the backward of a plain
//   max pool.
//   Bound: bytes. It reads x and dy and writes dx: 2.25 s N C H W bytes.
//
// K8's design: one thread per window. The two loads a thread makes from
// each input row are neighbours, and the 32 lanes of a warp cover 64
// consecutive elements of the row, so every 32-byte sector that is fetched
// is used; single-element loads keep bf16 rows of odd pitch legal (no
// 4-byte alignment is assumed). K8's grid covers ceil(H/2) x ceil(W/2)
// windows so that the dropped odd row and column are written (with zeros)
// by the same launch. Nothing is kept between blocks.
//
// Kernels run on the caller's stream and allocate nothing. Every entry
// point returns cudaGetLastError() of its launch (0 = success).

#include "nafblock_common.cuh"

namespace {

using namespace nafblk;

// max that hands a NaN on, whichever side it is on
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ---------------------------------------------------------------------------
// K7: blocks of (bx, by) threads, grid (gx, gy). Thread (tx, ty) of block
// (i, j) takes group j bx + tx (outputs Q (j bx + tx) ...) of the output
// rows i by + ty + k gx by, k = 0, 1, ...
// ---------------------------------------------------------------------------

struct PoolFwd {
  const void* x;
  void* y;
  long long rows;  // output rows: N C Ho
  int H, W, Ho, Wo;
  int groups;      // groups of Q outputs in an output row
};

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// T's bits as a plain integer, and the conversions to and from fp32
template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = unsigned int;
  static __device__ __forceinline__ float get(type b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ type put(float v) {
    return __float_as_uint(v);
  }
};
template <> struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float get(type b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ type put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// LV elements of T as one load or store
template <typename T, int LV> union Pack {
  typename Raw<LV * sizeof(T)>::type raw;
  typename Bits<T>::type e[LV];
};

// The (LV, SV) pairs the wrapper may choose (ops/pool.py:
// pool_fwd_geometry), with Q = 16 / sizeof(T): (Q, Q) and (Q, Q / 2) where
// W % Q == 0, (2, 2) and (2, 1) where W is even, (1, 1) else.
template <typename T> bool pool_fwd_pair(int lv, int sv) {
  constexpr int Q = 16 / sizeof(T);
  return (lv == Q && (sv == Q || sv == Q / 2)) ||
         (lv == 2 && (sv == 2 || sv == 1)) || (lv == 1 && sv == 1);
}

template <typename T, int LV, int SV>
__global__ void __launch_bounds__(kThreads) relu_pool_fwd_kernel(
    const PoolFwd a) {
  constexpr int Q = 16 / sizeof(T);  // outputs a thread
  constexpr int NL = 2 * Q / LV;     // loads an input row
  constexpr int NS = Q / SV;         // stores
  using In = Pack<T, LV>;
  using Out = Pack<T, SV>;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= a.groups) return;
  const int ow0 = g * Q;
  // 2 x the outputs of this group: a multiple of LV and of 2 SV
  const int in_n = 2 * min(Q, a.Wo - ow0);
  const bool odd_h = a.H & 1;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ y = static_cast<T*>(a.y);
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < a.rows; r += step) {
    const long long row0 = 2 * r + (odd_h ? r / a.Ho : 0);
    const T* x0 = x + row0 * a.W + 2 * ow0;
    const T* x1 = x0 + a.W;
    In v0[NL], v1[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (k * LV < in_n) {
        using R = typename Raw<LV * sizeof(T)>::type;
        v0[k].raw = __ldg(reinterpret_cast<const R*>(x0 + k * LV));
        v1[k].raw = __ldg(reinterpret_cast<const R*>(x1 + k * LV));
      } else {
        v0[k].raw = v1[k].raw = {};
      }
    }
    Out o[NS];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int e0 = 2 * i, e1 = 2 * i + 1;
      using B = Bits<T>;
      const float m =
          nan_max(nan_max(B::get(v0[e0 / LV].e[e0 % LV]),
                          B::get(v0[e1 / LV].e[e1 % LV])),
                  nan_max(B::get(v1[e0 / LV].e[e0 % LV]),
                          B::get(v1[e1 / LV].e[e1 % LV])));
      o[i / SV].e[i % SV] = B::put(nan_max(m, 0.f));
    }
    T* yr = y + r * a.Wo + ow0;
#pragma unroll
    for (int k = 0; k < NS; ++k)
      if (2 * k * SV < in_n)
        *reinterpret_cast<typename Raw<SV * sizeof(T)>::type*>(yr + k * SV) =
            o[k].raw;
  }
}

// The instance of relu_pool_fwd_kernel for (is_bf16, lv, sv), one of the
// pairs of pool_fwd_pair.
const void* pool_fwd_kernel(int is_bf16, int lv, int sv) {
  using B = __nv_bfloat16;
  if (is_bf16)
    return lv == 8   ? (sv == 8 ? (const void*)relu_pool_fwd_kernel<B, 8, 8>
                                : (const void*)relu_pool_fwd_kernel<B, 8, 4>)
           : lv == 2 ? (sv == 2 ? (const void*)relu_pool_fwd_kernel<B, 2, 2>
                                : (const void*)relu_pool_fwd_kernel<B, 2, 1>)
                     : (const void*)relu_pool_fwd_kernel<B, 1, 1>;
  return lv == 4   ? (sv == 4 ? (const void*)relu_pool_fwd_kernel<float, 4, 4>
                              : (const void*)relu_pool_fwd_kernel<float, 4, 2>)
         : lv == 2 ? (sv == 2 ? (const void*)relu_pool_fwd_kernel<float, 2, 2>
                              : (const void*)relu_pool_fwd_kernel<float, 2, 1>)
                   : (const void*)relu_pool_fwd_kernel<float, 1, 1>;
}

// ---------------------------------------------------------------------------
// K8: one thread per window of the ceil(H/2) x ceil(W/2) cover
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    long long NC, int H, int W, int relu) {
  const int Ho = H / 2, Wo = W / 2;
  const int Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const long long total = NC * Hc * Wc;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int ow = (int)(i % Wc);
  const int oh = (int)((i / Wc) % Hc);
  const long long p = i / ((long long)Wc * Hc);
  const long long o00 = (p * H + 2 * oh) * W + 2 * ow;
  const T zero = from_f<T>(0.f);

  if (oh >= Ho || ow >= Wo) {
    // the odd trailing row / column: in no window, zero gradient
    dx[o00] = zero;
    if (2 * ow + 1 < W) dx[o00 + 1] = zero;
    if (2 * oh + 1 < H) {
      dx[o00 + W] = zero;
      if (2 * ow + 1 < W) dx[o00 + W + 1] = zero;
    }
    return;
  }

  const float v00 = to_f<T>(x[o00]), v01 = to_f<T>(x[o00 + 1]);
  const float v10 = to_f<T>(x[o00 + W]), v11 = to_f<T>(x[o00 + W + 1]);
  const float r00 = relu ? nan_max(v00, 0.f) : v00;
  const float r01 = relu ? nan_max(v01, 0.f) : v01;
  const float r10 = relu ? nan_max(v10, 0.f) : v10;
  const float r11 = relu ? nan_max(v11, 0.f) : v11;
  const float m = nan_max(nan_max(r00, r01), nan_max(r10, r11));
  const bool p00 = r00 == m;
  const bool p01 = (r01 == m) && !p00;
  const bool p10 = (r10 == m) && !p00 && !p01;
  const bool p11 = !p00 && !p01 && !p10;
  const T d = dy[(p * Ho + oh) * Wo + ow];
  dx[o00] = (p00 && (!relu || v00 > 0.f)) ? d : zero;
  dx[o00 + 1] = (p01 && (!relu || v01 > 0.f)) ? d : zero;
  dx[o00 + W] = (p10 && (!relu || v10 > 0.f)) ? d : zero;
  dx[o00 + W + 1] = (p11 && (!relu || v11 > 0.f)) ? d : zero;
}

}  // namespace

extern "C" {

// K7. x: [NC, H, W], y: [NC, H/2, W/2] (fp32, or bf16 when is_bf16; x
// aligned to lv elements, y to 16 bytes). lv, sv: elements a load and a
// store move; (bx, by) threads a block, (gx, gy) blocks: the geometry of
// ops/pool.py:pool_fwd_geometry, only checked here.
int relu_pool_fwd(const void* x, void* y, long long NC, int H, int W,
                  int is_bf16, int lv, int sv, int bx, int by, int gx, int gy,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int esize = is_bf16 ? 2 : 4, q = 16 / esize;
  PoolFwd a{x, y, NC * (H / 2), H, W, H / 2, W / 2, (W / 2 + q - 1) / q};
  if (a.rows == 0 || a.groups == 0) return 0;
  const bool ok = (is_bf16 ? pool_fwd_pair<__nv_bfloat16>(lv, sv)
                           : pool_fwd_pair<float>(lv, sv)) &&
                  W % lv == 0 && a.Wo % sv == 0 &&
                  reinterpret_cast<uintptr_t>(x) % (lv * esize) == 0 &&
                  aligned16(y) && bx >= 1 && by >= 1 &&
                  bx * by <= kThreads && gx >= 1 && gy >= 1 &&
                  (long long)gy * bx >= a.groups;
  if (!ok) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(
      pool_fwd_kernel(is_bf16, lv, sv), dim3((unsigned)gx, (unsigned)gy),
      dim3((unsigned)bx, (unsigned)by), args, 0, st);
}

// Blocks of K7 with (lv, sv) and `threads` threads a block that the CUDA
// runtime places on one SM of the current device (-1: not an (lv, sv) of
// K7, or a call failed).
int relu_pool_fwd_blocks_per_sm(int is_bf16, int lv, int sv, int threads) {
  if (!(is_bf16 ? pool_fwd_pair<__nv_bfloat16>(lv, sv)
                : pool_fwd_pair<float>(lv, sv)))
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, pool_fwd_kernel(is_bf16, lv, sv), threads, 0) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// K8. x, dx: [NC, H, W]; dy: [NC, H/2, W/2] (fp32, or bf16 when is_bf16).
int pool_bwd(const void* x, const void* dy, void* dx, long long NC, int H,
             int W, int relu, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = NC * ((H + 1) / 2) * ((W + 1) / 2);
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  if (is_bf16) {
    pool_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx,
        NC, H, W, relu);
  } else {
    pool_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)dy, (float*)dx, NC, H, W, relu);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
