// Per-pixel channel LayerNorm for Hopper (sm_90a): kernels K5 (ln_fwd) and
// K6 (ln_bwd), bound to Python through a plain C interface (ctypes).
//
// Layout: activations are contiguous NCHW viewed as [N, C, S] (S = H*W);
// the affine weight and bias are fp32 [C]; xhat is fp32 [N, C, S] and rstd
// fp32 [N, S].
//
// K5 -- replaces lowlight_image_enhancement_tpu/ops/pallas/layernorm.py:
//       _ln_fwd_kernel (pallas_call in _fwd_call).
//   y = xhat * w + b with xhat = (x - mean_c) * rstd, rstd = rsqrt(var_c +
//   eps); fp32 statistics, the mean first and then the centred variance, as
//   the TPU kernel takes them. Writes y in x's type and the residuals xhat
//   (fp32) and rstd (fp32) that K6 reads.
//   Bound: bytes. It reads x once and writes y, xhat and rstd:
//   (2 s + 4) N C S + 4 N S bytes for s bytes per activation element, and a
//   handful of FLOPs per element. At the wide stages of a U-net (C = 512
//   on 24 x 24 pixels) that is a few microseconds, so what limits the kernel
//   there is how many SMs take part and how long one thread's chain of
//   dependent strided loads is, not the memory rate.
//   Design: a block owns PX neighbouring pixels of one image (PX = 32, 16
//   or 8, chosen by the wrapper so that N * ceil(S / PX) blocks give each
//   of the 132 SMs two) and its 256 threads form 256 / PX groups that share the C
//   channels: lane = pixel, group g takes channels g, g + 256 / PX, ...
//   A group reads PX neighbouring pixels of one channel, one contiguous
//   segment (PX * s bytes: a 32-byte sector is half used only for bf16 at
//   PX = 8), so no transpose to rows of C is needed. x is read from HBM
//   once into shared memory as fp32 [C][PX] (128 KB at C = 1024, PX = 32);
//   the mean and then the centred variance are reduced across the groups
//   through shared memory (ln_stats, the order of the TPU kernel), and y,
//   xhat and rstd are written once. Any S (the tail is masked) and any C
//   up to 1024.
//
// K6 -- replaces lowlight_image_enhancement_tpu/ops/pallas/layernorm.py:
//       _ln_bwd_kernel (pallas_call in _bwd_call).
//   gx = (g w - mean_c(g w) - xhat mean_c(g w xhat)) rstd, and the affine
//   grads gw = sum over pixels of g xhat, gb = sum over pixels of g.
//   Bound: bytes. It reads g, xhat and rstd and writes gx:
//   (2 s + 4) N C S + 4 N S bytes, plus the partials.
//   Design: K5's mapping. A block owns tiles of PX neighbouring pixels of
//   one image (PX = 32, 16 or 8) and its 256 threads form 256 / PX groups
//   that share the C channels: lane = pixel, group q takes channels
//   q, q + 256 / PX, ... (at most CPT of them). A group reads one
//   contiguous PX-pixel segment of a channel. A thread keeps its CPT
//   values of g w and xhat in registers (all its loads in flight at once),
//   the two per-pixel means are reduced across the groups by shuffles
//   inside a warp and then across the 8 warps through shared memory, and
//   gx is written once. The wrapper picks PX so that CPT <= 16 up to
//   C = 512 (ops/layernorm.py:ln_bwd_tile).
//   gw and gb: a thread adds g xhat and g of its channels and pixel into
//   registers over every tile its block walks; the grid is one round of
//   blocks over the card (ops/layernorm.py:ln_bwd_grid), each walking its
//   image's tiles in a fixed stride order. At the end a group sums its PX
//   lanes (shuffles) and the block writes its one row of partials
//   [2, rows, C]; sum_rows_split adds the at most a few hundred rows in a
//   fixed order. No float atomics: the same inputs give the same bits.
//   Up to 8 channels a thread (C <= 64 at 32 pixels, where a block walks
//   many tiles) the next tile's loads are issued before this tile's
//   reduction; __launch_bounds__ holds the registers to what
//   ops/layernorm.py:LN_BWD_BLOCKS_BY_CHANNELS counts on an SM.

// Kernels run on the caller's stream and allocate nothing. Every entry
// point returns cudaGetLastError() of its launches (0 = success).

#include "nafblock_common.cuh"

namespace {

using namespace nafblk;

// ---------------------------------------------------------------------------
// K5: grid (ceil(S / PX), N), block kThreads, C * PX floats of dynamic
// shared memory
// ---------------------------------------------------------------------------

template <typename T, int PX>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, float* __restrict__ xhat,
    float* __restrict__ rstd, int C, long long S, float eps) {
  constexpr int G = kThreads / PX;
  extern __shared__ float x_s[];  // [C][PX]
  __shared__ float red_s[G * PX];

  const int lane = threadIdx.x % PX;
  const int grp = threadIdx.x / PX;
  const long long s = (long long)blockIdx.x * PX + lane;
  const bool live = s < S;
  const int n = blockIdx.y;
  const long long base = (long long)n * C * S + (live ? s : 0);

  // unrolled so that a thread's loads are all in flight at once
#pragma unroll 8
  for (int c = grp; c < C; c += G)
    x_s[c * PX + lane] = live ? to_f<T>(x[base + (long long)c * S]) : 0.f;
  // each thread reads back only what it wrote: no barrier needed before
  float mu, r;
  ln_stats<PX>(x_s, C, red_s, grp, lane, eps, mu, r);
  if (!live) return;
  if (grp == 0) rstd[(long long)n * S + s] = r;
#pragma unroll 4
  for (int c = grp; c < C; c += G) {
    const long long o = base + (long long)c * S;
    const float xh = (x_s[c * PX + lane] - mu) * r;
    xhat[o] = xh;
    y[o] = from_f<T>(fmaf(xh, w[c], b[c]));
  }
}

template <typename T, int PX>
cudaError_t launch_ln_fwd(const void* x, const float* w, const float* b,
                          void* y, float* xhat, float* rstd, int N, int C,
                          long long S, float eps, cudaStream_t st) {
  const size_t smem = (size_t)C * PX * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ln_fwd_kernel<T, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((S + PX - 1) / PX), (unsigned)N);
  ln_fwd_kernel<T, PX><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), xhat, rstd, C, S,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_ln_fwd(const void* x, const float* w, const float* b, void* y,
                       float* xhat, float* rstd, int N, int C, long long S,
                       float eps, int px, cudaStream_t st) {
  switch (px) {
    case 32:
      return launch_ln_fwd<T, 32>(x, w, b, y, xhat, rstd, N, C, S, eps, st);
    case 16:
      return launch_ln_fwd<T, 16>(x, w, b, y, xhat, rstd, N, C, S, eps, st);
    case 8:
      return launch_ln_fwd<T, 8>(x, w, b, y, xhat, rstd, N, C, S, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K6: grid (BX, N), block kThreads. Block (bx, n) walks the pixel tiles bx,
// bx + BX, ... of image n, PX pixels each; each thread takes at most CPT
// channels. part is [2, N * BX, C] (gw partials, then gb partials).
// ---------------------------------------------------------------------------

// Blocks of K6 that share an SM, by channels a thread: the register
// budget the compiler gets (ops/layernorm.py:LN_BWD_BLOCKS_BY_CHANNELS).
__host__ __device__ constexpr int ln_bwd_min_blocks(int cpt) {
  return cpt <= 4 ? 4 : cpt <= 8 ? 3 : cpt <= 16 ? 2 : 1;
}

template <typename T, int PX, int CPT>
__global__ void __launch_bounds__(kThreads, ln_bwd_min_blocks(CPT))
    ln_bwd_kernel(const T* __restrict__ g, const float* __restrict__ xhat,
                  const float* __restrict__ rstd, const float* __restrict__ w,
                  T* __restrict__ gx, float* __restrict__ part, int C,
                  long long S) {
  constexpr int G = kThreads / PX;
  constexpr int kWarps = kThreads / 32;
  // up to 8 channels a thread the next tile's loads are issued before this
  // tile's reduction (a block walks many tiles there: C <= 64)
  constexpr bool kPrefetch = CPT <= 8;
  // the per-pixel sums of each warp, twice: a tile writes one buffer while
  // a slow thread may still read the other tile's (one barrier a tile)
  __shared__ float red_s[2][2][kWarps][PX];

  const int lane = threadIdx.x % PX;
  const int grp = threadIdx.x / PX;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.y;
  const long long tiles = (S + PX - 1) / PX;
  const T* gn = g + (long long)n * C * S;
  const float* xn = xhat + (long long)n * C * S;
  const float* rn = rstd + (long long)n * S;
  T* gxn = gx + (long long)n * C * S;

  float wv[CPT], aw[CPT], ab[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = k * G + grp;
    wv[k] = c < C ? w[c] : 0.f;
    aw[k] = 0.f;
    ab[k] = 0.f;
  }
  // g, xhat and rstd of the thread's channels and pixel in tile t (0
  // beyond the image)
  auto load = [&](long long t, float (&gv)[CPT], float (&xh)[CPT], float& r) {
    const long long s = t * PX + lane;
    const bool live = s < S;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = k * G + grp;
      const bool ok = live && c < C;
      const long long o = (long long)c * S + s;
      gv[k] = ok ? to_f<T>(gn[o]) : 0.f;
      xh[k] = ok ? xn[o] : 0.f;
    }
    r = live ? rn[s] : 0.f;
  };

  float gv[CPT], xh[CPT], r = 0.f;
  if (kPrefetch && (long long)blockIdx.x < tiles) load(blockIdx.x, gv, xh, r);
  int buf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (!kPrefetch) load(tile, gv, xh, r);
    float gnx[kPrefetch ? CPT : 1], xnx[kPrefetch ? CPT : 1], rnx = 0.f;
    if constexpr (kPrefetch) {
      if (tile + gridDim.x < tiles) load(tile + gridDim.x, gnx, xnx, rnx);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      aw[k] = fmaf(gv[k], xh[k], aw[k]);
      ab[k] += gv[k];
      gv[k] *= wv[k];  // g w from here on
      s1 += gv[k];
      s2 = fmaf(gv[k], xh[k], s2);
    }
    // the groups of one warp, then the warps in order
#pragma unroll
    for (int o = PX; o < 32; o <<= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if ((threadIdx.x & 31) < PX) {
      red_s[buf][0][warp][lane] = s1;
      red_s[buf][1][warp][lane] = s2;
    }
    __syncthreads();
    s1 = 0.f;
    s2 = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      s1 += red_s[buf][0][q][lane];
      s2 += red_s[buf][1][q][lane];
    }
    buf ^= 1;
    const long long s = tile * PX + lane;
    if (s < S) {
      const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = k * G + grp;
        if (c < C)
          gxn[(long long)c * S + s] =
              from_f<T>((gv[k] - m1 - xh[k] * m2) * r);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        gv[k] = gnx[k];
        xh[k] = xnx[k];
      }
      r = rnx;
    }
  }

  // the block's row of partials: each group sums its PX lanes
  const long long row = (long long)n * gridDim.x + blockIdx.x;
  const long long rows = (long long)gridDim.x * gridDim.y;
  float* pw = part + row * C;
  float* pb = part + (rows + row) * C;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = k * G + grp;
    const float sw = group_sum<PX>(aw[k]);
    const float sb = group_sum<PX>(ab[k]);
    if (lane == 0 && c < C) {
      pw[c] = sw;
      pb[c] = sb;
    }
  }
}

// Channels per thread of K6: C spread over 256 / PX groups, rounded up to
// a power of two of at least 4 (0: more than 32).
int ln_bwd_cpt(int C, int px) {
  const int per = (C + kThreads / px - 1) / (kThreads / px);
  for (int cpt = 4; cpt <= 32; cpt *= 2)
    if (per <= cpt) return cpt;
  return 0;
}

template <typename T, int PX, int CPT>
cudaError_t launch_ln_bwd_as(const void* g, const float* xhat,
                             const float* rstd, const float* w, void* gx,
                             float* part, int N, int C, long long S, int bx,
                             cudaStream_t st) {
  ln_bwd_kernel<T, PX, CPT><<<dim3((unsigned)bx, (unsigned)N), kThreads, 0,
                              st>>>(static_cast<const T*>(g), xhat, rstd, w,
                                    static_cast<T*>(gx), part, C, S);
  return cudaGetLastError();
}

// The instance of K6 for (PX, CPT) and what it gives: the launch, or the
// blocks the CUDA runtime places on one SM (occ != nullptr).
template <typename T, int PX>
cudaError_t ln_bwd_px(const void* g, const float* xhat, const float* rstd,
                      const float* w, void* gx, float* part, int N, int C,
                      long long S, int bx, cudaStream_t st, int* occ) {
  auto run = [&](auto kernel, auto launch) -> cudaError_t {
    if (occ)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel,
                                                           kThreads, 0);
    return launch(g, xhat, rstd, w, gx, part, N, C, S, bx, st);
  };
  switch (ln_bwd_cpt(C, PX)) {
    case 4:
      return run(ln_bwd_kernel<T, PX, 4>, launch_ln_bwd_as<T, PX, 4>);
    case 8:
      return run(ln_bwd_kernel<T, PX, 8>, launch_ln_bwd_as<T, PX, 8>);
    case 16:
      return run(ln_bwd_kernel<T, PX, 16>, launch_ln_bwd_as<T, PX, 16>);
    case 32:
      return run(ln_bwd_kernel<T, PX, 32>, launch_ln_bwd_as<T, PX, 32>);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t ln_bwd_any(const void* g, const float* xhat, const float* rstd,
                       const float* w, void* gx, float* part, int N, int C,
                       long long S, int px, int bx, cudaStream_t st,
                       int* occ) {
  switch (px) {
    case 32:
      return ln_bwd_px<T, 32>(g, xhat, rstd, w, gx, part, N, C, S, bx, st,
                              occ);
    case 16:
      return ln_bwd_px<T, 16>(g, xhat, rstd, w, gx, part, N, C, S, bx, st,
                              occ);
    case 8:
      return ln_bwd_px<T, 8>(g, xhat, rstd, w, gx, part, N, C, S, bx, st,
                             occ);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Blocks of K6 (pixel tile px, C channels; bf16 g when is_bf16) that the
// CUDA runtime places on one SM (-1: the tile or C is not taken).
int ln_bwd_blocks_per_sm(int C, int px, int is_bf16) {
  int occ = -1;
  cudaError_t e =
      is_bf16 ? ln_bwd_any<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, 1, C, 1, px, 1,
                                          nullptr, &occ)
              : ln_bwd_any<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, 1, C, 1, px, 1, nullptr, &occ);
  return e == cudaSuccess ? occ : -1;
}

// px: pixels per block, 32, 16 or 8 (ops/layernorm.py:ln_fwd_tile)
int ln_fwd(const void* x, const float* w, const float* b, void* y, float* xhat,
           float* rstd, int N, int C, long long S, float eps, int is_bf16,
           int px, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)run_ln_fwd<__nv_bfloat16>(x, w, b, y, xhat, rstd, N, C, S,
                                          eps, px, st);
  return (int)run_ln_fwd<float>(x, w, b, y, xhat, rstd, N, C, S, eps, px, st);
}

// part: fp32 [2, N * bx, C]; gwb: fp32 [2, C] (gw, then gb). px: pixels
// per tile, 32, 16 or 8, with at most 32 channels a thread; bx: blocks per
// image, 1 <= bx <= ceil(S / px) (ops/layernorm.py:ln_bwd_tile,
// ln_bwd_grid).
int ln_bwd(const void* g, const float* xhat, const float* rstd, const float* w,
           void* gx, float* part, float* gwb, int N, int C, long long S,
           int is_bf16, int px, int bx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((px != 8 && px != 16 && px != 32) || bx < 1 || bx > (S + px - 1) / px)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      is_bf16 ? ln_bwd_any<__nv_bfloat16>(g, xhat, rstd, w, gx, part, N, C, S,
                                          px, bx, st, nullptr)
              : ln_bwd_any<float>(g, xhat, rstd, w, gx, part, N, C, S, px, bx,
                                  st, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows_split(part, gwb, 2, N * bx, C, st);
}

}  // extern "C"
