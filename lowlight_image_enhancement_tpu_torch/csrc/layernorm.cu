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
//   Design: the same pixel-per-thread mapping for gx (two passes over the
//   column). gw and gb are sums over every pixel, and blocks on this card
//   run in no order: each block reduces its 256 pixels per channel (warp
//   shuffles, then shared memory across the 8 warps) and writes one fp32
//   row of partials [2, blocks, C]; sum_rows adds the rows in a fixed order.
//   No float atomics: the same inputs give the same bits.
//
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
// K6: grid (ceil(S / kThreads), N), block kThreads; part is [2, blocks, C]
// with blocks = gridDim.x * gridDim.y (gw partials, then gb partials)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ g, const float* __restrict__ xhat,
    const float* __restrict__ rstd, const float* __restrict__ w,
    T* __restrict__ gx, float* __restrict__ part, int C, long long S) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red_s[2][kWarps][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long s = (long long)blockIdx.x * kThreads + tid;
  const bool live = s < S;
  const int n = blockIdx.y;
  const long long base = (long long)n * C * S + (live ? s : 0);

  float m1 = 0.f, m2 = 0.f, r = 0.f;
  if (live) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < C; ++c) {
      const long long o = base + (long long)c * S;
      const float gw_ = to_f<T>(g[o]) * w[c];
      s1 += gw_;
      s2 = fmaf(gw_, xhat[o], s2);
    }
    m1 = s1 / C;
    m2 = s2 / C;
    r = rstd[(long long)n * S + s];
  }

  const long long blocks = (long long)gridDim.x * gridDim.y;
  const long long blk = (long long)n * gridDim.x + blockIdx.x;
  float* pw = part + blk * C;
  float* pb = part + (blocks + blk) * C;

  // 32 channels at a time: lane j of each warp keeps the warp's sums of
  // channel c0 + j, then the first two warps add the 8 warps in order
  for (int c0 = 0; c0 < C; c0 += 32) {
    float keep_w = 0.f, keep_b = 0.f;
    for (int j = 0; j < 32 && c0 + j < C; ++j) {
      const int c = c0 + j;
      float gv = 0.f, xh = 0.f;
      if (live) {
        const long long o = base + (long long)c * S;
        gv = to_f<T>(g[o]);
        xh = xhat[o];
        const float gxh = gv * w[c];
        gx[o] = from_f<T>((gxh - m1 - xh * m2) * r);
      }
      const float sw = warp_sum(gv * xh);
      const float sb = warp_sum(gv);
      if (lane == j) {
        keep_w = sw;
        keep_b = sb;
      }
    }
    red_s[0][warp][lane] = keep_w;
    red_s[1][warp][lane] = keep_b;
    __syncthreads();
    if (tid < 64) {
      const int which = tid >> 5;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) acc += red_s[which][q][lane];
      if (c0 + lane < C) (which ? pb : pw)[c0 + lane] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Blocks K6 writes partials for: the rows of its [2, blocks, C] workspace.
int ln_bwd_blocks(int N, long long S) {
  return N * (int)((S + nafblk::kThreads - 1) / nafblk::kThreads);
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

// part: fp32 [2, ln_bwd_blocks(N, S), C]; gwb: fp32 [2, C] (gw, then gb)
int ln_bwd(const void* g, const float* xhat, const float* rstd, const float* w,
           void* gx, float* part, float* gwb, int N, int C, long long S,
           int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)N);
  if (is_bf16) {
    ln_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)g, xhat, rstd, w, (__nv_bfloat16*)gx, part, C,
        S);
  } else {
    ln_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)g, xhat, rstd, w, (float*)gx, part, C, S);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows(part, gwb, 2, ln_bwd_blocks(N, S), C, st);
}

}  // extern "C"
