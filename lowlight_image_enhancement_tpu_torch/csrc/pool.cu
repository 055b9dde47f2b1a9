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
// Design (both): one thread per window. The two loads a thread makes from
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
// K7: one thread per output element; grid ceil(NC * Ho * Wo / kThreads)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) relu_pool_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long NC, int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = NC * Ho * Wo;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int ow = (int)(i % Wo);
  const int oh = (int)((i / Wo) % Ho);
  const long long p = i / ((long long)Wo * Ho);
  const T* r0 = x + (p * H + 2 * oh) * W + 2 * ow;
  const T* r1 = r0 + W;
  const float a = nan_max(to_f<T>(r0[0]), 0.f);
  const float b = nan_max(to_f<T>(r0[1]), 0.f);
  const float c = nan_max(to_f<T>(r1[0]), 0.f);
  const float d = nan_max(to_f<T>(r1[1]), 0.f);
  y[i] = from_f<T>(nan_max(nan_max(a, b), nan_max(c, d)));
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

// K7. x: [NC, H, W], y: [NC, H/2, W/2] (fp32, or bf16 when is_bf16).
int relu_pool_fwd(const void* x, void* y, long long NC, int H, int W,
                  int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = NC * (H / 2) * (W / 2);
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  if (is_bf16) {
    relu_pool_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, NC, H, W);
  } else {
    relu_pool_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (float*)y, NC, H, W);
  }
  return (int)cudaGetLastError();
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
