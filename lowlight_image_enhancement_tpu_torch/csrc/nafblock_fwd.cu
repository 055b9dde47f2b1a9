// Fused NAFBlock forward for Hopper (sm_90a): kernels K1 (nafblk_a) and K2
// (nafblk_b), bound to Python through a plain C interface (ctypes).
//
// Layout: activations are contiguous NCHW viewed as [N, C, H*W]; weights are
// fp32, already rounded to the compute type (bf16 when activations are
// bf16), matrices row-major [Cout, Cin]; vectors are [C].
//
// K1 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_a (pallas_call in _call_a).
//   LN1 (fp32 stats, eps) -> conv1 1x1 C->2C -> 3x3 depthwise with zero
//   SAME padding of the conv1 OUTPUT -> SimpleGate, writing the gate g and
//   the per-(n, c) spatial sums of g (fp32, taken before g is rounded to
//   the activation type) for the SCA mean.
//   Bound: moves ~2*C*HW activation elements per image and does ~4*C^2*HW
//   FLOPs, so it is memory-bound at C <= 256 in bf16 on the tensor cores;
//   this version multiplies with fp32 FMAs (no tensor cores), which makes
//   it bound by operations at the wider stages.
//   Design: one block owns a 16x16 halo tile (14x14 output pixels, one
//   thread per halo pixel) and 16 gate channels. Each thread recomputes
//   LN1 and the 32 conv1 rows it needs for its halo pixel (rows j and C+j
//   of the gate pair) straight from x, so the 2C-wide intermediate t never
//   touches device memory; t lives in shared memory for the depthwise taps.
//   Halo pixels outside the image hold t = 0 (not conv1(0) = b1), as the
//   TPU kernel's row-validity mask does. The SCA sums are written as
//   per-tile partials [N, tiles, C] and reduced in a fixed order by a
//   second tiny kernel: deterministic, no atomics.
//
// K2 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_b (pallas_call in _call_b).
//   g * att -> conv3 C->C -> z = x + beta * . -> LN2 -> conv4 C->2F ->
//   gate -> conv5 F->C -> out = z + gamma * .
//   Bound: moves ~3*C*HW activation elements and does ~8*C^2*HW FLOPs (at
//   F = C); memory-bound at C <= 256 on the tensor cores, bound by
//   operations on the fp32 FMA path used here.
//   Design: one block owns 32 consecutive pixels and all channels. z (fp32),
//   the conv3/conv4 input and the gate product stay in shared memory
//   ((2C + F) * 32 * 4 bytes: 192 KB at C = F = 512), so each activation
//   element is read once and the output written once. Eight warps split
//   the output channels; a lane owns one pixel, so shared-memory reads are
//   conflict-free and weight reads are warp-uniform (broadcast).
//
// Numerics follow the TPU kernels: LN statistics and all elementwise math
// in fp32; matrix-product operands rounded to the compute type with fp32
// accumulation (bf16 x bf16 products are exact in fp32).
//
// Kernels run on the caller's stream and allocate nothing. Every entry
// point returns cudaGetLastError() of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// K1 tiling
constexpr int kHaloH = 16;
constexpr int kHaloW = 16;
constexpr int kTileH = kHaloH - 2;
constexpr int kTileW = kHaloW - 2;
constexpr int kGateChunk = 16;  // gate channels per K1 block
// K2 tiling
constexpr int kPix = 32;        // pixels per K2 block (one per lane)
constexpr int kGroups = kThreads / kPix;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the compute type of a matrix-product operand.
template <typename T> __device__ __forceinline__ float to_cdt(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 w, float a0, float a1, float a2,
                                      float a3, float acc) {
  acc = fmaf(w.x, a0, acc);
  acc = fmaf(w.y, a1, acc);
  acc = fmaf(w.z, a2, acc);
  return fmaf(w.w, a3, acc);
}

// ---------------------------------------------------------------------------
// K1: LN1 -> conv1 -> depthwise 3x3 -> SimpleGate (+ SCA partial sums)
// grid (tiles, ceil(C / kGateChunk), N), block kThreads
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) k1_kernel(
    const T* __restrict__ x, const float* __restrict__ w1n,
    const float* __restrict__ b1n, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ kdw,
    const float* __restrict__ bk, T* __restrict__ g, float* __restrict__ part,
    int C, int H, int W, int tiles_x, float eps) {
  constexpr int KO = kGateChunk;
  __shared__ float t_s[2 * KO][kHaloH * kHaloW];
  __shared__ float red_s[kThreads / 32][KO];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int j0 = blockIdx.y * KO;
  const int n = blockIdx.z;
  const int hr = tid / kHaloW, hc = tid % kHaloW;
  const int gr = (tile / tiles_x) * kTileH - 1 + hr;
  const int gc = (tile % tiles_x) * kTileW - 1 + hc;
  const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
  const long long HW = (long long)H * W;
  const long long pix = inside ? (long long)gr * W + gc : 0;
  const T* xn = x + (long long)n * C * HW + pix;

  float acc[2 * KO];
#pragma unroll
  for (int r = 0; r < 2 * KO; ++r) acc[r] = 0.f;

  if (inside) {
    // LN1 statistics over the C channels of this pixel (shifted one pass)
    const float k0 = to_f<T>(xn[0]);
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = to_f<T>(xn[(long long)c * HW]) - k0;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
    const float md = s1 / C;
    const float var = fmaxf(s2 / C - md * md, 0.f);
    const float mu = k0 + md;
    const float rstd = rsqrtf(var + eps);

    // conv1 rows j0..j0+KO (first gate half) and C+j0.. (second half)
    for (int c = 0; c < C; c += 4) {
      float h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = to_f<T>(xn[(long long)(c + q) * HW]);
        h[q] = to_cdt<T>(fmaf((xv - mu) * rstd, w1n[c + q], b1n[c + q]));
      }
#pragma unroll
      for (int r = 0; r < KO; ++r) {
        const int j = j0 + r;
        if (j < C) {
          const float4 wa = ldg4(W1 + (long long)j * C + c);
          const float4 wb = ldg4(W1 + (long long)(C + j) * C + c);
          acc[r] = dot4(wa, h[0], h[1], h[2], h[3], acc[r]);
          acc[KO + r] = dot4(wb, h[0], h[1], h[2], h[3], acc[KO + r]);
        }
      }
    }
  }

  // t on the halo tile; zero outside the image (SAME padding of t)
#pragma unroll
  for (int r = 0; r < KO; ++r) {
    const int j = j0 + r;
    const bool ok = inside && j < C;
    t_s[r][tid] = ok ? acc[r] + b1[j] : 0.f;
    t_s[KO + r][tid] = ok ? acc[KO + r] + b1[C + j] : 0.f;
  }
  __syncthreads();

  const bool interior = inside && hr >= 1 && hr <= kTileH && hc >= 1 &&
                        hc <= kTileW;
  const int warp = tid / 32, lane = tid % 32;
  T* gn = g + (long long)n * C * HW + pix;
#pragma unroll 1
  for (int r = 0; r < KO; ++r) {
    const int j = j0 + r;
    float gv = 0.f;
    if (interior && j < C) {
      const float* ka = kdw + (long long)j * 9;
      const float* kb = kdw + (long long)(C + j) * 9;
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int q = (hr + kh - 1) * kHaloW + (hc + kw - 1);
          ua = fmaf(ka[kh * 3 + kw], t_s[r][q], ua);
          ub = fmaf(kb[kh * 3 + kw], t_s[KO + r][q], ub);
        }
      }
      gv = (ua + bk[j]) * (ub + bk[C + j]);
      gn[(long long)j * HW] = from_f<T>(gv);
    }
    const float s = warp_sum(gv);
    if (lane == 0) red_s[warp][r] = s;
  }
  __syncthreads();
  if (tid < KO && j0 + tid < C) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red_s[w][tid];
    part[((long long)n * gridDim.x + tile) * C + j0 + tid] = s;
  }
}

// sums[n, c] = sum over tiles of part[n, tile, c], in tile order
__global__ void k1_reduce(const float* __restrict__ part,
                          float* __restrict__ sums, int C, int n_tiles) {
  const int n = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p = part + (long long)n * n_tiles * C + c;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[(long long)t * C];
  sums[(long long)n * C + c] = s;
}

// ---------------------------------------------------------------------------
// K2: SCA scale -> conv3 -> residual -> LN2 -> conv4 -> gate -> conv5 ->
//     residual.  grid (ceil(HW / kPix), N), block kThreads, dynamic smem
// ---------------------------------------------------------------------------

// acc[r] += sum_c Wm[o0 + r, c] * in_s[c, lane] for rows o0 + r < M.
template <int KO>
__device__ __forceinline__ void rows_dot(const float* __restrict__ Wm, int K,
                                         int o0, int M,
                                         const float* __restrict__ in_s,
                                         int lane, float* acc) {
  for (int c = 0; c < K; c += 4) {
    const float a0 = in_s[(c + 0) * kPix + lane];
    const float a1 = in_s[(c + 1) * kPix + lane];
    const float a2 = in_s[(c + 2) * kPix + lane];
    const float a3 = in_s[(c + 3) * kPix + lane];
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      if (o0 + r < M) {
        const float4 w = ldg4(Wm + (long long)(o0 + r) * K + c);
        acc[r] = dot4(w, a0, a1, a2, a3, acc[r]);
      }
    }
  }
}

template <typename T, int KO>
__global__ void __launch_bounds__(kThreads) k2_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ att, const float* __restrict__ W3,
    const float* __restrict__ b3, const float* __restrict__ w2n,
    const float* __restrict__ b2n, const float* __restrict__ W4,
    const float* __restrict__ b4, const float* __restrict__ W5,
    const float* __restrict__ b5, const float* __restrict__ beta,
    const float* __restrict__ gamma, T* __restrict__ out, int C, int F,
    long long HW, float eps) {
  extern __shared__ float smem[];
  float* z_s = smem;               // [C][kPix]  z (fp32)
  float* a_s = z_s + C * kPix;     // [C][kPix]  conv3 input, then LN2 output
  float* w_s = a_s + C * kPix;     // [F][kPix]  gate product
  __shared__ float red_s[kGroups][kPix];

  const int lane = threadIdx.x % kPix;
  const int grp = threadIdx.x / kPix;
  const int n = blockIdx.y;
  const long long p = (long long)blockIdx.x * kPix + lane;
  const bool valid = p < HW;
  const long long base = (long long)n * C * HW + p;

  for (int c = grp; c < C; c += kGroups) {
    const float xv = valid ? to_f<T>(x[base + (long long)c * HW]) : 0.f;
    const float gv = valid ? to_f<T>(g[base + (long long)c * HW]) : 0.f;
    z_s[c * kPix + lane] = xv;
    a_s[c * kPix + lane] = to_cdt<T>(gv * att[(long long)n * C + c]);
  }
  __syncthreads();

  // conv3 + beta residual: z = x + beta * (W3 v + b3)
  for (int o0 = grp * KO; o0 < C; o0 += kGroups * KO) {
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO>(W3, C, o0, C, a_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int o = o0 + r;
      if (o < C) z_s[o * kPix + lane] += beta[o] * (acc[r] + b3[o]);
    }
  }
  __syncthreads();

  // LN2 statistics per pixel (two passes, channel groups combined in smem)
  float s = 0.f;
  for (int c = grp; c < C; c += kGroups) s += z_s[c * kPix + lane];
  red_s[grp][lane] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) s += red_s[q][lane];
  const float mu = s / C;
  __syncthreads();
  s = 0.f;
  for (int c = grp; c < C; c += kGroups) {
    const float d = z_s[c * kPix + lane] - mu;
    s = fmaf(d, d, s);
  }
  red_s[grp][lane] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) s += red_s[q][lane];
  const float rstd = rsqrtf(s / C + eps);
  for (int c = grp; c < C; c += kGroups)
    a_s[c * kPix + lane] =
        to_cdt<T>(fmaf((z_s[c * kPix + lane] - mu) * rstd, w2n[c], b2n[c]));
  __syncthreads();

  // conv4 + SimpleGate: wv[j] = (W4[j] h2 + b4[j]) * (W4[F + j] h2 + b4[F + j])
  for (int j0 = grp * KO; j0 < F; j0 += kGroups * KO) {
    float qa[KO], qb[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) qa[r] = qb[r] = 0.f;
    rows_dot<KO>(W4, C, j0, F, a_s, lane, qa);
    rows_dot<KO>(W4 + (long long)F * C, C, j0, F, a_s, lane, qb);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int j = j0 + r;
      if (j < F)
        w_s[j * kPix + lane] = to_cdt<T>((qa[r] + b4[j]) * (qb[r] + b4[F + j]));
    }
  }
  __syncthreads();

  // conv5 + gamma residual: out = z + gamma * (W5 wv + b5)
  for (int o0 = grp * KO; o0 < C; o0 += kGroups * KO) {
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO>(W5, F, o0, C, w_s, lane, acc);
    if (valid) {
#pragma unroll
      for (int r = 0; r < KO; ++r) {
        const int o = o0 + r;
        if (o < C)
          out[base + (long long)o * HW] =
              from_f<T>(z_s[o * kPix + lane] + gamma[o] * (acc[r] + b5[o]));
      }
    }
  }
}

template <typename T, int KO>
cudaError_t launch_k2(const void* x, const void* g, const void* att,
                      const void* W3, const void* b3, const void* w2n,
                      const void* b2n, const void* W4, const void* b4,
                      const void* W5, const void* b5, const void* beta,
                      const void* gamma, void* out, int N, int C, int F,
                      long long HW, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * C + F) * kPix * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel<T, KO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((HW + kPix - 1) / kPix), (unsigned)N);
  k2_kernel<T, KO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(att), static_cast<const float*>(W3),
      static_cast<const float*>(b3), static_cast<const float*>(w2n),
      static_cast<const float*>(b2n), static_cast<const float*>(W4),
      static_cast<const float*>(b4), static_cast<const float*>(W5),
      static_cast<const float*>(b5), static_cast<const float*>(beta),
      static_cast<const float*>(gamma), static_cast<T*>(out), C, F, HW, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k2_rows(int C, const void* x, const void* g,
                           const void* att, const void* W3, const void* b3,
                           const void* w2n, const void* b2n, const void* W4,
                           const void* b4, const void* W5, const void* b5,
                           const void* beta, const void* gamma, void* out,
                           int N, int F, long long HW, float eps,
                           cudaStream_t s) {
  // rows per thread: enough that the 8 warps cover C in about one pass
  if (C <= 32)
    return launch_k2<T, 4>(x, g, att, W3, b3, w2n, b2n, W4, b4, W5, b5, beta,
                           gamma, out, N, C, F, HW, eps, s);
  if (C <= 64)
    return launch_k2<T, 8>(x, g, att, W3, b3, w2n, b2n, W4, b4, W5, b5, beta,
                           gamma, out, N, C, F, HW, eps, s);
  return launch_k2<T, 16>(x, g, att, W3, b3, w2n, b2n, W4, b4, W5, b5, beta,
                          gamma, out, N, C, F, HW, eps, s);
}

}  // namespace

extern "C" {

// Number of K1 spatial tiles for an H x W image (sizes the partials).
int nafblk_a_tiles(int H, int W) {
  return ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

// K1. x, g: [N, C, H*W] (fp32, or bf16 when is_bf16); part: [N, tiles, C]
// fp32 scratch; sums: [N, C] fp32. Requires C % 4 == 0.
int nafblk_a(const void* x, const void* w1n, const void* b1n, const void* W1,
             const void* b1, const void* kdw, const void* bk, void* g,
             void* part, void* sums, int N, int C, int H, int W, float eps,
             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int n_tiles = nafblk_a_tiles(H, W);
  const dim3 grid((unsigned)n_tiles, (unsigned)((C + kGateChunk - 1) / kGateChunk),
                  (unsigned)N);
#define K1_ARGS(T)                                                          \
  static_cast<const T*>(x), static_cast<const float*>(w1n),                \
      static_cast<const float*>(b1n), static_cast<const float*>(W1),       \
      static_cast<const float*>(b1), static_cast<const float*>(kdw),       \
      static_cast<const float*>(bk), static_cast<T*>(g),                   \
      static_cast<float*>(part), C, H, W, tiles_x, eps
  if (is_bf16)
    k1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(K1_ARGS(__nv_bfloat16));
  else
    k1_kernel<float><<<grid, kThreads, 0, s>>>(K1_ARGS(float));
#undef K1_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_reduce<<<dim3((unsigned)((C + 127) / 128), (unsigned)N), 128, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), C, n_tiles);
  return (int)cudaGetLastError();
}

// K2. x, g, out: [N, C, HW]; att: [N, C] fp32; W3 [C, C], W4 [2F, C],
// W5 [C, F]. Requires C % 4 == 0 and F % 4 == 0.
int nafblk_b(const void* x, const void* g, const void* att, const void* W3,
             const void* b3, const void* w2n, const void* b2n, const void* W4,
             const void* b4, const void* W5, const void* b5, const void* beta,
             const void* gamma, void* out, int N, int C, int F, long long HW,
             float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_k2_rows<__nv_bfloat16>(C, x, g, att, W3, b3, w2n, b2n,
                                              W4, b4, W5, b5, beta, gamma, out,
                                              N, F, HW, eps, s);
  return (int)launch_k2_rows<float>(C, x, g, att, W3, b3, w2n, b2n, W4, b4, W5,
                                    b5, beta, gamma, out, N, F, HW, eps, s);
}

}  // extern "C"
