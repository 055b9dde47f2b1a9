// Helpers shared by the fused NAFBlock kernels (nafblock_fwd.cu,
// nafblock_bwd.cu): type conversion, rounding of matrix-product operands
// to the compute type, warp/group sums, the two weight-times-smem row
// products the per-pixel kernels are built from, the fixed-order row sums,
// and on the host the shared-memory limit, workspace carving and the
// runtime's occupancy count.
//
// Per-pixel kernels keep activations in shared memory as [channels][P]
// (P pixels of one image, channel-major), one pixel per lane of a P-lane
// thread group; 256 threads form 256 / P such groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nafblk {

constexpr int kThreads = 256;

// Dynamic shared memory a block may use beside a 2 KB static buffer.
constexpr long long kSmemLimit = 232448 - 2048;

// Workspace carving: the same walk sizes and splits a workspace.
struct Carver {
  char* base;
  size_t off = 0;
  template <typename U> U* take(size_t count) {
    off = (off + 255) & ~size_t(255);
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += count * sizeof(U);
    return p;
  }
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches kernel(k) on grid x kThreads threads with smem bytes of dynamic
// shared memory, the kernel's limit raised to them first: every kernel
// that takes its arguments as one struct.
template <typename Args>
inline cudaError_t launch_kernel(const void* kernel, dim3 grid, size_t smem,
                                 const Args& k, cudaStream_t s) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<Args*>(&k)};
  return cudaLaunchKernel(kernel, grid, dim3(kThreads), args, smem, s);
}

// Blocks of a kernel that the CUDA runtime places on one SM (-1: failed).
inline int occupancy(const void* kernel, size_t smem) {
  int blocks = 0;
  if (smem > 0 && cudaFuncSetAttribute(
                      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                      (int)smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

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

// Sum over the P lanes of one group (P divides 32). Every lane of the warp
// must call it.
template <int P> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// acc[r] += sum_k Wm[o0 + r, k] * in_s[k, lane] for rows o0 + r < M
// (Wm row-major [M, K], K % 4 == 0).
template <int KO, int P>
__device__ __forceinline__ void rows_dot(const float* __restrict__ Wm, int K,
                                         int o0, int M,
                                         const float* __restrict__ in_s,
                                         int lane, float* acc) {
  for (int k = 0; k < K; k += 4) {
    const float a0 = in_s[(k + 0) * P + lane];
    const float a1 = in_s[(k + 1) * P + lane];
    const float a2 = in_s[(k + 2) * P + lane];
    const float a3 = in_s[(k + 3) * P + lane];
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      if (o0 + r < M) {
        const float4 w = ldg4(Wm + (long long)(o0 + r) * K + k);
        acc[r] = dot4(w, a0, a1, a2, a3, acc[r]);
      }
    }
  }
}

// The transposed product: acc[r] += sum_k Wm[k, o0 + r] * in_s[k, lane]
// for o0 + r < M (Wm row-major [K, ldw]; ldw, o0 and M multiples of 4, so
// each float4 of a row lies wholly inside or outside [0, M)).
template <int KO, int P>
__device__ __forceinline__ void cols_dot(const float* __restrict__ Wm,
                                         int ldw, int K, int o0, int M,
                                         const float* __restrict__ in_s,
                                         int lane, float* acc) {
  for (int k = 0; k < K; ++k) {
    const float a = in_s[k * P + lane];
    const float* row = Wm + (long long)k * ldw + o0;
#pragma unroll
    for (int r = 0; r < KO; r += 4) {
      if (o0 + r < M) {
        const float4 w = ldg4(row + r);
        acc[r + 0] = fmaf(w.x, a, acc[r + 0]);
        acc[r + 1] = fmaf(w.y, a, acc[r + 1]);
        acc[r + 2] = fmaf(w.z, a, acc[r + 2]);
        acc[r + 3] = fmaf(w.w, a, acc[r + 3]);
      }
    }
  }
}

// Per-pixel channel statistics over smem [C][P] for the lane's pixel: the
// two-pass mean and centred variance of the TPU kernels' _ln_fwd. red_s is
// [G][P] scratch; every thread of the block must call it.
template <int P>
__device__ __forceinline__ void ln_stats(const float* __restrict__ v_s, int C,
                                         float* red_s, int grp, int lane,
                                         float eps, float& mu, float& rstd) {
  constexpr int G = kThreads / P;
  float s = 0.f;
  for (int c = grp; c < C; c += G) s += v_s[c * P + lane];
  red_s[grp * P + lane] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) s += red_s[q * P + lane];
  mu = s / C;
  __syncthreads();
  s = 0.f;
  for (int c = grp; c < C; c += G) {
    const float d = v_s[c * P + lane] - mu;
    s = fmaf(d, d, s);
  }
  red_s[grp * P + lane] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) s += red_s[q * P + lane];
  rstd = rsqrtf(s / C + eps);
  __syncthreads();
}

// Block-wide sum, for the lane's pixel, of the per-thread values a and b
// over all groups (red_s holds 2 * G * P floats).
template <int P>
__device__ __forceinline__ void groups_sum2(float& a, float& b, float* red_s,
                                            int grp, int lane) {
  constexpr int G = kThreads / P;
  red_s[grp * P + lane] = a;
  red_s[(G + grp) * P + lane] = b;
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    a += red_s[q * P + lane];
    b += red_s[(G + q) * P + lane];
  }
  __syncthreads();
}

// out[o * V + v] = sum over r < R, in order, of part[(o * R + r) * V + v]:
// the fixed-order second pass of every per-tile partial in the port.
__global__ void sum_rows(const float* __restrict__ part,
                         float* __restrict__ out, int R, long long V) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (v >= V) return;
  const float* p = part + (long long)o * R * V + v;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += p[(long long)r * V];
  out[(long long)o * V + v] = s;
}

inline cudaError_t launch_sum_rows(const float* part, float* out, int O,
                                   int R, long long V, cudaStream_t s) {
  const dim3 grid((unsigned)((V + 255) / 256), (unsigned)O);
  sum_rows<<<grid, 256, 0, s>>>(part, out, R, V);
  return cudaGetLastError();
}

// The same sums for few columns and many rows (a few hundred partial rows
// of a few hundred values): a block of 1024 threads takes 32 columns, its
// 32 warps the rows r = w, w + 32, ... each in order, and the 32 warp sums
// are added in order. Another fixed order than sum_rows', so as
// deterministic.
constexpr int kSplitWarps = 32;

__global__ void __launch_bounds__(32 * kSplitWarps) sum_rows_split(
    const float* __restrict__ part, float* __restrict__ out, int R,
    long long V) {
  __shared__ float red_s[kSplitWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long v = (long long)blockIdx.x * 32 + lane;
  const int o = blockIdx.y;
  float s = 0.f;
  if (v < V) {
    const float* p = part + (long long)o * R * V + v;
#pragma unroll 8
    for (int r = warp; r < R; r += kSplitWarps) s += p[(long long)r * V];
  }
  red_s[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && v < V) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kSplitWarps; ++q) t += red_s[q][lane];
    out[(long long)o * V + v] = t;
  }
}

inline cudaError_t launch_sum_rows_split(const float* part, float* out, int O,
                                         int R, long long V, cudaStream_t s) {
  const dim3 grid((unsigned)((V + 31) / 32), (unsigned)O);
  sum_rows_split<<<grid, 32 * kSplitWarps, 0, s>>>(part, out, R, V);
  return cudaGetLastError();
}

}  // namespace nafblk
