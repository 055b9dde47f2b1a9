// Fused NAFBlock forward for Hopper (sm_90a): kernels K1 (nafblk_a) and K2
// (nafblk_b), bound to Python through a plain C interface (ctypes).
//
// Layout: activations are contiguous NCHW viewed as [N, C, H*W]; vectors
// are fp32 [C]; matrices row-major [Cout, Cin], already rounded to the
// compute type: bf16 for the tensor-core route, fp32 (holding bf16 values
// when the activations are bf16) for the FMA route.
//
// K1 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_a (pallas_call in _call_a).
//   LN1 (fp32 stats, eps) -> conv1 1x1 C->2C -> 3x3 depthwise with zero
//   SAME padding of the conv1 OUTPUT -> SimpleGate, writing the gate g and
//   the per-(n, c) spatial sums of g (fp32, taken before g is rounded to
//   the activation type) for the SCA mean.
//   Bound: moves ~2*C*HW activation elements per image and does ~4*C^2*HW
//   FLOPs: in bf16 on the tensor cores bytes bound it up to C = 256,
//   operations from C = 512.
//
// K2 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_b (pallas_call in _call_b).
//   g * att -> conv3 C->C -> z = x + beta * . -> LN2 -> conv4 C->2F ->
//   gate -> conv5 F->C -> out = z + gamma * .
//   Bound: moves ~3*C*HW activation elements and does ~8*C^2*HW FLOPs (at
//   F = C): in bf16 on the tensor cores bytes bound it up to C = 128,
//   operations from C = 256.
//
// Two routes; the wrapper (ops/nafblock.py) chooses by dtype and shape and
// passes tile = 0 for the FMA route:
//
// - Tensor cores (bf16 with C and F multiples of 16; nafblock_fwd_mma.cuh).
//   Every product is mma.sync m16n8k16 with fp32 accumulators, as in K3/K4.
//   K1 is split where the depthwise halo is, as K4 is, so each product is
//   computed once per pixel: k1_front_kernel (pixel tiles, every channel:
//   LN1, h, t = W1 h + b1 as fp32 into the caller's t), k1_dw_kernel (2-D
//   tiles x channel pairs: the depthwise step, the gate, the partial sums
//   of g), then sum_rows. The price is the round trip of t through HBM:
//   16 C bytes a pixel against the 4 C of x and g. K2 is one kernel,
//   k2_mma_kernel, with z, q in fp32 and the product operands in bf16 in
//   shared memory. The wrapper chooses the pixel tiles and the grids
//   (ops/nafblock.py: k1_geometry, k2_geometry) so that one round of
//   blocks fills the card; here they are only checked.
//
// - FMA (fp32, and bf16 with C % 16 != 0; the first port's kernels, any
//   C and F). The matrices come with each row zero-padded to pitch4 of its
//   length (the caller pads them), so a row is read as float4 at any
//   width; activations keep the true C, every statistic and sum runs over
//   the true C, and a read of 4 channels at once stops at C. k1_kernel: one block owns a 16x16 halo tile (14x14 output
//   pixels, one thread per halo pixel) and 16 gate channels, and each
//   thread recomputes LN1 and the 32 conv1 rows it needs for its halo
//   pixel straight from x (every block of 16 gate channels repeats them),
//   so t lives in shared memory only; halo pixels outside the image hold
//   t = 0 (not b1), as the TPU kernel's row-validity mask does; per-tile
//   partials of the sums are added by sum_rows. k2_kernel: one block owns
//   P consecutive pixels and all channels; z (fp32), the conv3/conv4
//   input and the gate product stay in shared memory ((2C + F) * P * 4
//   bytes: P = 32 up to C = F = 512, P = 16 at C = F = 1024); groups of P
//   lanes split the output channels, a lane owns one pixel. fp32 stays
//   here because TF32 would break the 1e-4 tolerance.
//
// Numerics follow the TPU kernels: LN statistics and all elementwise math
// in fp32; matrix-product operands rounded to the compute type with fp32
// accumulation (bf16 x bf16 products are exact in fp32).
//
// Kernels run on the caller's stream and allocate nothing: the caller
// passes a workspace of nafblk_a_workspace() bytes to K1. Every entry point
// returns cudaGetLastError() of its launches (0 = success).

#include "nafblock_common.cuh"
#include "nafblock_fwd_mma.cuh"

namespace {

using namespace nafblk;

// K1 tiling (FMA route)
constexpr int kHaloH = 16;
constexpr int kHaloW = 16;
constexpr int kTileH = kHaloH - 2;
constexpr int kTileW = kHaloW - 2;
constexpr int kGateChunk = 16;  // gate channels per K1 block

// ---------------------------------------------------------------------------
// K1 (FMA route): LN1 -> conv1 -> depthwise 3x3 -> SimpleGate (+ SCA
// partial sums). grid (tiles, ceil(C / kGateChunk), N), block kThreads
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

    // conv1 rows j0..j0+KO (first gate half) and C+j0.. (second half);
    // W1's rows are ldc = pitch4(C) long, and channels past C count 0
    const int ldc = pitch4(C);
    for (int c = 0; c < C; c += 4) {
      float h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h[q] = 0.f;
        if (c + q < C) {
          const float xv = to_f<T>(xn[(long long)(c + q) * HW]);
          h[q] = to_cdt<T>(fmaf((xv - mu) * rstd, w1n[c + q], b1n[c + q]));
        }
      }
#pragma unroll
      for (int r = 0; r < KO; ++r) {
        const int j = j0 + r;
        if (j < C) {
          const float4 wa = ldg4(W1 + (long long)j * ldc + c);
          const float4 wb = ldg4(W1 + (long long)(C + j) * ldc + c);
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

// ---------------------------------------------------------------------------
// K2 (FMA route): SCA scale -> conv3 -> residual -> LN2 -> conv4 -> gate
//     -> conv5 -> residual.  grid (ceil(HW / P), N), block kThreads,
//     dynamic smem.
//     P = 32 pixels per block (one per lane of a warp) while (2C + F) * 32
//     fp32 values fit in shared memory (C <= 512 at F = C), else P = 16
//     (two 16-lane groups per warp; C = F = 1024 needs 192 KB).
// ---------------------------------------------------------------------------

template <typename T, int KO, int P>
__global__ void __launch_bounds__(kThreads) k2_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ att, const float* __restrict__ W3,
    const float* __restrict__ b3, const float* __restrict__ w2n,
    const float* __restrict__ b2n, const float* __restrict__ W4,
    const float* __restrict__ b4, const float* __restrict__ W5,
    const float* __restrict__ b5, const float* __restrict__ beta,
    const float* __restrict__ gamma, T* __restrict__ out, int C, int F,
    long long HW, float eps) {
  constexpr int G = kThreads / P;
  extern __shared__ float smem[];
  float* z_s = smem;            // [C][P]  z (fp32)
  float* a_s = z_s + C * P;     // [C][P]  conv3 input, then LN2 output
  float* w_s = a_s + C * P;     // [F][P]  gate product
  __shared__ float red_s[G * P];

  const int lane = threadIdx.x % P;
  const int grp = threadIdx.x / P;
  const int n = blockIdx.y;
  const long long p = (long long)blockIdx.x * P + lane;
  const bool valid = p < HW;
  const long long base = (long long)n * C * HW + p;
  // row pitches of the matrices: [C, ldc] W3 and W4, [C, ldf] W5
  const int ldc = pitch4(C), ldf = pitch4(F);

  for (int c = grp; c < C; c += G) {
    const float xv = valid ? to_f<T>(x[base + (long long)c * HW]) : 0.f;
    const float gv = valid ? to_f<T>(g[base + (long long)c * HW]) : 0.f;
    z_s[c * P + lane] = xv;
    a_s[c * P + lane] = to_cdt<T>(gv * att[(long long)n * C + c]);
  }
  __syncthreads();

  // conv3 + beta residual: z = x + beta * (W3 v + b3)
  for (int o0 = grp * KO; o0 < C; o0 += G * KO) {
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO, P>(W3, ldc, C, o0, C, a_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int o = o0 + r;
      if (o < C) z_s[o * P + lane] += beta[o] * (acc[r] + b3[o]);
    }
  }
  __syncthreads();

  // LN2 per pixel (two passes, channel groups combined in smem)
  float mu, rstd;
  ln_stats<P>(z_s, C, red_s, grp, lane, eps, mu, rstd);
  for (int c = grp; c < C; c += G)
    a_s[c * P + lane] =
        to_cdt<T>(fmaf((z_s[c * P + lane] - mu) * rstd, w2n[c], b2n[c]));
  __syncthreads();

  // conv4 + SimpleGate: wv[j] = (W4[j] h2 + b4[j]) * (W4[F + j] h2 + b4[F + j])
  for (int j0 = grp * KO; j0 < F; j0 += G * KO) {
    float qa[KO], qb[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) qa[r] = qb[r] = 0.f;
    rows_dot<KO, P>(W4, ldc, C, j0, F, a_s, lane, qa);
    rows_dot<KO, P>(W4 + (long long)F * ldc, ldc, C, j0, F, a_s, lane, qb);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int j = j0 + r;
      if (j < F)
        w_s[j * P + lane] = to_cdt<T>((qa[r] + b4[j]) * (qb[r] + b4[F + j]));
    }
  }
  __syncthreads();

  // conv5 + gamma residual: out = z + gamma * (W5 wv + b5)
  for (int o0 = grp * KO; o0 < C; o0 += G * KO) {
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO, P>(W5, ldf, F, o0, C, w_s, lane, acc);
    if (valid) {
#pragma unroll
      for (int r = 0; r < KO; ++r) {
        const int o = o0 + r;
        if (o < C)
          out[base + (long long)o * HW] =
              from_f<T>(z_s[o * P + lane] + gamma[o] * (acc[r] + b5[o]));
      }
    }
  }
}

struct K2Args {
  const void *x, *g, *att, *W3, *b3, *w2n, *b2n, *W4, *b4, *W5, *b5, *beta,
      *gamma;
  void* out;
  int N, C, F;
  long long HW;
  float eps;
};

template <typename T, int KO, int P>
cudaError_t launch_k2(const K2Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * a.C + a.F) * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel<T, KO, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.HW + P - 1) / P), (unsigned)a.N);
  k2_kernel<T, KO, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g),
      static_cast<const float*>(a.att), static_cast<const float*>(a.W3),
      static_cast<const float*>(a.b3), static_cast<const float*>(a.w2n),
      static_cast<const float*>(a.b2n), static_cast<const float*>(a.W4),
      static_cast<const float*>(a.b4), static_cast<const float*>(a.W5),
      static_cast<const float*>(a.b5), static_cast<const float*>(a.beta),
      static_cast<const float*>(a.gamma), static_cast<T*>(a.out), a.C, a.F,
      a.HW, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k2_rows(const K2Args& a, int P, cudaStream_t s) {
  // rows per thread: enough that the groups cover C in about one pass
  if (P == 16) return launch_k2<T, 16, 16>(a, s);
  if (a.C <= 32) return launch_k2<T, 4, 32>(a, s);
  if (a.C <= 64) return launch_k2<T, 8, 32>(a, s);
  return launch_k2<T, 16, 32>(a, s);
}

// Number of FMA-route K1 spatial tiles for an H x W image (sizes its
// partials).
int a_tiles(int H, int W) {
  return ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

// ---------------------------------------------------------------------------
// K1 in bf16: k1_front_kernel -> k1_dw_kernel -> sum_rows
// ---------------------------------------------------------------------------

bool a_mma_ok(int C, int H, int W, int P, int BX, int DX) {
  const long long HW = (long long)H * W;
  return (P == 8 || P == 16 || P == 32) && C % 16 == 0 && C > 0 &&
         BX >= 1 && BX <= (HW + P - 1) / P && DX >= 1 &&
         DX <= k1_dw_tiles(H, W) &&
         (long long)k1_front_smem(C, P) <= kSmemLimit;
}

// The workspace of the bf16 K1: the depthwise blocks' partial sums
// [N, DX, C]. t fp32 [N, 2C, HWp] (HWp = HW rounded up to 8, so rows stay
// 16-byte aligned) is an argument of its own.
long long t_row(long long HW) { return (HW + 7) / 8 * 8; }

template <int P>
const void* k1_front_p(int C) {
  return k1_resident(C) ? (const void*)k1_front_kernel<P, true>
                        : (const void*)k1_front_kernel<P, false>;
}

const void* k1_front(int C, int P) {
  return P == 32 ? k1_front_p<32>(C)
                 : P == 16 ? k1_front_p<16>(C) : k1_front_p<8>(C);
}

struct AArgs {
  const void *x, *w1n, *b1n, *W1, *b1, *kdw, *bk;
  void *g, *sums, *t, *ws;
  int N, C, H, W;
  float eps;
};

cudaError_t run_a_mma(const AArgs& a, int P, int BX, int DX, cudaStream_t s) {
  const int C = a.C, N = a.N;
  if (!a_mma_ok(C, a.H, a.W, P, BX, DX) || !aligned16(a.W1) ||
      !aligned16(a.t))
    return cudaErrorInvalidValue;
  Carver cv{static_cast<char*>(a.ws)};
  const long long HW = (long long)a.H * a.W;
  float* part = cv.take<float>((size_t)N * DX * C);
  K1Mma k;
  k.x = static_cast<const bf16*>(a.x);
  k.w1n = static_cast<const float*>(a.w1n);
  k.b1n = static_cast<const float*>(a.b1n);
  k.b1 = static_cast<const float*>(a.b1);
  k.kdw = static_cast<const float*>(a.kdw);
  k.bk = static_cast<const float*>(a.bk);
  k.W1 = static_cast<const bf16*>(a.W1);
  k.g = static_cast<bf16*>(a.g);
  k.t = static_cast<float*>(a.t);
  k.part = part;
  k.C = C;
  k.H = a.H;
  k.W = a.W;
  k.HW = HW;
  k.HWp = t_row(HW);
  k.tiles = (int)((HW + P - 1) / P);
  k.vec = HW % 8 == 0 && aligned16(a.x);
  k.eps = a.eps;
  cudaError_t err;
  if ((err = launch_kernel(k1_front(C, P),
                           dim3((unsigned)BX, (unsigned)N),
                           k1_front_smem(C, P), k, s)))
    return err;
  if ((err = launch_kernel((const void*)k1_dw_kernel,
                           dim3((unsigned)C, (unsigned)DX, (unsigned)N), 0,
                           k, s)))
    return err;
  // sums[n, c] = sum over d of part[n, d, c], in block order
  return launch_sum_rows(part, static_cast<float*>(a.sums), N, DX, C, s);
}

// ---------------------------------------------------------------------------
// K2 in bf16: k2_mma_kernel
// ---------------------------------------------------------------------------

bool b_mma_ok(int C, int F, long long HW, int P, int BX) {
  return (P == 8 || P == 16 || P == 32) && C % 16 == 0 && F % 16 == 0 &&
         C > 0 && F > 0 && BX >= 1 && BX <= (HW + P - 1) / P &&
         (long long)k2_mma_smem(C, F, P) <= kSmemLimit;
}

template <int P>
const void* k2_mma_p(int C, int F) {
  return resident(C, F) ? (const void*)k2_mma_kernel<P, true>
                        : (const void*)k2_mma_kernel<P, false>;
}

const void* k2_mma(int C, int F, int P) {
  return P == 32 ? k2_mma_p<32>(C, F)
                 : P == 16 ? k2_mma_p<16>(C, F) : k2_mma_p<8>(C, F);
}

cudaError_t run_b_mma(const K2Args& a, int P, int BX, cudaStream_t s) {
  if (!b_mma_ok(a.C, a.F, a.HW, P, BX) || !aligned16(a.W3) ||
      !aligned16(a.W4) || !aligned16(a.W5))
    return cudaErrorInvalidValue;
  K2Mma k;
  k.x = static_cast<const bf16*>(a.x);
  k.g = static_cast<const bf16*>(a.g);
  k.att = static_cast<const float*>(a.att);
  k.W3 = static_cast<const bf16*>(a.W3);
  k.W4 = static_cast<const bf16*>(a.W4);
  k.W5 = static_cast<const bf16*>(a.W5);
  k.b3 = static_cast<const float*>(a.b3);
  k.w2n = static_cast<const float*>(a.w2n);
  k.b2n = static_cast<const float*>(a.b2n);
  k.b4 = static_cast<const float*>(a.b4);
  k.b5 = static_cast<const float*>(a.b5);
  k.beta = static_cast<const float*>(a.beta);
  k.gamma = static_cast<const float*>(a.gamma);
  k.out = static_cast<bf16*>(a.out);
  k.C = a.C;
  k.F = a.F;
  k.HW = a.HW;
  k.tiles = (int)((a.HW + P - 1) / P);
  k.vec = a.HW % 8 == 0 && aligned16(a.x) && aligned16(a.g) &&
          aligned16(a.out);
  k.eps = a.eps;
  return launch_kernel(k2_mma(a.C, a.F, P),
                       dim3((unsigned)BX, (unsigned)a.N),
                       k2_mma_smem(a.C, a.F, P), k, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of k1_front_kernel and k2_mma_kernel with a
// tile of P pixels.
long long nafblk_a_mma_smem(int C, int P) {
  return (long long)k1_front_smem(C, P);
}
long long nafblk_b_mma_smem(int C, int F, int P) {
  return (long long)k2_mma_smem(C, F, P);
}

// Blocks of k1_front_kernel, k1_dw_kernel and k2_mma_kernel that share one
// SM of the current device, as the CUDA runtime counts them from the built
// kernels' registers and shared memory (-1: the tile is not taken or a
// call failed).
int nafblk_a_mma_blocks_per_sm(int C, int P) {
  if (!a_mma_ok(C, 1, P, P, 1, 1)) return -1;
  return occupancy(k1_front(C, P), k1_front_smem(C, P));
}
int nafblk_a_dw_blocks_per_sm() {
  return occupancy((const void*)k1_dw_kernel, 0);
}
int nafblk_b_mma_blocks_per_sm(int C, int F, int P) {
  if (!b_mma_ok(C, F, P, P, 1)) return -1;
  return occupancy(k2_mma(C, F, P), k2_mma_smem(C, F, P));
}

// Workspace bytes nafblk_a needs (-1: the shape or geometry is not taken).
// tile, dw_grid: the bf16 route's pixels per tile (8, 16 or 32) and blocks
// per (image, channel pair) of its depthwise kernel; tile = 0 is the FMA
// route (its per-tile partial sums).
long long nafblk_a_workspace(int N, int C, int H, int W, int tile, int grid,
                             int dw_grid) {
  Carver cv{nullptr};
  if (tile) {
    if (!a_mma_ok(C, H, W, tile, grid, dw_grid)) return -1;
    cv.take<float>((size_t)N * dw_grid * C);
  } else {
    cv.take<float>((size_t)N * a_tiles(H, W) * C);
  }
  return (long long)cv.off;
}

// K1. x, g: [N, C, H*W]; sums: [N, C] fp32; ws: workspace. tile = 0: the
// FMA route (x fp32, or bf16 when is_bf16; W1 fp32 [2C, pitch4(C)], rows
// zero-padded; any C; t unused);
// tile > 0: the tensor-core route (x and W1 bf16, C % 16 == 0, the geometry
// nafblk_a_workspace takes), which writes the front stage's output to t:
// fp32 [N, 2C, H*W rounded up to 8].
int nafblk_a(const void* x, const void* w1n, const void* b1n, const void* W1,
             const void* b1, const void* kdw, const void* bk, void* g,
             void* sums, void* t, void* ws, int N, int C, int H, int W,
             float eps, int is_bf16, int tile, int grid, int dw_grid,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    const AArgs a{x, w1n, b1n, W1, b1, kdw, bk, g, sums, t, ws,
                   N, C, H, W, eps};
    return (int)run_a_mma(a, tile, grid, dw_grid, s);
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int n_tiles = a_tiles(H, W);
  const dim3 grid3((unsigned)n_tiles,
                   (unsigned)((C + kGateChunk - 1) / kGateChunk), (unsigned)N);
#define K1_ARGS(T)                                                          \
  static_cast<const T*>(x), static_cast<const float*>(w1n),                \
      static_cast<const float*>(b1n), static_cast<const float*>(W1),       \
      static_cast<const float*>(b1), static_cast<const float*>(kdw),       \
      static_cast<const float*>(bk), static_cast<T*>(g),                   \
      static_cast<float*>(ws), C, H, W, tiles_x, eps
  if (is_bf16)
    k1_kernel<__nv_bfloat16><<<grid3, kThreads, 0, s>>>(K1_ARGS(__nv_bfloat16));
  else
    k1_kernel<float><<<grid3, kThreads, 0, s>>>(K1_ARGS(float));
#undef K1_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // sums[n, c] = sum over tiles of part[n, tile, c], in tile order
  return (int)launch_sum_rows(static_cast<const float*>(ws),
                              static_cast<float*>(sums), N, n_tiles, C, s);
}

// FMA-route K2 pixels per block: 32 when (2C + F) * 32 fp32 values fit in
// the dynamic shared memory a Hopper block may use beside K2's static 1 KB,
// else 16; 0 when even 16 do not fit.
int nafblk_b_pixels(int C, int F) {
  const long long limit = 232448 - 1024;
  for (int P = 32; P >= 16; P /= 2)
    if ((long long)(2 * C + F) * P * 4 <= limit) return P;
  return 0;
}

// K2. x, g, out: [N, C, HW]; att: [N, C] fp32; W3 [C, C], W4 [2F, C],
// W5 [C, F]. tile = 0: the FMA route (x fp32, or bf16 when is_bf16;
// matrices fp32 with rows zero-padded to pitch4: W3 [C, pitch4(C)], W4
// [2F, pitch4(C)], W5 [C, pitch4(F)]; any C, F with nafblk_b_pixels > 0);
// tile > 0: the tensor-core route (x and matrices bf16, C % 16 == 0,
// F % 16 == 0, a tile that fits and 1 <= grid <= the image's tiles).
int nafblk_b(const void* x, const void* g, const void* att, const void* W3,
             const void* b3, const void* w2n, const void* b2n, const void* W4,
             const void* b4, const void* W5, const void* b5, const void* beta,
             const void* gamma, void* out, int N, int C, int F, long long HW,
             float eps, int is_bf16, int tile, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K2Args a{x, g, att, W3, b3, w2n, b2n, W4, b4, W5, b5, beta, gamma,
                 out, N, C, F, HW, eps};
  if (tile) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)run_b_mma(a, tile, grid, s);
  }
  const int P = nafblk_b_pixels(C, F);
  if (P == 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch_k2_rows<__nv_bfloat16>(a, P, s);
  return (int)launch_k2_rows<float>(a, P, s);
}

}  // extern "C"
