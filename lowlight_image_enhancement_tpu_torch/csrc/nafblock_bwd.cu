// Fused NAFBlock backward for Hopper (sm_90a): kernels K3 (nafblk_p1) and K4
// (nafblk_p2), bound to Python through a plain C interface (ctypes).
//
// Layout as in nafblock_fwd.cu: activations contiguous NCHW viewed as
// [N, C, H*W]; vectors fp32 [C]; matrices row-major [Cout, Cin], already
// rounded to the compute type: bf16 for the tensor-core kernels (which feed
// them to the tensor cores as they are), fp32 (holding bf16 values when the
// activations are bf16) for the FMA kernels. Every weight gradient is fp32.
//
// Two routes per kernel, chosen by the wrapper from dtype and shape
// (ops/nafblock.py:p1_geometry, p2_geometry) and passed as tile > 0 or
// tile = 0: bf16 with C and F multiples of 16 (one tensor-core step) runs
// the tensor-core kernels; fp32, and bf16 at any other C, run the FMA
// kernels of the first port, instantiated for the activation type. Their
// matrices come with rows zero-padded to pitch4 (nafblock_common.cuh), so
// they take any C and F; the weight gradients come back at true shapes.
//
// K3 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_p1 (pallas_call in _call_p1).
//   Recomputes the block's second half from (x, g, att) -- v = g * att,
//   pth = W3 v + b3, z = x + beta * pth, LN2, q = W4 h2 + b4,
//   wv = q1 * q2, s = W5 wv + b5 -- and back-propagates dout through it:
//   dz (stored in dout's type), the per-(n, c) SCA grad da = sum_p dv * g,
//   and the fp32 grads of W3, b3, norm2, W4, b4, W5, b5, beta, gamma.
//   Bound: reads x, g, dout and writes dz (4 * C * HW activation elements
//   per image); ~24 * C^2 FLOPs per pixel at F = C (8 C^2 recompute, 8 C^2
//   input-side products, 8 C^2 weight-gradient outer products): the same
//   7.2 GFLOP at every width of a 2 x 384 x 384 U-net pass, 0.007 ms at
//   the bf16 tensor-core peak, so bytes bound it up to C ~ 64 (0.02 ms at
//   C = 32) and operations above.
//
//   In bf16 (nafblock_p1_mma.cuh) every product runs on the tensor cores
//   as mma.sync.m16n8k16 with fp32 accumulators, operands by ldmatrix:
//   - k3_mma_kernel: a block walks tiles of P pixels (32, 16 or 8; the
//     wrapper chooses the tile and the blocks per image so that the card
//     is full, ops/nafblock.py:p1_tile and p1_grid) of one image, with
//     every channel. The product operands v, h2, wv, ds, dq, dp live
//     in shared memory as bf16 [channels][P]: channel-major is what
//     ldmatrix.trans turns into the B fragments, so nothing is transposed;
//     z/xhat2, pth, q (then dh2) stay fp32 as in the TPU kernel: 22 C
//     bytes a pixel at F = C against 28 C of the fp32 kernel, and dq
//     reuses the space of h2 and wv. The weights come as bf16 and pass
//     through a ring of three 128 x 32 slabs in shared memory (cp.async,
//     two loads in flight, XOR-swizzled chunks instead of padding; a
//     deeper ring bought nothing, while computing a slab's offsets once
//     and not for every slab took a third off the time); the transposed
//     products
//     read the same slabs with ldmatrix.trans, so no transposed copy of a
//     weight exists. Up to C = F = 64 the three matrices (at most 36 KB),
//     the vectors and the block's partial sums stay in shared memory for
//     all the tiles a block walks: no ring, one barrier per product, no
//     round trip to global memory for a sum, three blocks on an SM. A
//     warp owns 16 output rows and all P pixels, so a row's sum over the
//     tile (every vector gradient) stays inside the warp: four lanes by
//     shuffle. A block adds its tiles' sums into its own row of partials;
//     sum_rows adds the rows. x, g and dout are read 16 bytes a thread
//     where H*W allows; the six operand streams go to the workspace 16
//     bytes a thread.
//   - wgrad_mma_kernel: the three weight gradients in one launch. Both
//     operands of a gradient are [channels][H*W] with the contraction
//     index contiguous, which is what mma takes for A and for B. 64 x 64
//     tiles, the pixels split into chunks so that ~264 blocks run; fp32
//     partials, one row per chunk, added by sum_rows in a fixed order.
//   No float atomics anywhere: two runs give the same bits. One call is 5
//   launches (it was 9). What limits it now: at C >= 128 the instructions
//   around each slab's few tensor-core operations (a slab is 2 to 8
//   mma per warp and one block barrier), at C <= 64 the chain of short
//   phases of one tile (six products and six elementwise passes with a
//   barrier between them; two of eight warps own rows at C = 32).
//   mma.sync and not wgmma: a call is 7.2 GFLOP, which mma.sync at half
//   the peak would do in 0.015 ms; the kernel is far from either rate,
//   and wgmma's 64-row tiles would leave C = 32 and C = 48 half empty.
//
//   The FMA route (fp32: TF32 would break the 1e-4 tolerance; bf16 at C or
//   F no multiple of 16, whose bf16 operands round to bf16 where the
//   tensor-core route rounds them): k3_kernel owns P pixels and all
//   channels, like K2;
//   v, z/xhat2, pth, ds/dp, q/dq and wv stay in shared memory ((4C + 3F)
//   * P * 4 bytes: P = 32 up to C = F = 256, P = 16 at C = F = 512). It
//   writes the two operands of each weight gradient to a workspace, and
//   wgrad_kernel (a tiled 64 x 64 fp32 product split over pixel chunks)
//   writes partials that sum_rows adds in a fixed order.
//
// K4 -- replaces lowlight_image_enhancement_tpu/ops/pallas/nafblock.py:
//       _kernel_p2 (pallas_call in _call_p2).
//   Recomputes LN1 -> conv1 -> depthwise 3x3 from x, rebuilds the gate grad
//   dg = (W3^T (beta * dz)) * att + dgc, then du, the depthwise adjoint dt,
//   the tap grads dkdw [2C, 9] and dbk, conv1's backward (dW1, db1, dh),
//   LN1's backward (dw1n, db1n) and dx = LN1^T(dh) + dz (in dz's type).
//   The gate grad uses u = dw3x3(t) + bk, the block's true derivative (the
//   TPU kernel omits bk there; see ROADMAP.md, queue 3).
//   Bound: reads x and dz and writes dx (3 * C * HW elements per image);
//   ~14 * C^2 FLOPs per pixel (conv1 recompute 4 C^2, W3^T 2 C^2, W1^T
//   4 C^2, dW1 4 C^2) plus ~108 C for the depthwise parts: operations on
//   the bf16 tensor cores from C ~ 128, bytes below.
//
//   In bf16 (nafblock_p2_mma.cuh) the products run on the tensor cores as
//   K3's do (tile_gemm / tile_gemm_resident, wgrad_mma_kernel), and the
//   work is split where the depthwise stencil's halo is, so each product
//   is computed once per pixel:
//   - k4_front_kernel: pixel tiles with every channel (the tile and grid
//     of ops/nafblock.py:p2_tile, p2_grid): LN1, h, t = W1 h + b1 (fp32
//     out), dg = (W3^T bf16(beta dz)) att + dgc (fp32 out), mu and rstd;
//   - k4_dw_kernel: 2-D tiles x channel pairs on the CUDA cores, bound by
//     bytes: u, du, dt (bf16 out) and the tap grads, dbk, db1 in registers
//     over the block's tiles;
//   - k4_back_kernel: pixel tiles: dh = W1^T dt, xhat from the saved
//     statistics, dw1n / db1n by quad shuffles, LN1 backward, dx;
//   - dW1 = dt h^T by wgrad_mma_kernel; sum_rows adds each kernel's
//     per-block partial rows in a fixed order (no float atomics).
//   Up to C = 64 W1 and W3 stay in shared memory for all the tiles of a
//   block. The round trip of t, dg, h and dt through HBM is ~36 C bytes a
//   pixel: the price of computing the products once.
//
//   The FMA route (fp32, and bf16 at C no multiple of 16). The halo: dt
//   at a pixel needs du one pixel out, du needs u, so t, and hence x, two
//   pixels out, and dz one pixel out.
//   k4a_kernel tiles the image in 2-D like K1: a 16 x 16 halo tile (one
//   thread per pixel) around 12 x 12 output pixels, 16 gate channels per
//   block. Each thread recomputes LN1 and the conv1 rows j, C + j of its
//   pixel and the gate grad dg[j] from the C channels of dz; t sits in
//   shared memory with 0 outside the image (zero SAME padding of the conv1
//   output, not b1), and so does du, with dg = 0 outside the image. The
//   tile's own pixels (each image pixel belongs to exactly one tile) give
//   dt, the tap grads, dbk and db1; dt goes to the workspace (the operand
//   both of dW1 and of W1^T dt). k4b_kernel then owns P pixels and all
//   channels, as K2: LN1 again, dh = W1^T dt, LN1's backward, dx. dW1 is a
//   wgrad_kernel product of (dt, h).
//
// Numerics follow the TPU kernels: LN statistics and elementwise math in
// fp32; every matrix-product operand rounded to the compute type with fp32
// accumulation; dz in dout's type and dx in dz's type.
//
// Kernels run on the caller's stream and allocate nothing: the caller
// passes a workspace of nafblk_p{1,2}_workspace() bytes. Every entry point
// returns cudaGetLastError() of its launches (0 = success).

#include "nafblock_common.cuh"
#include "nafblock_p1_mma.cuh"
#include "nafblock_p2_mma.cuh"

namespace {

using namespace nafblk;

// ---------------------------------------------------------------------------
// Weight-gradient products: out[i, j] = sum over n, p of A[n, i, p] B[n, j, p]
// ---------------------------------------------------------------------------

constexpr int kWT = 64;         // output tile, rows and columns
constexpr int kWK = 32;         // pixels per shared-memory stage
constexpr int kWBlocks = 1024;  // blocks to aim for in one product

struct Split {
  int S;        // pixel chunks per image
  long long L;  // pixels per chunk (a multiple of kWK)
};

Split wgrad_split(int M, int Nc, int N, long long HW) {
  const long long tiles =
      (long long)((M + kWT - 1) / kWT) * ((Nc + kWT - 1) / kWT);
  long long S = (kWBlocks + tiles * N - 1) / (tiles * N);
  const long long max_s = (HW + kWK - 1) / kWK;
  if (S > max_s) S = max_s;
  if (S < 1) S = 1;
  long long L = (HW + S - 1) / S;
  L = (L + kWK - 1) / kWK * kWK;
  return {(int)((HW + L - 1) / L), L};
}

size_t wgrad_partial_floats(int M, int Nc, int N, long long HW) {
  return (size_t)N * wgrad_split(M, Nc, N, HW).S * M * Nc;
}

// grid (row tiles * column tiles, S, N): part[n * S + s, i, j] over the
// pixels [s L, min((s + 1) L, HW)) of image n. 16 x 16 threads each own
// 4 x 4 outputs (rows ty + 16 a, columns tx + 16 b).
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ part,
    int M, int Nc, long long HW, long long L) {
  __shared__ float As[kWK][kWT + 1];
  __shared__ float Bs[kWK][kWT + 1];
  const int tiles_c = (Nc + kWT - 1) / kWT;
  const int i0 = (blockIdx.x / tiles_c) * kWT;
  const int j0 = (blockIdx.x % tiles_c) * kWT;
  const int s = blockIdx.y;
  const int n = blockIdx.z;
  const long long p0 = (long long)s * L;
  const long long p1 = p0 + L < HW ? p0 + L : HW;
  const T* An = A + (long long)n * M * HW;
  const T* Bn = B + (long long)n * Nc * HW;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (long long k0 = p0; k0 < p1; k0 += kWK) {
    for (int e = tid; e < kWT * kWK; e += kThreads) {
      const int r = e / kWK, k = e % kWK;
      const long long p = k0 + k;
      const bool okp = p < p1;
      As[k][r] = (okp && i0 + r < M)
                     ? to_f<T>(An[(long long)(i0 + r) * HW + p]) : 0.f;
      Bs[k][r] = (okp && j0 + r < Nc)
                     ? to_f<T>(Bn[(long long)(j0 + r) * HW + p]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[k][ty + 16 * q];
        b[q] = Bs[k][tx + 16 * q];
      }
#pragma unroll
      for (int qa = 0; qa < 4; ++qa)
#pragma unroll
        for (int qb = 0; qb < 4; ++qb)
          acc[qa][qb] = fmaf(a[qa], b[qb], acc[qa][qb]);
    }
    __syncthreads();
  }
  float* out = part + ((long long)n * gridDim.y + s) * M * Nc;
#pragma unroll
  for (int qa = 0; qa < 4; ++qa) {
    const int i = i0 + ty + 16 * qa;
    if (i >= M) continue;
#pragma unroll
    for (int qb = 0; qb < 4; ++qb) {
      const int j = j0 + tx + 16 * qb;
      if (j < Nc) out[(long long)i * Nc + j] = acc[qa][qb];
    }
  }
}

template <typename T>
cudaError_t wgrad(const T* A, const T* B, int M, int Nc, int N, long long HW,
                  float* part, float* out, cudaStream_t s) {
  const Split sp = wgrad_split(M, Nc, N, HW);
  const unsigned tiles =
      (unsigned)(((M + kWT - 1) / kWT) * ((Nc + kWT - 1) / kWT));
  wgrad_kernel<T><<<dim3(tiles, (unsigned)sp.S, (unsigned)N), kThreads, 0,
                    s>>>(A, B, part, M, Nc, HW, sp.L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_rows(part, out, 1, N * sp.S, (long long)M * Nc, s);
}

// ---------------------------------------------------------------------------
// K3 on the FMA route (fp32; bf16 where C or F is no multiple of 16):
// x, g, dout, dz and the operand streams in T, the matrices fp32 (holding
// bf16 values in bf16), every product operand rounded to T.
// grid (ceil(HW / P), N), block kThreads.
// Per-block vector partials, V = 6C + 2F floats:
//   [dgamma C | db5 C | db4 2F | dw2n C | db2n C | dbeta C | db3 C]
// and the SCA grad partials da [N, blocks, C].
// ---------------------------------------------------------------------------

int p1_pixels(int C, int F) {
  for (int P = 32; P >= 8; P /= 2)
    if ((long long)(4 * C + 3 * F) * P * 4 <= kSmemLimit) return P;
  return 0;
}

template <typename T, int KO, int P>
__global__ void __launch_bounds__(kThreads) k3_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const T* __restrict__ dout, const float* __restrict__ att,
    const float* __restrict__ W3, const float* __restrict__ b3,
    const float* __restrict__ w2n, const float* __restrict__ b2n,
    const float* __restrict__ W4, const float* __restrict__ b4,
    const float* __restrict__ W5, const float* __restrict__ b5,
    const float* __restrict__ beta, const float* __restrict__ gamma,
    T* __restrict__ dz_out, T* __restrict__ v_o, T* __restrict__ h2_o,
    T* __restrict__ wv_o, T* __restrict__ ds_o, T* __restrict__ dq_o,
    T* __restrict__ dp_o, float* __restrict__ vpart,
    float* __restrict__ dapart, int C, int F, long long HW, float eps) {
  constexpr int G = kThreads / P;
  extern __shared__ float smem[];
  float* a_s = smem;             // [C]  v, then h2, then dh2
  float* z_s = a_s + C * P;      // [C]  z, then xhat2
  float* p_s = z_s + C * P;      // [C]  pth (conv3 output)
  float* d_s = p_s + C * P;      // [C]  ds, then dp (rounded)
  float* q_s = d_s + C * P;      // [2F] q, then dq (rounded)
  float* w_s = q_s + 2 * F * P;  // [F]  wv (rounded)
  __shared__ float red_s[2 * G * P];

  const int lane = threadIdx.x % P;
  const int grp = threadIdx.x / P;
  const int n = blockIdx.y;
  const int blk = blockIdx.x;
  const long long p = (long long)blk * P + lane;
  const bool valid = p < HW;
  const long long base = (long long)n * C * HW + p;
  const long long baseF = (long long)n * F * HW + p;
  const long long baseQ = (long long)n * 2 * F * HW + p;
  const float* attn = att + (long long)n * C;
  float* vp = vpart + ((long long)n * gridDim.x + blk) * (6 * C + 2 * F);
  float* dap = dapart + ((long long)n * gridDim.x + blk) * C;
  // loop counts shared by every group, so each lane meets every shuffle
  const int it_c = (C + G * KO - 1) / (G * KO);
  const int it_f = (F + G * KO - 1) / (G * KO);
  // row pitches of the matrices: [C, ldc] W3 and W4, [C, ldf] W5
  const int ldc = pitch4(C), ldf = pitch4(F);

  // v = g * att (conv3 and dW3 operand), z = x
  for (int c = grp; c < C; c += G) {
    const float xv = valid ? to_f<T>(x[base + (long long)c * HW]) : 0.f;
    const float gv = valid ? to_f<T>(g[base + (long long)c * HW]) : 0.f;
    const float v = to_cdt<T>(gv * attn[c]);
    a_s[c * P + lane] = v;
    z_s[c * P + lane] = xv;
    if (valid) v_o[base + (long long)c * HW] = from_f<T>(v);
  }
  __syncthreads();

  // conv3: pth = W3 v + b3, z = x + beta * pth
  for (int o0 = grp * KO; o0 < C; o0 += G * KO) {
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO, P>(W3, ldc, C, o0, C, a_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int o = o0 + r;
      if (o < C) {
        const float pth = acc[r] + b3[o];
        p_s[o * P + lane] = pth;
        z_s[o * P + lane] += beta[o] * pth;
      }
    }
  }
  __syncthreads();

  // LN2: xhat2 (kept), h2 (conv4 and dW4 operand)
  float mu, rstd;
  ln_stats<P>(z_s, C, red_s, grp, lane, eps, mu, rstd);
  for (int c = grp; c < C; c += G) {
    const float xh = (z_s[c * P + lane] - mu) * rstd;
    const float h2 = to_cdt<T>(fmaf(xh, w2n[c], b2n[c]));
    z_s[c * P + lane] = xh;
    a_s[c * P + lane] = h2;
    if (valid) h2_o[base + (long long)c * HW] = from_f<T>(h2);
  }
  __syncthreads();

  // conv4 + gate: q1, q2, wv = q1 * q2
  for (int j0 = grp * KO; j0 < F; j0 += G * KO) {
    float qa[KO], qb[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) qa[r] = qb[r] = 0.f;
    rows_dot<KO, P>(W4, ldc, C, j0, F, a_s, lane, qa);
    rows_dot<KO, P>(W4 + (long long)F * ldc, ldc, C, j0, F, a_s, lane, qb);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int j = j0 + r;
      if (j < F) {
        const float q1 = qa[r] + b4[j];
        const float q2 = qb[r] + b4[F + j];
        const float wv = to_cdt<T>(q1 * q2);
        q_s[j * P + lane] = q1;
        q_s[(F + j) * P + lane] = q2;
        w_s[j * P + lane] = wv;
        if (valid) wv_o[baseF + (long long)j * HW] = from_f<T>(wv);
      }
    }
  }
  __syncthreads();

  // conv5 -> s; dgamma = sum dout * s; ds = gamma * dout; db5 = sum ds
  for (int it = 0; it < it_c; ++it) {
    const int o0 = (it * G + grp) * KO;
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    rows_dot<KO, P>(W5, ldf, F, o0, C, w_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int o = o0 + r;
      const bool ok = o < C;
      const float dov =
          (ok && valid) ? to_f<T>(dout[base + (long long)o * HW]) : 0.f;
      const float sv = ok ? acc[r] + b5[o] : 0.f;
      const float ds = ok ? gamma[o] * dov : 0.f;
      const float sum_g = group_sum<P>(dov * sv);
      const float sum_b = group_sum<P>(ds);
      if (ok) {
        const float dsr = to_cdt<T>(ds);
        d_s[o * P + lane] = dsr;
        if (valid) ds_o[base + (long long)o * HW] = from_f<T>(dsr);
        if (lane == 0) {
          vp[o] = sum_g;
          vp[C + o] = sum_b;
        }
      }
    }
  }
  __syncthreads();

  // dwv = W5^T ds; dq = (dwv * q2, dwv * q1); db4 = sum dq
  for (int it = 0; it < it_f; ++it) {
    const int f0 = (it * G + grp) * KO;
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    cols_dot<KO, P>(W5, ldf, C, f0, F, d_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int f = f0 + r;
      const bool ok = f < F;
      const float q1 = ok ? q_s[f * P + lane] : 0.f;
      const float q2 = ok ? q_s[(F + f) * P + lane] : 0.f;
      const float dq1 = acc[r] * q2;
      const float dq2 = acc[r] * q1;
      const float s1 = group_sum<P>(dq1);
      const float s2 = group_sum<P>(dq2);
      if (ok) {
        const float r1 = to_cdt<T>(dq1), r2 = to_cdt<T>(dq2);
        q_s[f * P + lane] = r1;
        q_s[(F + f) * P + lane] = r2;
        if (valid) {
          dq_o[baseQ + (long long)f * HW] = from_f<T>(r1);
          dq_o[baseQ + (long long)(F + f) * HW] = from_f<T>(r2);
        }
        if (lane == 0) {
          vp[2 * C + f] = s1;
          vp[2 * C + F + f] = s2;
        }
      }
    }
  }
  __syncthreads();

  // dh2 = W4^T dq; dw2n = sum dh2 * xhat2; db2n = sum dh2; LN2 backward sums
  float sg = 0.f, sgx = 0.f;
  for (int it = 0; it < it_c; ++it) {
    const int c0 = (it * G + grp) * KO;
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    cols_dot<KO, P>(W4, ldc, 2 * F, c0, C, q_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int c = c0 + r;
      const bool ok = c < C;
      const float dh = acc[r];
      const float xh = ok ? z_s[c * P + lane] : 0.f;
      const float s_w = group_sum<P>(dh * xh);
      const float s_b = group_sum<P>(dh);
      if (ok) {
        a_s[c * P + lane] = dh;
        const float gxh = dh * w2n[c];
        sg += gxh;
        sgx += gxh * xh;
        if (lane == 0) {
          vp[2 * C + 2 * F + c] = s_w;
          vp[3 * C + 2 * F + c] = s_b;
        }
      }
    }
  }
  groups_sum2<P>(sg, sgx, red_s, grp, lane);
  const float mean_g = sg / C, mean_gx = sgx / C;

  // dz = dout + LN2^T(dh2); dbeta = sum dz * pth; dp = beta * dz; db3
  const int it_g = (C + G - 1) / G;
  for (int it = 0; it < it_g; ++it) {
    const int c = it * G + grp;
    const bool ok = c < C;
    float dzv = 0.f, pth = 0.f, dp = 0.f;
    if (ok && valid) {
      const float dov = to_f<T>(dout[base + (long long)c * HW]);
      const float gxh = a_s[c * P + lane] * w2n[c];
      dzv = dov + (gxh - mean_g - z_s[c * P + lane] * mean_gx) * rstd;
      pth = p_s[c * P + lane];
      dp = beta[c] * dzv;
    }
    const float s_beta = group_sum<P>(dzv * pth);
    const float s_b3 = group_sum<P>(dp);
    if (ok) {
      const float dpr = to_cdt<T>(dp);
      d_s[c * P + lane] = dpr;
      if (valid) {
        dz_out[base + (long long)c * HW] = from_f<T>(dzv);
        dp_o[base + (long long)c * HW] = from_f<T>(dpr);
      }
      if (lane == 0) {
        vp[4 * C + 2 * F + c] = s_beta;
        vp[5 * C + 2 * F + c] = s_b3;
      }
    }
  }
  __syncthreads();

  // dv = W3^T dp; da[n, c] = sum_p dv * g
  for (int it = 0; it < it_c; ++it) {
    const int c0 = (it * G + grp) * KO;
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    cols_dot<KO, P>(W3, ldc, C, c0, C, d_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int c = c0 + r;
      const bool ok = c < C;
      const float gv =
          (ok && valid) ? to_f<T>(g[base + (long long)c * HW]) : 0.f;
      const float s_a = group_sum<P>(acc[r] * gv);
      if (ok && lane == 0) dap[c] = s_a;
    }
  }
}

struct P1Work {
  void *v, *h2, *wv, *ds, *dq, *dp;  // per-pixel operands [N, ch, HW], T
  float *vpart, *dapart, *wpart;
};

P1Work carve_p1(Carver& cv, int N, int C, int F, long long HW, int P,
                size_t esize) {
  P1Work w;
  const size_t px = (size_t)N * HW;
  w.v = cv.take<char>(px * C * esize);
  w.h2 = cv.take<char>(px * C * esize);
  w.wv = cv.take<char>(px * F * esize);
  w.ds = cv.take<char>(px * C * esize);
  w.dq = cv.take<char>(px * 2 * F * esize);
  w.dp = cv.take<char>(px * C * esize);
  const size_t blocks = (size_t)N * ((HW + P - 1) / P);
  w.vpart = cv.take<float>(blocks * (6 * C + 2 * F));
  w.dapart = cv.take<float>(blocks * C);
  size_t wp = wgrad_partial_floats(C, F, N, HW);
  const size_t w4 = wgrad_partial_floats(2 * F, C, N, HW);
  const size_t w3 = wgrad_partial_floats(C, C, N, HW);
  if (w4 > wp) wp = w4;
  if (w3 > wp) wp = w3;
  w.wpart = cv.take<float>(wp);
  return w;
}

struct P1Args {
  const void *x, *g, *dout, *att, *W3, *b3, *w2n, *b2n, *W4, *b4, *W5, *b5,
      *beta, *gamma;
  void *dz, *da, *grads, *ws;
  int N, C, F;
  long long HW;
  float eps;
};

template <typename T, int KO, int P>
cudaError_t launch_k3(const P1Args& a, const P1Work& w, cudaStream_t s) {
  const size_t smem = (size_t)(4 * a.C + 3 * a.F) * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k3_kernel<T, KO, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.HW + P - 1) / P);
  k3_kernel<T, KO, P><<<dim3(blocks, (unsigned)a.N), kThreads, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.att),
      static_cast<const float*>(a.W3), static_cast<const float*>(a.b3),
      static_cast<const float*>(a.w2n), static_cast<const float*>(a.b2n),
      static_cast<const float*>(a.W4), static_cast<const float*>(a.b4),
      static_cast<const float*>(a.W5), static_cast<const float*>(a.b5),
      static_cast<const float*>(a.beta), static_cast<const float*>(a.gamma),
      static_cast<T*>(a.dz), static_cast<T*>(w.v), static_cast<T*>(w.h2),
      static_cast<T*>(w.wv), static_cast<T*>(w.ds), static_cast<T*>(w.dq),
      static_cast<T*>(w.dp), w.vpart, w.dapart, a.C, a.F, a.HW, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_p1(const P1Args& a, cudaStream_t s) {
  const int P = p1_pixels(a.C, a.F);
  if (P == 0) return cudaErrorInvalidValue;
  Carver cv{static_cast<char*>(a.ws)};
  const P1Work w = carve_p1(cv, a.N, a.C, a.F, a.HW, P, sizeof(T));
  cudaError_t err;
  if (P == 32)
    err = a.C <= 64 ? launch_k3<T, 8, 32>(a, w, s)
                    : launch_k3<T, 16, 32>(a, w, s);
  else if (P == 16)
    err = launch_k3<T, 16, 16>(a, w, s);
  else
    err = launch_k3<T, 16, 8>(a, w, s);
  if (err != cudaSuccess) return err;

  const int C = a.C, F = a.F, N = a.N;
  const int blocks = (int)((a.HW + P - 1) / P);
  float* grads = static_cast<float*>(a.grads);
  float* dW3 = grads;
  float* dW4 = dW3 + (size_t)C * C;
  float* dW5 = dW4 + (size_t)2 * F * C;
  float* vec = dW5 + (size_t)C * F;
  if ((err = launch_sum_rows(w.vpart, vec, 1, N * blocks, 6 * C + 2 * F, s)))
    return err;
  if ((err = launch_sum_rows(w.dapart, static_cast<float*>(a.da), N, blocks,
                             C, s)))
    return err;
  if ((err = wgrad<T>(static_cast<const T*>(w.ds),
                      static_cast<const T*>(w.wv), C, F, N, a.HW, w.wpart,
                      dW5, s)))
    return err;
  if ((err = wgrad<T>(static_cast<const T*>(w.dq),
                      static_cast<const T*>(w.h2), 2 * F, C, N, a.HW,
                      w.wpart, dW4, s)))
    return err;
  return wgrad<T>(static_cast<const T*>(w.dp), static_cast<const T*>(w.v), C,
                  C, N, a.HW, w.wpart, dW3, s);
}

// ---------------------------------------------------------------------------
// K3 in bf16: k3_mma_kernel + wgrad_mma_kernel (nafblock_p1_mma.cuh).
// a.W3, a.W4, a.W5 are bf16 here. The wrapper chooses the pixel tile P and
// the blocks per image BX (ops/nafblock.py:p1_tile, p1_grid: it fills the
// card from what it knows of the SMs); here they are only checked.
// ---------------------------------------------------------------------------

bool p1_mma_ok(int C, int F, long long HW, int P, int BX) {
  return (P == 8 || P == 16 || P == 32) && C % 16 == 0 && F % 16 == 0 &&
         C > 0 && F > 0 && BX >= 1 && BX <= (HW + P - 1) / P &&
         (long long)k3_mma_smem(C, F, P) <= kSmemLimit;
}

struct P1MmaWork {
  bf16 *v, *h2, *wv, *ds, *dq, *dp;  // operand streams [N, rows, HWp]
  float *vpart, *dapart, *wpart;
  long long HWp, L;  // padded pixels per image; pixels per wgrad chunk
  int tiles, S;      // pixel tiles per image; wgrad chunks per image
};

P1MmaWork carve_p1_mma(Carver& cv, int N, int C, int F, long long HW, int P,
                       int BX) {
  P1MmaWork w;
  w.HWp = (HW + 7) / 8 * 8;
  w.tiles = (int)((HW + P - 1) / P);
  const int wtiles =
      wgrad_tiles(C, C) + wgrad_tiles(2 * F, C) + wgrad_tiles(C, F);
  long long S = (kGBlocks + (long long)wtiles * N - 1) / ((long long)wtiles * N);
  const long long max_s = (w.HWp + kGK - 1) / kGK;
  if (S > max_s) S = max_s;
  w.L = ((w.HWp + S - 1) / S + kGK - 1) / kGK * kGK;
  w.S = (int)((w.HWp + w.L - 1) / w.L);
  const size_t px = (size_t)N * w.HWp;
  w.v = cv.take<bf16>(px * C);
  w.h2 = cv.take<bf16>(px * C);
  w.wv = cv.take<bf16>(px * F);
  w.ds = cv.take<bf16>(px * C);
  w.dq = cv.take<bf16>(px * 2 * F);
  w.dp = cv.take<bf16>(px * C);
  w.vpart = cv.take<float>((size_t)N * BX * (6 * C + 2 * F));
  w.dapart = cv.take<float>((size_t)N * BX * C);
  w.wpart = cv.take<float>((size_t)N * w.S *
                           ((size_t)C * C + (size_t)3 * F * C));
  return w;
}

template <int P, bool RES>
cudaError_t launch_k3_mma_as(const K3Mma& k, int BX, int N, size_t smem,
                             cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      k3_mma_kernel<P, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  k3_mma_kernel<P, RES>
      <<<dim3((unsigned)BX, (unsigned)N), kThreads, smem, s>>>(k);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_k3_mma(const K3Mma& k, int BX, int N, size_t smem,
                          cudaStream_t s) {
  return resident(k.C, k.F) ? launch_k3_mma_as<P, true>(k, BX, N, smem, s)
                            : launch_k3_mma_as<P, false>(k, BX, N, smem, s);
}

// Blocks of k3_mma_kernel that the CUDA runtime places on one SM.
template <int P, bool RES>
int k3_mma_occupancy_as(size_t smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(k3_mma_kernel<P, RES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k3_mma_kernel<P, RES>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int P>
int k3_mma_occupancy(int C, int F) {
  const size_t smem = k3_mma_smem(C, F, P);
  return resident(C, F) ? k3_mma_occupancy_as<P, true>(smem)
                        : k3_mma_occupancy_as<P, false>(smem);
}

cudaError_t run_p1_mma(const P1Args& a, int P, int BX, cudaStream_t s) {
  const int C = a.C, F = a.F, N = a.N;
  if (!p1_mma_ok(C, F, a.HW, P, BX) || !aligned16(a.W3) || !aligned16(a.W4) ||
      !aligned16(a.W5))
    return cudaErrorInvalidValue;
  Carver cv{static_cast<char*>(a.ws)};
  const P1MmaWork w = carve_p1_mma(cv, N, C, F, a.HW, P, BX);

  K3Mma k;
  k.x = static_cast<const bf16*>(a.x);
  k.g = static_cast<const bf16*>(a.g);
  k.dout = static_cast<const bf16*>(a.dout);
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
  k.dz = static_cast<bf16*>(a.dz);
  k.v_o = w.v;
  k.h2_o = w.h2;
  k.wv_o = w.wv;
  k.ds_o = w.ds;
  k.dq_o = w.dq;
  k.dp_o = w.dp;
  k.vpart = w.vpart;
  k.dapart = w.dapart;
  k.C = C;
  k.F = F;
  k.HW = a.HW;
  k.HWp = w.HWp;
  k.tiles = w.tiles;
  k.vec = a.HW % 8 == 0 && aligned16(a.x) && aligned16(a.g) &&
          aligned16(a.dout);
  k.eps = a.eps;
  const size_t smem = k3_mma_smem(C, F, P);
  cudaError_t err = P == 32   ? launch_k3_mma<32>(k, BX, N, smem, s)
                    : P == 16 ? launch_k3_mma<16>(k, BX, N, smem, s)
                              : launch_k3_mma<8>(k, BX, N, smem, s);
  if (err != cudaSuccess) return err;

  float* grads = static_cast<float*>(a.grads);
  const long long V = (long long)C * C + (long long)3 * F * C;
  if ((err = launch_sum_rows(w.vpart, grads + V, 1, N * BX, 6 * C + 2 * F,
                             s)))
    return err;
  if ((err = launch_sum_rows(w.dapart, static_cast<float*>(a.da), N, BX, C,
                             s)))
    return err;

  // dW3 = dp v^T, dW4 = dq h2^T, dW5 = ds wv^T, in the order of grads
  WgradMma g;
  g.prod[0] = {w.dp, w.v, C, C, 0, 0};
  g.prod[1] = {w.dq, w.h2, 2 * F, C, (long long)C * C, wgrad_tiles(C, C)};
  g.prod[2] = {w.ds, w.wv, C, F, (long long)C * C + (long long)2 * F * C,
               wgrad_tiles(C, C) + wgrad_tiles(2 * F, C)};
  g.part = w.wpart;
  g.V = V;
  g.HWp = w.HWp;
  g.L = w.L;
  const unsigned wtiles =
      (unsigned)(g.prod[2].tile0 + wgrad_tiles(C, F));
  wgrad_mma_kernel<<<dim3(wtiles, (unsigned)w.S, (unsigned)N), kThreads, 0,
                     s>>>(g);
  if ((err = cudaGetLastError())) return err;
  return launch_sum_rows(w.wpart, grads, 1, N * w.S, V, s);
}

// ---------------------------------------------------------------------------
// K4a (FMA route, T as K3's): LN1 -> conv1 -> dw3x3 recompute, gate grad,
// depthwise adjoint.
// grid (tiles, ceil(C / kBGate), N), block kThreads (16 x 16 halo tile).
// Per-tile partials of 11 * 2C floats: index k * 2C + j for tap k < 9
// (dkdw[j, k]), k = 9 (dbk[j]) and k = 10 (db1[j]).
// ---------------------------------------------------------------------------

constexpr int kBH = 16;          // halo tile side (threads)
constexpr int kBT = kBH - 4;     // output pixels per tile side
constexpr int kBGate = 16;       // gate channels per block
constexpr int kBWarps = kThreads / 32;
constexpr int kBRed = 11;        // reduced values per channel

constexpr size_t k4a_smem_bytes() {
  return (size_t)(2 * (2 * kBGate * kThreads) + kBWarps * kBRed * 2 * kBGate) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) k4a_kernel(
    const T* __restrict__ x, const T* __restrict__ dz,
    const float* __restrict__ dgc, const float* __restrict__ att,
    const float* __restrict__ w1n, const float* __restrict__ b1n,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ kdw, const float* __restrict__ bk,
    const float* __restrict__ W3, const float* __restrict__ beta,
    T* __restrict__ dt_o, float* __restrict__ part, int C, int H, int W,
    int tiles_x, float eps) {
  constexpr int KO = kBGate;
  extern __shared__ float smem[];
  float* t_s = smem;                        // [2KO][256] t, 0 outside image
  float* du_s = t_s + 2 * KO * kThreads;    // [2KO][256] du, 0 off the ring
  float* red_s = du_s + 2 * KO * kThreads;  // [warps][kBRed][2KO]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int j0 = blockIdx.y * KO;
  const int n = blockIdx.z;
  const int hr = tid / kBH, hc = tid % kBH;
  const int gr = (tile / tiles_x) * kBT - 2 + hr;
  const int gc = (tile % tiles_x) * kBT - 2 + hc;
  const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
  const long long HW = (long long)H * W;
  const long long pix = inside ? (long long)gr * W + gc : 0;
  const T* xn = x + (long long)n * C * HW + pix;
  const T* dzn = dz + (long long)n * C * HW + pix;

  float acc[2 * KO], dv[KO];
#pragma unroll
  for (int r = 0; r < 2 * KO; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < KO; ++r) dv[r] = 0.f;

  if (inside) {
    // LN1 statistics (shifted one pass, as K1)
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
    // conv1 rows j0 + r and C + j0 + r (W1 and W3 rows ldc = pitch4(C)
    // long; channels past C count 0)
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
    // local gate grad dv[j] = sum_c W3[c, j] * round(beta[c] * dz[c])
    for (int c = 0; c < C; ++c) {
      const float pr = to_cdt<T>(beta[c] * to_f<T>(dzn[(long long)c * HW]));
      const float* row = W3 + (long long)c * ldc + j0;
#pragma unroll
      for (int r = 0; r < KO; r += 4) {
        if (j0 + r < C) {
          const float4 w = ldg4(row + r);
          dv[r + 0] = fmaf(w.x, pr, dv[r + 0]);
          dv[r + 1] = fmaf(w.y, pr, dv[r + 1]);
          dv[r + 2] = fmaf(w.z, pr, dv[r + 2]);
          dv[r + 3] = fmaf(w.w, pr, dv[r + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < KO; ++r) {
    const int j = j0 + r;
    const bool ok = inside && j < C;
    t_s[r * kThreads + tid] = ok ? acc[r] + b1[j] : 0.f;
    t_s[(KO + r) * kThreads + tid] = ok ? acc[KO + r] + b1[C + j] : 0.f;
  }
  __syncthreads();

  // u = dw3x3(t) + bk and du = (dg * u2, dg * u1) on the 1-ring
  const bool ring = inside && hr >= 1 && hr <= kBH - 2 && hc >= 1 &&
                    hc <= kBH - 2;
  const long long nc = (long long)n * C;
#pragma unroll 1
  for (int r = 0; r < KO; ++r) {
    const int j = j0 + r;
    float dua = 0.f, dub = 0.f;
    if (ring && j < C) {
      const float* ka = kdw + (long long)j * 9;
      const float* kb = kdw + (long long)(C + j) * 9;
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int q = (hr + kh - 1) * kBH + (hc + kw - 1);
          ua = fmaf(ka[kh * 3 + kw], t_s[r * kThreads + q], ua);
          ub = fmaf(kb[kh * 3 + kw], t_s[(KO + r) * kThreads + q], ub);
        }
      }
      const float dg = dv[r] * att[nc + j] + dgc[nc + j];
      dua = dg * (ub + bk[C + j]);
      dub = dg * (ua + bk[j]);
    }
    du_s[r * kThreads + tid] = dua;
    du_s[(KO + r) * kThreads + tid] = dub;
  }
  __syncthreads();

  // the tile's own pixels: dt (adjoint taps), tap grads, dbk, db1
  const bool own = inside && hr >= 2 && hr < 2 + kBT && hc >= 2 &&
                   hc < 2 + kBT;
  const int warp = tid / 32, lane = tid % 32;
  T* dtn = dt_o + (long long)n * 2 * C * HW + pix;
#pragma unroll 1
  for (int r2 = 0; r2 < 2 * KO; ++r2) {
    const int jl = j0 + (r2 % KO);
    const int jg = r2 < KO ? jl : C + jl;
    const bool ok = own && jl < C;
    const float* kk = kdw + (long long)(jl < C ? jg : 0) * 9;
    const float du = ok ? du_s[r2 * kThreads + tid] : 0.f;
    float dt = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
        const float tv =
            ok ? t_s[r2 * kThreads + (hr + kh - 1) * kBH + (hc + kw - 1)]
               : 0.f;
        const float s = warp_sum(du * tv);
        if (lane == 0) red_s[(warp * kBRed + tap) * 2 * KO + r2] = s;
        if (ok)
          dt = fmaf(kk[tap],
                    du_s[r2 * kThreads + (hr - kh + 1) * kBH + (hc - kw + 1)],
                    dt);
      }
    }
    const float s_bk = warp_sum(du);
    const float s_b1 = warp_sum(dt);
    if (lane == 0) {
      red_s[(warp * kBRed + 9) * 2 * KO + r2] = s_bk;
      red_s[(warp * kBRed + 10) * 2 * KO + r2] = s_b1;
    }
    if (ok) dtn[(long long)jg * HW] = from_f<T>(dt);
  }
  __syncthreads();
  float* pt = part + ((long long)n * gridDim.x + tile) * kBRed * 2 * C;
  for (int e = tid; e < kBRed * 2 * KO; e += kThreads) {
    const int k = e / (2 * KO), r2 = e % (2 * KO);
    const int jl = j0 + (r2 % KO);
    if (jl >= C) continue;
    const int jg = r2 < KO ? jl : C + jl;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBWarps; ++w) s += red_s[(w * kBRed + k) * 2 * KO + r2];
    pt[(long long)k * 2 * C + jg] = s;
  }
}

// ---------------------------------------------------------------------------
// K4b (FMA route): LN1 backward and dx.  grid (ceil(HW / P), N), block
// kThreads.
// Per-block partials [dw1n C | db1n C].
// ---------------------------------------------------------------------------

int p2_pixels(int C) {
  for (int P = 32; P >= 8; P /= 2)
    if ((long long)4 * C * P * 4 <= kSmemLimit) return P;
  return 0;
}

template <typename T, int KO, int P>
__global__ void __launch_bounds__(kThreads) k4b_kernel(
    const T* __restrict__ x, const T* __restrict__ dz,
    const T* __restrict__ dt, const float* __restrict__ w1n,
    const float* __restrict__ b1n, const float* __restrict__ W1,
    T* __restrict__ dx_out, T* __restrict__ h_o, float* __restrict__ vpart,
    int C, long long HW, float eps) {
  constexpr int G = kThreads / P;
  extern __shared__ float smem[];
  float* t_s = smem;            // [2C] dt (compute type)
  float* x_s = t_s + 2 * C * P; // [C]  x, then xhat
  float* h_s = x_s + C * P;     // [C]  dh
  __shared__ float red_s[2 * G * P];

  const int lane = threadIdx.x % P;
  const int grp = threadIdx.x / P;
  const int n = blockIdx.y;
  const int blk = blockIdx.x;
  const long long p = (long long)blk * P + lane;
  const bool valid = p < HW;
  const long long base = (long long)n * C * HW + p;
  const long long base2 = (long long)n * 2 * C * HW + p;
  float* vp = vpart + ((long long)n * gridDim.x + blk) * 2 * C;
  const int it_c = (C + G * KO - 1) / (G * KO);

  for (int c = grp; c < C; c += G)
    x_s[c * P + lane] = valid ? to_f<T>(x[base + (long long)c * HW]) : 0.f;
  for (int j = grp; j < 2 * C; j += G)
    t_s[j * P + lane] = valid ? to_f<T>(dt[base2 + (long long)j * HW]) : 0.f;
  __syncthreads();

  float mu, rstd;
  ln_stats<P>(x_s, C, red_s, grp, lane, eps, mu, rstd);
  for (int c = grp; c < C; c += G) {
    const float xh = (x_s[c * P + lane] - mu) * rstd;
    x_s[c * P + lane] = xh;
    if (valid)
      h_o[base + (long long)c * HW] = from_f<T>(fmaf(xh, w1n[c], b1n[c]));
  }
  __syncthreads();

  // dh = W1^T dt; dw1n = sum dh * xhat; db1n = sum dh; LN1 backward sums
  float sg = 0.f, sgx = 0.f;
  for (int it = 0; it < it_c; ++it) {
    const int c0 = (it * G + grp) * KO;
    float acc[KO];
#pragma unroll
    for (int r = 0; r < KO; ++r) acc[r] = 0.f;
    cols_dot<KO, P>(W1, pitch4(C), 2 * C, c0, C, t_s, lane, acc);
#pragma unroll
    for (int r = 0; r < KO; ++r) {
      const int c = c0 + r;
      const bool ok = c < C;
      const float dh = acc[r];
      const float xh = ok ? x_s[c * P + lane] : 0.f;
      const float s_w = group_sum<P>(dh * xh);
      const float s_b = group_sum<P>(dh);
      if (ok) {
        h_s[c * P + lane] = dh;
        const float gxh = dh * w1n[c];
        sg += gxh;
        sgx += gxh * xh;
        if (lane == 0) {
          vp[c] = s_w;
          vp[C + c] = s_b;
        }
      }
    }
  }
  groups_sum2<P>(sg, sgx, red_s, grp, lane);
  const float mean_g = sg / C, mean_gx = sgx / C;
  if (valid) {
    for (int c = grp; c < C; c += G) {
      const float gxh = h_s[c * P + lane] * w1n[c];
      const float dx = (gxh - mean_g - x_s[c * P + lane] * mean_gx) * rstd +
                       to_f<T>(dz[base + (long long)c * HW]);
      dx_out[base + (long long)c * HW] = from_f<T>(dx);
    }
  }
}

struct P2Work {
  void *dt, *h;  // [N, 2C, HW] and [N, C, HW], T
  float *part_a, *part_b, *wpart;
};

int p2_tiles(int H, int W) {
  return ((H + kBT - 1) / kBT) * ((W + kBT - 1) / kBT);
}

P2Work carve_p2(Carver& cv, int N, int C, int H, int W, int P, size_t esize) {
  P2Work w;
  const long long HW = (long long)H * W;
  const size_t px = (size_t)N * HW;
  w.dt = cv.take<char>(px * 2 * C * esize);
  w.h = cv.take<char>(px * C * esize);
  w.part_a = cv.take<float>((size_t)N * p2_tiles(H, W) * kBRed * 2 * C);
  w.part_b = cv.take<float>((size_t)N * ((HW + P - 1) / P) * 2 * C);
  w.wpart = cv.take<float>(wgrad_partial_floats(2 * C, C, N, HW));
  return w;
}

struct P2Args {
  const void *x, *dz, *dgc, *att, *w1n, *b1n, *W1, *b1, *kdw, *bk, *W3,
      *beta;
  void *dx, *grads, *ws;
  int N, C, H, W;
  float eps;
};

template <typename T, int KO, int P>
cudaError_t launch_k4b(const P2Args& a, const P2Work& w, cudaStream_t s) {
  const size_t smem = (size_t)4 * a.C * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k4b_kernel<T, KO, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long HW = (long long)a.H * a.W;
  const unsigned blocks = (unsigned)((HW + P - 1) / P);
  k4b_kernel<T, KO, P><<<dim3(blocks, (unsigned)a.N), kThreads, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dz),
      static_cast<const T*>(w.dt), static_cast<const float*>(a.w1n),
      static_cast<const float*>(a.b1n), static_cast<const float*>(a.W1),
      static_cast<T*>(a.dx), static_cast<T*>(w.h), w.part_b, a.C, HW, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_p2(const P2Args& a, cudaStream_t s) {
  const int P = p2_pixels(a.C);
  if (P == 0) return cudaErrorInvalidValue;
  Carver cv{static_cast<char*>(a.ws)};
  const P2Work w = carve_p2(cv, a.N, a.C, a.H, a.W, P, sizeof(T));
  const int C = a.C, N = a.N;
  const long long HW = (long long)a.H * a.W;
  float* grads = static_cast<float*>(a.grads);
  float* dW1 = grads;
  float* vec_a = dW1 + (size_t)2 * C * C;   // [11][2C]
  float* vec_b = vec_a + (size_t)kBRed * 2 * C;  // [dw1n C | db1n C]

  const size_t smem_a = k4a_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      k4a_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return err;
  const int tiles_x = (a.W + kBT - 1) / kBT;
  const int tiles = p2_tiles(a.H, a.W);
  const dim3 grid_a((unsigned)tiles, (unsigned)((C + kBGate - 1) / kBGate),
                    (unsigned)N);
  k4a_kernel<T><<<grid_a, kThreads, smem_a, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dz),
      static_cast<const float*>(a.dgc), static_cast<const float*>(a.att),
      static_cast<const float*>(a.w1n), static_cast<const float*>(a.b1n),
      static_cast<const float*>(a.W1), static_cast<const float*>(a.b1),
      static_cast<const float*>(a.kdw), static_cast<const float*>(a.bk),
      static_cast<const float*>(a.W3), static_cast<const float*>(a.beta),
      static_cast<T*>(w.dt), w.part_a, C, a.H, a.W, tiles_x, a.eps);
  if ((err = cudaGetLastError())) return err;
  if ((err = launch_sum_rows(w.part_a, vec_a, 1, N * tiles,
                             (long long)kBRed * 2 * C, s)))
    return err;

  if (P == 32)
    err = C <= 64 ? launch_k4b<T, 8, 32>(a, w, s)
                  : launch_k4b<T, 16, 32>(a, w, s);
  else if (P == 16)
    err = launch_k4b<T, 16, 16>(a, w, s);
  else
    err = launch_k4b<T, 16, 8>(a, w, s);
  if (err != cudaSuccess) return err;
  const int blocks_b = (int)((HW + P - 1) / P);
  if ((err = launch_sum_rows(w.part_b, vec_b, 1, N * blocks_b, 2 * C, s)))
    return err;
  return wgrad<T>(static_cast<const T*>(w.dt), static_cast<const T*>(w.h),
                  2 * C, C, N, HW, w.wpart, dW1, s);
}

// ---------------------------------------------------------------------------
// K4 in bf16: k4_front_kernel -> k4_dw_kernel -> k4_back_kernel ->
// wgrad_mma_kernel (nafblock_p2_mma.cuh), each followed by sum_rows where
// it leaves partial rows. a.W1, a.W3 are bf16 here. The wrapper chooses the
// pixel tile P, the blocks per image BX of the pixel-tile kernels and DX of
// the depthwise kernel (ops/nafblock.py:p2_tile, p2_grid, p2_dw_grid);
// here they are only checked.
// ---------------------------------------------------------------------------

bool p2_mma_ok(int C, int H, int W, int P, int BX, int DX) {
  const long long HW = (long long)H * W;
  return (P == 8 || P == 16 || P == 32) && C % 16 == 0 && C > 0 &&
         BX >= 1 && BX <= (HW + P - 1) / P && DX >= 1 &&
         DX <= dw_tiles(H, W) &&
         (long long)k4_front_smem(C, P) <= kSmemLimit &&
         (long long)k4_back_smem(C, P) <= kSmemLimit;
}

struct P2MmaWork {
  bf16 *h, *dt;           // operand streams [N, rows, HWp]
  float *t, *dg;          // [N, 2C, HWp], [N, C, HWp]
  float *mu, *rstd;       // [N, HW]
  float *dwpart, *bpart, *wpart;
  long long HWp, L;  // padded pixels per image; pixels per wgrad chunk
  int tiles, S;      // pixel tiles per image; wgrad chunks per image
};

P2MmaWork carve_p2_mma(Carver& cv, int N, int C, int H, int W, int P, int BX,
                       int DX) {
  P2MmaWork w;
  const long long HW = (long long)H * W;
  w.HWp = (HW + 7) / 8 * 8;
  w.tiles = (int)((HW + P - 1) / P);
  const long long wtiles = wgrad_tiles(2 * C, C);
  long long S = (kGBlocks + wtiles * N - 1) / (wtiles * N);
  const long long max_s = (w.HWp + kGK - 1) / kGK;
  if (S > max_s) S = max_s;
  w.L = ((w.HWp + S - 1) / S + kGK - 1) / kGK * kGK;
  w.S = (int)((w.HWp + w.L - 1) / w.L);
  const size_t px = (size_t)N * w.HWp;
  w.h = cv.take<bf16>(px * C);
  w.dt = cv.take<bf16>(px * 2 * C);
  w.t = cv.take<float>(px * 2 * C);
  w.dg = cv.take<float>(px * C);
  w.mu = cv.take<float>((size_t)N * HW);
  w.rstd = cv.take<float>((size_t)N * HW);
  w.dwpart = cv.take<float>((size_t)N * DX * kDwRed * C);
  w.bpart = cv.take<float>((size_t)N * BX * 2 * C);
  w.wpart = cv.take<float>((size_t)N * w.S * 2 * C * C);
  return w;
}

// The front and back kernels of a tile: P and resident weights as template
// arguments, chosen from the run-time values.
struct K4Kernels {
  const void *front, *back;
};

template <int P>
K4Kernels k4_kernels_p(int C) {
  if (p2_resident(C))
    return {(const void*)k4_front_kernel<P, true>,
            (const void*)k4_back_kernel<P, true>};
  return {(const void*)k4_front_kernel<P, false>,
          (const void*)k4_back_kernel<P, false>};
}

K4Kernels k4_kernels(int C, int P) {
  return P == 32 ? k4_kernels_p<32>(C)
                 : P == 16 ? k4_kernels_p<16>(C) : k4_kernels_p<8>(C);
}

cudaError_t run_p2_mma(const P2Args& a, int P, int BX, int DX,
                       cudaStream_t s) {
  const int C = a.C, N = a.N;
  if (!p2_mma_ok(C, a.H, a.W, P, BX, DX) || !aligned16(a.W1) ||
      !aligned16(a.W3))
    return cudaErrorInvalidValue;
  Carver cv{static_cast<char*>(a.ws)};
  const P2MmaWork w = carve_p2_mma(cv, N, C, a.H, a.W, P, BX, DX);

  K4Mma k;
  k.x = static_cast<const bf16*>(a.x);
  k.dz = static_cast<const bf16*>(a.dz);
  k.dgc = static_cast<const float*>(a.dgc);
  k.att = static_cast<const float*>(a.att);
  k.w1n = static_cast<const float*>(a.w1n);
  k.b1n = static_cast<const float*>(a.b1n);
  k.b1 = static_cast<const float*>(a.b1);
  k.kdw = static_cast<const float*>(a.kdw);
  k.bk = static_cast<const float*>(a.bk);
  k.beta = static_cast<const float*>(a.beta);
  k.W1 = static_cast<const bf16*>(a.W1);
  k.W3 = static_cast<const bf16*>(a.W3);
  k.dx = static_cast<bf16*>(a.dx);
  k.h_o = w.h;
  k.dt_o = w.dt;
  k.t_o = w.t;
  k.dg_o = w.dg;
  k.mu_o = w.mu;
  k.rstd_o = w.rstd;
  k.dwpart = w.dwpart;
  k.bpart = w.bpart;
  k.C = C;
  k.H = a.H;
  k.W = a.W;
  k.HW = (long long)a.H * a.W;
  k.HWp = w.HWp;
  k.tiles = w.tiles;
  k.vec = k.HW % 8 == 0 && aligned16(a.x) && aligned16(a.dz);
  k.eps = a.eps;

  float* grads = static_cast<float*>(a.grads);
  float* vec_d = grads + (size_t)2 * C * C;       // [11][2C]
  float* vec_b = vec_d + (size_t)kBRed * 2 * C;   // [dw1n C | db1n C]
  const K4Kernels ker = k4_kernels(C, P);
  const dim3 grid((unsigned)BX, (unsigned)N);
  cudaError_t err;
  if ((err = launch_kernel(ker.front, grid, k4_front_smem(C, P), k, s)))
    return err;
  if ((err = launch_kernel((const void*)k4_dw_kernel,
                           dim3((unsigned)C, (unsigned)DX, (unsigned)N), 0,
                           k, s)))
    return err;
  if ((err = launch_sum_rows(w.dwpart, vec_d, 1, N * DX,
                             (long long)kDwRed * C, s)))
    return err;
  if ((err = launch_kernel(ker.back, grid, k4_back_smem(C, P), k, s)))
    return err;
  if ((err = launch_sum_rows_split(w.bpart, vec_b, 1, N * BX, 2 * C, s)))
    return err;

  // dW1 = dt h^T: the one product of wgrad_mma_kernel (the other two
  // products start past the last block)
  WgradMma g;
  const int wtiles = wgrad_tiles(2 * C, C);
  g.prod[0] = {w.dt, w.h, 2 * C, C, 0, 0};
  g.prod[1] = g.prod[2] = {w.dt, w.h, 2 * C, C, 0, wtiles};
  g.part = w.wpart;
  g.V = (long long)2 * C * C;
  g.HWp = w.HWp;
  g.L = w.L;
  wgrad_mma_kernel<<<dim3((unsigned)wtiles, (unsigned)w.S, (unsigned)N),
                     kThreads, 0, s>>>(g);
  if ((err = cudaGetLastError())) return err;
  return launch_sum_rows(w.wpart, grads, 1, N * w.S, g.V, s);
}

}  // namespace

extern "C" {

// Pixels per block of K3's FMA kernel (0: the shape does not fit in shared
// memory).
int nafblk_p1_pixels(int C, int F) { return p1_pixels(C, F); }

// Dynamic shared memory (bytes) of the bf16 K3 with a tile of P pixels,
// and the most a block may have.
long long nafblk_p1_mma_smem(int C, int F, int P) {
  return (long long)k3_mma_smem(C, F, P);
}
long long nafblk_smem_limit() { return kSmemLimit; }

// Blocks of the bf16 K3 with a tile of P pixels that share one SM of the
// current device, as the CUDA runtime counts them from the built kernel's
// registers and shared memory (-1: the tile is not taken or a call failed).
int nafblk_p1_mma_blocks_per_sm(int C, int F, int P) {
  if (!p1_mma_ok(C, F, P, P, 1)) return -1;
  return P == 32   ? k3_mma_occupancy<32>(C, F)
         : P == 16 ? k3_mma_occupancy<16>(C, F)
                   : k3_mma_occupancy<8>(C, F);
}

// Workspace bytes nafblk_p1 needs (-1: the shape or route is not taken).
// tile, grid: pixels per block (8, 16 or 32) and blocks per image of the
// tensor-core route (bf16 only); tile = 0 chooses the FMA route.
long long nafblk_p1_workspace(int N, int C, int F, long long HW, int is_bf16,
                              int tile, int grid) {
  Carver cv{nullptr};
  if (tile > 0) {
    if (!is_bf16 || !p1_mma_ok(C, F, HW, tile, grid)) return -1;
    carve_p1_mma(cv, N, C, F, HW, tile, grid);
  } else {
    const int P = p1_pixels(C, F);
    if (P == 0) return -1;
    carve_p1(cv, N, C, F, HW, P, is_bf16 ? sizeof(bf16) : sizeof(float));
  }
  return (long long)cv.off;
}

// K3. x, g, dout, dz: [N, C, HW] (fp32, or bf16 when is_bf16); att, da:
// [N, C] fp32; the vectors fp32; grads: fp32 [dW3 C*C | dW4 2F*C |
// dW5 C*F | dgamma C | db5 C | db4 2F | dw2n C | db2n C | dbeta C | db3 C];
// ws: workspace. tile = 0: the FMA route (W3, W4, W5 fp32, holding bf16
// values when is_bf16, rows zero-padded to pitch4: W3 [C, pitch4(C)], W4
// [2F, pitch4(C)], W5 [C, pitch4(F)]; any C, F with nafblk_p1_pixels > 0);
// tile > 0: the tensor-core route (bf16 with W3, W4, W5 bf16, C % 16 == 0,
// F % 16 == 0, a tile that fits and 1 <= grid <= the image's tiles).
int nafblk_p1(const void* x, const void* g, const void* dout, const void* att,
              const void* W3, const void* b3, const void* w2n, const void* b2n,
              const void* W4, const void* b4, const void* W5, const void* b5,
              const void* beta, const void* gamma, void* dz, void* da,
              void* grads, void* ws, int N, int C, int F, long long HW,
              float eps, int is_bf16, int tile, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P1Args a{x, g, dout, att, W3, b3, w2n, b2n, W4, b4, W5, b5, beta,
                 gamma, dz, da, grads, ws, N, C, F, HW, eps};
  if (tile > 0)
    return is_bf16 ? (int)run_p1_mma(a, tile, grid, s)
                   : (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)run_p1<bf16>(a, s);
  return (int)run_p1<float>(a, s);
}

// Dynamic shared memory (bytes) of the bf16 K4's two pixel-tile kernels
// with a tile of P pixels: the larger of the two.
long long nafblk_p2_mma_smem(int C, int P) {
  const size_t f = k4_front_smem(C, P), b = k4_back_smem(C, P);
  return (long long)(f > b ? f : b);
}

// Blocks of the bf16 K4's pixel-tile kernels with a tile of P pixels that
// share one SM of the current device, as the CUDA runtime counts them from
// the built kernels: the fewer of the two (-1: the tile is not taken or a
// call failed).
int nafblk_p2_mma_blocks_per_sm(int C, int P) {
  if (!p2_mma_ok(C, 1, P, P, 1, 1)) return -1;
  const K4Kernels ker = k4_kernels(C, P);
  const int f = occupancy(ker.front, k4_front_smem(C, P));
  const int b = occupancy(ker.back, k4_back_smem(C, P));
  return f < b ? f : b;
}

// Blocks of the bf16 K4's depthwise kernel that share one SM.
int nafblk_p2_dw_blocks_per_sm() {
  return occupancy((const void*)k4_dw_kernel, 0);
}

// Pixels per block of K4's FMA back kernel k4b_kernel (0: the shape does
// not fit in shared memory).
int nafblk_p2_pixels(int C) { return p2_pixels(C); }

// Workspace bytes nafblk_p2 needs (-1: the shape or route is not taken).
// tile, grid, dw_grid: the tensor-core route's pixels per tile (8, 16 or
// 32), blocks per image of the pixel-tile kernels and of the depthwise
// kernel (bf16 only); tile = 0 chooses the FMA route.
long long nafblk_p2_workspace(int N, int C, int H, int W, int is_bf16,
                              int tile, int grid, int dw_grid) {
  Carver cv{nullptr};
  if (tile > 0) {
    if (!is_bf16 || !p2_mma_ok(C, H, W, tile, grid, dw_grid)) return -1;
    carve_p2_mma(cv, N, C, H, W, tile, grid, dw_grid);
  } else {
    const int P = p2_pixels(C);
    if (P == 0) return -1;
    carve_p2(cv, N, C, H, W, P, is_bf16 ? sizeof(bf16) : sizeof(float));
  }
  return (long long)cv.off;
}

// K4. x, dz, dx: [N, C, H*W] (fp32, or bf16 when is_bf16); dgc, att:
// [N, C] fp32; the vectors fp32; grads: fp32 [dW1 2C*C | 11 x 2C: dkdw^T
// (9 rows), dbk, db1 | dw1n C | db1n C]; ws: workspace. tile = 0: the FMA
// route (W1, W3 fp32, holding bf16 values when is_bf16, rows zero-padded to
// pitch4(C); any C);
// tile > 0: the tensor-core route (bf16 with W1, W3 bf16, C % 16 == 0 and
// the geometry nafblk_p2_workspace takes).
int nafblk_p2(const void* x, const void* dz, const void* dgc, const void* att,
              const void* w1n, const void* b1n, const void* W1, const void* b1,
              const void* kdw, const void* bk, const void* W3,
              const void* beta, void* dx, void* grads, void* ws, int N, int C,
              int H, int W, float eps, int is_bf16, int tile, int grid,
              int dw_grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P2Args a{x, dz, dgc, att, w1n, b1n, W1, b1, kdw, bk, W3, beta,
                 dx, grads, ws, N, C, H, W, eps};
  if (tile > 0)
    return is_bf16 ? (int)run_p2_mma(a, tile, grid, dw_grid, s)
                   : (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)run_p2<bf16>(a, s);
  return (int)run_p2<float>(a, s);
}

}  // extern "C"
