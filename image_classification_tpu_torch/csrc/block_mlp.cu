// ConvNeXt block tail: y = res + g * (GELU(LN(x) @ W1^T + b1) @ W2^T + b2),
// forward (for inference, and for training with the residuals the backward
// needs) and, in f32 only, backward. The bf16 backward is in
// block_mlp_bwd.cu.
//
// Replaces: image_classification_tpu/ops/block_mlp.py:_run_fwd (body
// _fwd_kernel, the fused forward Pallas kernel, which under grad also stores
// a = fc1 output before GELU and u = fc2 output, both in the working dtype)
// and, for f32 tensors, _block_mlp_bwd (body _bwd_kernel, the fused
// backward).
//
// What bounds the bf16 forward on the H100: two matrix products of
// 2 * M * C * 4C FLOP, 16 * M * C^2 in all, against 6 * M * C + 16 * C^2
// bytes of bf16 inputs and outputs (x, res, y, the weights), 10 * M * C more
// for training (a, u). By those the tensor cores set the pace at every C.
// The TPU kernel keeps a (TM, 4C) tile of h in 100 MB of VMEM; 227 KB of
// shared memory cannot, so here h makes a round trip through device memory,
// and this design moves 26 * M * C bytes (36 * M * C training): at C = 128
// those, not the products, set its floor.
//
// What the design does about it. Three launches on one stream:
//   (a) ln_fwd rows (packed_rows.cuh, the row layout of the backward's
//       prep): f32 mean and E[x^2] - mean^2 variance (the TPU kernel's
//       _norm_stats), xhat = z * s + t rounded to bf16, 16-byte loads and
//       stores;
//   (b) fc1 = xhat @ W1^T on the GEMM core of wgmma_gemm.cuh (TMA, wgmma,
//       both operands K-major: W1 stays in nn.Linear's (out, in) layout);
//       epilogue from the staged f32 tile: v = acc + b1, h = GELU_erf(v)
//       rounded, and for training a = v rounded. fc2 does not apply GELU to
//       a as it loads it, because h is GELU of the unrounded a, and GELU of
//       the rounded a differs from it by an ulp of bf16 in places: storing h
//       from the fc1 epilogue keeps the output equal to the Pallas kernel's;
//   (c) fc2 = h @ W2^T on the same core; epilogue: u = acc + b2 in f32,
//       y = res + g * u rounded, and for training u rounded (y itself uses
//       u unrounded). A thread loads its rows of res before it reads the
//       tile, so they are in flight together.
// Every epilogue stores 8 columns a thread with 16-byte stores. K <= 2048
// and one 128 x 128 tile a block leave enough blocks without split-K.
//
// The f32 path (forward and backward) is a plain FMA tiling that reads each
// operand K-major or row-major, with scalar epilogues, kept for exact checks
// against the f32 plain version:
//   f32 backward (the order of _bwd_kernel)
//   (d) bwd_prep rows: xhat recomputed from x and stored (dW1's operand);
//       du = dy * g stored; column partials of du (db2) and of dy * u_saved
//       (dg);
//   (e) dh = du @ W2, epilogue: da = dh * gelu'(a_saved) stored, and its
//       column partials (db1);
//   (f) dxhat = da @ W1, stored in f32;
//   (g) ln_bwd rows: dz = dxhat * s, dx = r * (dz - mean(dz) - z * mean(dz z))
//       with the statistics recomputed from x; f32 column partials of
//       dxhat * z (ds) and dxhat (dt);
//   (h) dW1 = da^T @ xhat and dW2 = du^T @ GELU(a_saved), the GEMM with K = M
//       split over M into partials (the GELU of a is applied as the tile is
//       loaded, so h is never stored);
//   (i) every partial summed by a second pass in a fixed order.
// Blocks run in no order on Hopper, so the TPU's grid-carried f32 sums
// become per-block partials plus that pass: no float atomics, so two runs
// give the same bits. Rows past M load as zeros and add nothing to any sum.
#include <stdint.h>

#include "common.cuh"
#include "packed_rows.cuh"
#include "wgmma_gemm.cuh"

namespace {

enum Epilogue : int {
  EPI_BIAS_GELU = 0,            // out = gelu(acc + bias); aux = acc + bias
  EPI_BIAS_SCALE_RESIDUAL = 1,  // out = res + gamma*(acc + bias); aux = acc + bias
  EPI_DGELU = 2,                // out = acc * gelu'(res); f32 column partials (f32 only)
  EPI_F32 = 3,                  // out (f32) = acc, in split blockIdx.z's slab (f32 only)
};

// What an epilogue reads and writes; which members it uses depends on EPI.
struct Epi {
  const void* bias;   // (N,)
  const void* res;    // (M, N): the residual, or the saved pre-GELU a
  const void* gamma;  // (N,)
  void* out;          // (M, N); (splits, M, N) for EPI_F32
  void* aux;          // (M, N) or null: the pre-activation training saves
  float* colsum;      // (gridDim.y, N): column partials of EPI_DGELU
};

// Finishes output element (m, n) from its f32 product; returns the f32 value
// whose columns EPI_DGELU sums.
template <int EPI>
__device__ __forceinline__ float store_epilogue(float acc, int64_t m, int n,
                                                int64_t M, int N,
                                                const Epi& e) {
  const int64_t idx = m * N + n;
  if constexpr (EPI == EPI_F32) {
    static_cast<float*>(e.out)[(int64_t)blockIdx.z * M * N + idx] = acc;
    return acc;
  } else if constexpr (EPI == EPI_DGELU) {
    const float a = static_cast<const float*>(e.res)[idx];
    const float v = acc * ic_gelu_grad_as(a);
    static_cast<float*>(e.out)[idx] = v;
    return v;
  } else {
    const float v = acc + static_cast<const float*>(e.bias)[n];
    if (e.aux != nullptr) static_cast<float*>(e.aux)[idx] = v;
    float* out = static_cast<float*>(e.out);
    if constexpr (EPI == EPI_BIAS_GELU) {
      out[idx] = ic_gelu_erf_as(v);
    } else {
      const float r = static_cast<const float*>(e.res)[idx];
      const float g = static_cast<const float*>(e.gamma)[n];
      out[idx] = r + g * v;
    }
    return v;
  }
}

// ------------------------------------------------------------- row kernels
constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int ROWS_PER_BLOCK = 64;   // backward row kernels: rows a block sums
constexpr int MAX_Q = MAX_C / 32;    // columns a lane holds

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads a row of x into xv (the lane's columns lane + 32 q), replaces it by
// z = (x - mean) * r and returns r = rsqrt(var + eps): f32 mean and
// E[x^2] - mean^2 variance (the TPU kernel's _norm_stats).
__device__ __forceinline__ float lane_row_z(const float* __restrict__ xr, int C,
                                            float eps, float (&xv)[MAX_Q]) {
  const int lane = threadIdx.x % 32;
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    const int c = lane + 32 * q;
    xv[q] = c < C ? xr[c] : 0.0f;
    sum += xv[q];
    sq += xv[q] * xv[q];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float r = rsqrtf(fmaxf(sq / C - mu * mu, 0.0f) + eps);
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) xv[q] = (xv[q] - mu) * r;
  return r;
}

// The f32 forward's LayerNorm: one warp a row, xhat = z * s + t.
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ t, float* __restrict__ out, int64_t M,
               int C, float eps) {
  const int64_t row = (int64_t)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;   // whole warps: row is the same on every lane
  float z[MAX_Q];
  lane_row_z(x + row * C, C, eps, z);
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    const int c = lane + 32 * q;
    if (c < C) out[row * C + c] = z[q] * s[c] + t[c];
  }
}

// Sums two per-lane column accumulators over the block's warps, in warp
// order, into row blockIdx.x of the (gridDim.x, C) partials p0 and p1.
__device__ __forceinline__ void block_column_partials(
    float (&red)[2][LN_WARPS][MAX_C], const float (&a0)[MAX_Q],
    const float (&a1)[MAX_Q], int C, float* __restrict__ p0,
    float* __restrict__ p1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    const int c = lane + 32 * q;
    if (c < C) {
      red[0][warp][c] = a0[q];
      red[1][warp][c] = a1[q];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int w = 0; w < LN_WARPS; ++w) {
      s0 += red[0][w][c];
      s1 += red[1][w][c];
    }
    p0[(int64_t)blockIdx.x * C + c] = s0;
    p1[(int64_t)blockIdx.x * C + c] = s1;
  }
}

// (d): xhat = z s + t, du = dy g; partials of du (db2), dy u (dg).
__global__ void __launch_bounds__(LN_THREADS)
bwd_prep_kernel(const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ dy, const float* __restrict__ s,
                const float* __restrict__ t, const float* __restrict__ g,
                float* __restrict__ xhat, float* __restrict__ du,
                float* __restrict__ part_db2, float* __restrict__ part_dg,
                int64_t M, int C, float eps) {
  __shared__ float red[2][LN_WARPS][MAX_C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a_db2[MAX_Q], a_dg[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) a_db2[q] = a_dg[q] = 0.0f;
  for (int rr = warp; rr < ROWS_PER_BLOCK; rr += LN_WARPS) {
    const int64_t m = (int64_t)blockIdx.x * ROWS_PER_BLOCK + rr;
    if (m >= M) break;
    float z[MAX_Q];
    lane_row_z(x + m * C, C, eps, z);
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      const int c = lane + 32 * q;
      if (c < C) {
        const int64_t i = m * C + c;
        xhat[i] = z[q] * s[c] + t[c];
        const float dyv = dy[i];
        const float duv = dyv * g[c];
        du[i] = duv;
        a_db2[q] += duv;
        a_dg[q] += dyv * u[i];
      }
    }
  }
  block_column_partials(red, a_db2, a_dg, C, part_db2, part_dg);
}

// (g): the LayerNorm backward; partials of dxhat z (ds) and dxhat (dt).
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dxhat,
              const float* __restrict__ s, float* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_dt,
              int64_t M, int C, float eps) {
  __shared__ float red[2][LN_WARPS][MAX_C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a_ds[MAX_Q], a_dt[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) a_ds[q] = a_dt[q] = 0.0f;
  for (int rr = warp; rr < ROWS_PER_BLOCK; rr += LN_WARPS) {
    const int64_t m = (int64_t)blockIdx.x * ROWS_PER_BLOCK + rr;
    if (m >= M) break;
    float z[MAX_Q], dz[MAX_Q];
    const float r = lane_row_z(x + m * C, C, eps, z);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      const int c = lane + 32 * q;
      float dxh = 0.0f;
      if (c < C) {
        dxh = dxhat[m * C + c];
        dz[q] = dxh * s[c];
      } else {
        dz[q] = 0.0f;
      }
      s1 += dz[q];
      s2 += dz[q] * z[q];
      a_ds[q] += dxh * z[q];
      a_dt[q] += dxh;
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      const int c = lane + 32 * q;
      if (c < C) dx[m * C + c] = r * (dz[q] - m1 - z[q] * m2);
    }
  }
  block_column_partials(red, a_ds, a_dt, C, part_ds, part_dt);
}

// (i): out[n] = sum over r, in order, of part[r][n].
__global__ void sum_rows_kernel(const float* __restrict__ part, int R,
                                int64_t N, float* __restrict__ out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) s += part[(int64_t)r * N + n];
  out[n] = s;
}

// ------------------------------------------------------ the bf16 forward
// (a): xhat = bf(z s + t) in the packed row layout of packed_rows.cuh; a
// group walks its rows U at a time, their loads in flight together. No sums
// cross rows, so the grid is as large as the rows need, up to LN_GRID.
constexpr int LN_GRID = 2048;

template <int Q, int U>
__global__ void __launch_bounds__(ROW_THREADS)
ln_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ s,
              const bf16* __restrict__ t, bf16* __restrict__ xhat, int64_t M,
              int C, float eps, int lanes) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gpw = 32 / lanes, li = lane % lanes;
  uint4 sp[Q], tp[Q];
  load_packed<Q>(s, 0, true, C, lanes, li, sp);
  load_packed<Q>(t, 0, true, C, lanes, li, tp);
  const int64_t stride = (int64_t)gridDim.x * ROW_WARPS * gpw;
  for (int64_t base = ((int64_t)blockIdx.x * ROW_WARPS + warp) * gpw + lane / lanes;
       base - lane / lanes < M; base += U * stride) {
    uint4 xr[U][Q];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t m = base + j * stride;
      load_packed<Q>(x, m, m < M, C, lanes, li, xr[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t m = base + j * stride;
      float z[Q][8];
      unpack_row<Q>(xr[j], z);
      row_z<Q>(z, C, lanes, eps);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int col = 8 * (li + q * lanes);
        if (m >= M || col >= C) continue;
        float sv[8], tv[8], xh[8];
        unpack8(sp[q], sv);
        unpack8(tp[q], tv);
#pragma unroll
        for (int v = 0; v < 8; ++v) xh[v] = z[q][v] * sv[v] + tv[v];
        store8(xhat + m * C + col, xh);
      }
    }
  }
}

template <int Q, int U>
cudaError_t launch_ln_fwd(const bf16* x, const bf16* s, const bf16* t, bf16* xhat,
                          int64_t M, int C, float eps, cudaStream_t st) {
  const int lanes = row_lanes(C);
  const int64_t rows = (int64_t)ROW_WARPS * (32 / lanes) * U;
  const int64_t need = (M + rows - 1) / rows;
  ln_fwd_kernel<Q, U><<<(unsigned)(need < LN_GRID ? need : LN_GRID), ROW_THREADS, 0,
                        st>>>(x, s, t, xhat, M, C, eps, lanes);
  return cudaGetLastError();
}

// GELU_erf by the formula of ic_gelu_erf_as (common.cuh) on the fast
// intrinsics, one __fdividef and one __expf, as the backward's dh epilogue
// takes it: fc1's epilogue evaluates it for 4 * M * C elements, where the
// precise division and exp would keep the SM's instruction slots busier
// than its stores keep the memory.
__device__ __forceinline__ float gelu_fast(float a) {
  const float x = a * 0.7071067811865476f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float erf = 1.0f - poly * __expf(-ax * ax);
  erf = x < 0.0f ? -erf : (x > 0.0f ? erf : 0.0f);
  return 0.5f * a * (1.0f + erf);
}

// (b): h = GELU_erf(acc + b1) rounded; a = acc + b1 rounded where a is set.
struct EpiBiasGelu : GemmShape {
  const bf16* bias;
  bf16* h;
  bf16* a;

  __device__ void operator()(const float (&acc)[64], uint8_t* smem, int64_t m0,
                             int n0) const {
    const float* tile = stage_acc(acc, smem);
    const int cc = threadIdx.x % EPI_COLS, rg = threadIdx.x / EPI_COLS;
    const int n = n0 + 8 * cc;
    float b[8];
    if (n < N) load8(bias + n, b);
    consumer_sync();
    if (n >= N) return;
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int r = rg + i * EPI_ROWS;
      const int64_t m = m0 + r;
      if (m >= M) break;
      float v[8], g[8];
      tile_row8(tile, r, cc, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] += b[k];
        g[k] = gelu_fast(v[k]);
      }
      const int64_t idx = m * N + n;
      store8(h + idx, g);
      if (a != nullptr) store8(a + idx, v);
    }
  }
};

// (c): u = acc + b2 in f32, y = res + g * u rounded; u rounded where set.
struct EpiScaleResidual : GemmShape {
  const bf16* bias;
  const bf16* res;
  const bf16* gamma;
  bf16* y;
  bf16* u;

  __device__ void operator()(const float (&acc)[64], uint8_t* smem, int64_t m0,
                             int n0) const {
    const float* tile = stage_acc(acc, smem);
    const int cc = threadIdx.x % EPI_COLS, rg = threadIdx.x / EPI_COLS;
    const int n = n0 + 8 * cc;
    float b[8], g[8];
    uint4 rraw[EPI_ROWS_A_THREAD];
    if (n < N) {
      load8(bias + n, b);
      load8(gamma + n, g);
    }
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int64_t m = m0 + rg + i * EPI_ROWS;
      rraw[i] = m < M && n < N ? *reinterpret_cast<const uint4*>(res + m * N + n)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    consumer_sync();
    if (n >= N) return;
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int r = rg + i * EPI_ROWS;
      const int64_t m = m0 + r;
      if (m >= M) break;
      float v[8], rv[8], out[8];
      tile_row8(tile, r, cc, v);
      unpack8(rraw[i], rv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] += b[k];
        out[k] = rv[k] + g[k] * v[k];
      }
      const int64_t idx = m * N + n;
      store8(y + idx, out);
      if (u != nullptr) store8(u + idx, v);
    }
  }
};

// The shapes the bf16 forward takes: whole 16-byte rows of every operand
// (C and H4 multiples of 8), C within the row layout, the row tiles within
// the grid.
bool fwd_bf16_shape_ok(int64_t M, int C, int H4) {
  return M >= 1 && C >= 8 && C % 8 == 0 && C <= MAX_C && H4 >= 8 && H4 % 8 == 0 &&
         (M + BM - 1) / BM <= 65535;
}

// One product of the forward on the GEMM core with its epilogue: fc1
// (which = 1: out = h, aux = a or null, res and gamma unused) or fc2 (which
// = 2: out = y, aux = u or null). A (M, K) and W (N, K) bf16, both K-major.
cudaError_t fc_bf16(int which, const void* A, const void* W, const void* bias,
                    const void* res, const void* gamma, void* out, void* aux,
                    int64_t M, int N, int64_t K, cudaStream_t st) {
  CUtensorMap ma, mb;
  IC_TRY(make_maps(&ma, &mb, A, W, true, true, M, N, K));
  const GemmShape shape{M, N, K, ((K + BK - 1) / BK) * BK};
  const bf16* b = static_cast<const bf16*>(bias);
  if (which == 1) {
    const EpiBiasGelu epi{shape, b, static_cast<bf16*>(out), static_cast<bf16*>(aux)};
    return launch_gemm<EpiBiasGelu, true, true>(ma, mb, epi, 1, st);
  }
  const EpiScaleResidual epi{shape, b, static_cast<const bf16*>(res),
                             static_cast<const bf16*>(gamma), static_cast<bf16*>(out),
                             static_cast<bf16*>(aux)};
  return launch_gemm<EpiScaleResidual, true, true>(ma, mb, epi, 1, st);
}

cudaError_t fwd_bf16(const void* x, const void* res, const void* s, const void* t,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* g, void* xhat, void* h, void* y,
                     void* a, void* u, int64_t M, int C, int H4, float eps,
                     cudaStream_t st) {
  if (!fwd_bf16_shape_ok(M, C, H4)) return cudaErrorInvalidValue;
  const bf16 *xb = static_cast<const bf16*>(x), *sb = static_cast<const bf16*>(s),
             *tb = static_cast<const bf16*>(t);
  bf16* xh = static_cast<bf16*>(xhat);
  IC_TRY((C <= 256 ? launch_ln_fwd<1, 2>(xb, sb, tb, xh, M, C, eps, st)
                   : launch_ln_fwd<2, 1>(xb, sb, tb, xh, M, C, eps, st)));
  IC_TRY(fc_bf16(1, xhat, w1, b1, nullptr, nullptr, h, a, M, H4, C, st));
  return fc_bf16(2, h, w2, b2, res, g, y, u, M, C, H4, st);
}

// ----------------------------------------------------------- f32 FMA GEMM
constexpr int FBM = 64, FBN = 64, FBK = 16, F_THREADS = 256;

template <bool KMAJOR>
__device__ __forceinline__ float load_f32(const float* src, int64_t rows,
                                          int64_t K, int64_t r, int64_t k,
                                          int64_t k_end) {
  if (r >= rows || k >= k_end) return 0.0f;
  return KMAJOR ? src[r * K + k] : src[k * rows + r];
}

template <int EPI, bool A_KMAJOR, bool B_KMAJOR, bool GELU_B>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    Epi e, int64_t M, int N, int64_t K, int64_t kchunk) {
  __shared__ float As[FBK][FBM + 1];
  __shared__ float Bs[FBK][FBN + 1];
  __shared__ float colsm[F_THREADS / 16][FBN];
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  const int64_t m0 = (int64_t)blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;
  const int64_t k_begin = (int64_t)blockIdx.z * kchunk;
  const int64_t k_end = k_begin + kchunk < K ? k_begin + kchunk : K;
  float acc[4][4] = {};
  for (int64_t k0 = k_begin; k0 < k_end; k0 += FBK) {
    for (int idx = threadIdx.x; idx < FBM * FBK; idx += F_THREADS) {
      const int rr = idx / FBK, kk = idx % FBK;
      As[kk][rr] = load_f32<A_KMAJOR>(A, M, K, m0 + rr, k0 + kk, k_end);
      const float b = load_f32<B_KMAJOR>(B, N, K, n0 + rr, k0 + kk, k_end);
      Bs[kk][rr] = GELU_B ? ic_gelu_erf_as(b) : b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float csum[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N)
        csum[j] += store_epilogue<EPI>(acc[i][j], m, n, M, N, e);
    }
  }
  if constexpr (EPI == EPI_DGELU) {
#pragma unroll
    for (int j = 0; j < 4; ++j) colsm[ty][tx * 4 + j] = csum[j];
    __syncthreads();
    for (int t = threadIdx.x; t < FBN; t += F_THREADS) {
      if (n0 + t < N) {
        float s = 0.0f;
        for (int w = 0; w < F_THREADS / 16; ++w) s += colsm[w][t];
        e.colsum[(int64_t)blockIdx.y * N + n0 + t] = s;
      }
    }
  }
}

// ---------------------------------------------------------------- launches
int64_t fma_row_tiles(int64_t M) { return (M + FBM - 1) / FBM; }

template <int EPI, bool A_KMAJOR, bool B_KMAJOR, bool GELU_B>
cudaError_t launch_fma_gemm(const void* A, const void* B, const Epi& e, int64_t M,
                            int N, int64_t K, int splits, int64_t kchunk,
                            cudaStream_t st) {
  const dim3 grid((N + FBN - 1) / FBN, (unsigned)fma_row_tiles(M), splits);
  gemm_f32_fma_kernel<EPI, A_KMAJOR, B_KMAJOR, GELU_B>
      <<<grid, F_THREADS, 0, st>>>(static_cast<const float*>(A),
                                   static_cast<const float*>(B), e, M, N, K,
                                   kchunk);
  return cudaGetLastError();
}

cudaError_t launch_sum_rows(const float* part, int R, int64_t N, float* out,
                            cudaStream_t st) {
  sum_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(part, R, N, out);
  return cudaGetLastError();
}

// Splits of the K = M weight-gradient GEMMs: enough blocks for about two
// waves of 132 SMs (a fixed count, so the sums' order does not depend on the
// card), each split a whole number of k-tiles.
constexpr int SPLIT_TARGET_BLOCKS = 264;

struct Split {
  int splits;
  int64_t kchunk;
};

Split weight_grad_split(int I, int J, int64_t K) {
  const int64_t tiles = (int64_t)((I + FBM - 1) / FBM) * ((J + FBN - 1) / FBN);
  int64_t s = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  const int64_t ktiles = (K + FBK - 1) / FBK;
  if (s > ktiles) s = ktiles;
  if (s < 1) s = 1;
  const int64_t kchunk = ((ktiles + s - 1) / s) * FBK;
  return {(int)((K + kchunk - 1) / kchunk), kchunk};
}

// Offsets (in floats) of the f32 backward's scratch.
struct BwdScratch {
  int64_t prep, db1, ln, split, total;
  int rows_blocks, gemm_rows;
  Split s1, s2;
};

BwdScratch bwd_scratch(int64_t M, int C, int H4) {
  BwdScratch b;
  b.rows_blocks = (int)((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  b.gemm_rows = (int)fma_row_tiles(M);
  b.s1 = weight_grad_split(H4, C, M);
  b.s2 = weight_grad_split(C, H4, M);
  b.prep = 0;                                          // 2 x (rows_blocks, C)
  b.db1 = b.prep + 2 * (int64_t)b.rows_blocks * C;     // (gemm_rows, H4)
  b.ln = b.db1 + (int64_t)b.gemm_rows * H4;            // 2 x (rows_blocks, C)
  b.split = b.ln + 2 * (int64_t)b.rows_blocks * C;     // (splits, H4 * C)
  const int smax = b.s1.splits > b.s2.splits ? b.s1.splits : b.s2.splits;
  b.total = b.split + (int64_t)smax * H4 * C;
  return b;
}

}  // namespace

// All tensors contiguous and of one dtype. x, res, xhat, y: (M, C);
// s, t, b2, g: (C,); w1: (H4, C); b1: (H4,); w2: (C, H4); h: (M, H4).
// xhat and h are scratch the caller allocates. a (M, H4) and u (M, C) are
// the residuals training saves, or null. bf16: 16-byte aligned, C and H4
// multiples of 8, C <= 512; f32: C <= 512.
extern "C" int ic_block_mlp_fwd(const void* x, const void* res, const void* s,
                                const void* t, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* g,
                                void* xhat, void* h, void* y, void* a, void* u,
                                int64_t M, int C, int H4, float eps, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != IC_F32 && dtype != IC_BF16) return cudaErrorInvalidValue;
  if (dtype == IC_BF16)
    return fwd_bf16(x, res, s, t, w1, b1, w2, b2, g, xhat, h, y, a, u, M, C, H4,
                    eps, st);
  if (C > MAX_C) return cudaErrorInvalidValue;
  ln_rows_kernel<<<(unsigned)((M + LN_WARPS - 1) / LN_WARPS), LN_THREADS, 0,
                          st>>>(static_cast<const float*>(x),
                                static_cast<const float*>(s),
                                static_cast<const float*>(t),
                                static_cast<float*>(xhat), M, C, eps);
  IC_TRY(cudaGetLastError());
  const Epi fc1{b1, nullptr, nullptr, h, a, nullptr};
  IC_TRY((launch_fma_gemm<EPI_BIAS_GELU, true, true, false>(xhat, w1, fc1, M, H4,
                                                            C, 1, C, st)));
  const Epi fc2{b2, res, g, y, u, nullptr};
  return launch_fma_gemm<EPI_BIAS_SCALE_RESIDUAL, true, true, false>(
      h, w2, fc2, M, C, H4, 1, H4, st);
}

// One product of the bf16 forward alone on the GEMM core, with its
// epilogue, for checks and timing on the card: fc1 (which = 1) h = GELU(A
// W^T + bias), a = A W^T + bias where aux is set; fc2 (which = 2) y = res +
// gamma * (A W^T + bias), u = A W^T + bias where aux is set. bf16,
// contiguous, 16-byte aligned: A (M, K), W (N, K), bias and gamma (N,), res,
// out and aux (M, N); N and K multiples of 8.
extern "C" int ic_block_mlp_fc_bf16(int which, const void* A, const void* W,
                                    const void* bias, const void* res,
                                    const void* gamma, void* out, void* aux,
                                    int64_t M, int N, int64_t K, void* stream) {
  if ((which != 1 && which != 2) || M < 1 || N < 8 || N % 8 || K < 8 || K % 8 ||
      (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  return fc_bf16(which, A, W, bias, res, gamma, out, aux, M, N, K,
                 static_cast<cudaStream_t>(stream));
}

// Floats of f32 scratch ic_block_mlp_bwd needs for these shapes (f32 only).
extern "C" int64_t ic_block_mlp_bwd_scratch(int64_t M, int C, int H4,
                                            int dtype) {
  return dtype == IC_F32 ? bwd_scratch(M, C, H4).total : -1;
}

// The f32 backward (block_mlp_bwd.cu has the bf16 one). Inputs (f32,
// contiguous): x, u, dy (M, C); a (M, H4); s, t, g (C,); w1 (H4, C); w2
// (C, H4). Scratch: xhat, du, dxhat (M, C) and da (M, H4); scratch of the
// size above. Outputs, written outright: dx (M, C); ds, dt, db2, dg (C,), db1
// (H4,), dw1 (H4, C), dw2 (C, H4). M >= 1.
extern "C" int ic_block_mlp_bwd(
    const void* x, const void* a, const void* u, const void* s, const void* t,
    const void* w1, const void* w2, const void* g, const void* dy, void* xhat,
    void* du, void* da, void* dxhat, void* scratch, void* dx, void* ds,
    void* dt, void* dw1, void* db1, void* dw2, void* db2, void* dg, int64_t M,
    int C, int H4, float eps, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != IC_F32 || C > MAX_C || M < 1) return cudaErrorInvalidValue;
  const BwdScratch b = bwd_scratch(M, C, H4);
  float* f = static_cast<float*>(scratch);
  float* p_db2 = f + b.prep;
  float* p_dg = p_db2 + (int64_t)b.rows_blocks * C;
  float* p_db1 = f + b.db1;
  float* p_ds = f + b.ln;
  float* p_dt = p_ds + (int64_t)b.rows_blocks * C;
  float* p_split = f + b.split;
  float* dxhat_f = static_cast<float*>(dxhat);

  // (d) xhat, du and the partials of db2, dg
  bwd_prep_kernel<<<b.rows_blocks, LN_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(dy), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const float*>(g),
      static_cast<float*>(xhat), static_cast<float*>(du), p_db2, p_dg, M, C, eps);
  IC_TRY(cudaGetLastError());
  IC_TRY(launch_sum_rows(p_db2, b.rows_blocks, C, static_cast<float*>(db2), st));
  IC_TRY(launch_sum_rows(p_dg, b.rows_blocks, C, static_cast<float*>(dg), st));
  // (e) da = (du @ W2) * gelu'(a), partials of db1
  const Epi dh{nullptr, a, nullptr, da, nullptr, p_db1};
  IC_TRY((launch_fma_gemm<EPI_DGELU, true, false, false>(du, w2, dh, M, H4, C, 1,
                                                         C, st)));
  IC_TRY(launch_sum_rows(p_db1, b.gemm_rows, H4, static_cast<float*>(db1), st));
  // (f) dxhat = da @ W1 in f32
  const Epi dxh{nullptr, nullptr, nullptr, dxhat_f, nullptr, nullptr};
  IC_TRY((launch_fma_gemm<EPI_F32, true, false, false>(da, w1, dxh, M, C, H4, 1,
                                                       H4, st)));
  // (g) the LayerNorm backward, partials of ds, dt
  ln_bwd_kernel<<<b.rows_blocks, LN_THREADS, 0, st>>>(
      static_cast<const float*>(x), dxhat_f, static_cast<const float*>(s),
      static_cast<float*>(dx), p_ds, p_dt, M, C, eps);
  IC_TRY(cudaGetLastError());
  IC_TRY(launch_sum_rows(p_ds, b.rows_blocks, C, static_cast<float*>(ds), st));
  IC_TRY(launch_sum_rows(p_dt, b.rows_blocks, C, static_cast<float*>(dt), st));
  // (h) dW1 (H4, C) = da^T @ xhat; dW2 (C, H4) = du^T @ GELU(a)
  const Epi split{nullptr, nullptr, nullptr, p_split, nullptr, nullptr};
  IC_TRY((launch_fma_gemm<EPI_F32, false, false, false>(
      da, xhat, split, H4, C, M, b.s1.splits, b.s1.kchunk, st)));
  IC_TRY(launch_sum_rows(p_split, b.s1.splits, (int64_t)H4 * C,
                         static_cast<float*>(dw1), st));
  IC_TRY((launch_fma_gemm<EPI_F32, false, false, true>(
      du, a, split, C, H4, M, b.s2.splits, b.s2.kchunk, st)));
  return launch_sum_rows(p_split, b.s2.splits, (int64_t)C * H4,
                         static_cast<float*>(dw2), st);
}
