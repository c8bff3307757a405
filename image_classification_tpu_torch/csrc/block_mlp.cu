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
// What bounds it on the H100: the matrix products. The forward runs two of
// 2 * M * C * 4C FLOP, the backward four (dh, dxhat, dW1, dW2), 32 * M * C^2
// FLOP in all. At the train step's shapes (M = 16 * 65^2 rows at C = 128,
// then C = 256, 512) the backward moves ~16 * M * C bytes at bf16, so above
// C ~ 64 the tensor cores, not memory, set the pace.
//
// What the design does about it. The TPU kernels keep a (TM, 4C) tile in
// 100 MB of VMEM; 227 KB of shared memory cannot, so each direction is split
// into launches on one stream around one tiled GEMM kernel:
//   forward
//   (a) ln_rows: one warp per row, f32 mean and E[x^2] - mean^2 variance
//       (the TPU kernel's _norm_stats), xhat = z * s + t in the working dtype
//       (C <= 512: a lane keeps its 16 columns of the row in registers);
//   (b) h = GELU_erf(xhat @ W1^T + b1), epilogue: bias, the A&S-erf GELU in
//       f32, then h rounded; for training it also stores a = xhat @ W1^T + b1
//       rounded. fc2 does not apply GELU to a as it loads it, because the
//       forward's h is GELU of the unrounded a, and GELU of the rounded a
//       differs from it by an ulp of bf16 in places: storing a from the fc1
//       epilogue keeps the output equal to the Pallas kernel's;
//   (c) y = res + g * (h @ W2^T + b2), epilogue: residual; for training it
//       also stores u = h @ W2^T + b2 rounded (y itself uses u unrounded).
//   f32 backward (the order of _bwd_kernel)
//   (d) bwd_prep rows: xhat recomputed from x and stored rounded (dW1's
//       operand); du = dy * g stored rounded; f32 column partials of du (db2)
//       and of dy * u_saved (dg);
//   (e) dh = du @ W2, epilogue: da = dh * gelu'(a_saved) stored rounded, and
//       its f32 column partials (db1);
//   (f) dxhat = da @ W1, stored in f32;
//   (g) ln_bwd rows: dz = dxhat * s, dx = r * (dz - mean(dz) - z * mean(dz z))
//       with the statistics recomputed from x; f32 column partials of
//       dxhat * z (ds) and dxhat (dt);
//   (h) dW1 = da^T @ xhat and dW2 = du^T @ GELU(a_saved), the GEMM with K = M
//       split over M into f32 partials (the GELU of a, rounded, is applied as
//       the tile is loaded, so h is never stored);
//   (i) every partial summed by a second pass in a fixed order.
// Blocks run in no order on Hopper, so the TPU's grid-carried f32 sums
// become per-block partials plus that pass: no float atomics, so two runs
// give the same bits. Rows past M load as zeros and add nothing to any sum.
//
// The forward's bf16 GEMM runs on the tensor cores through WMMA (16x16x16
// bf16 fragments, f32 accumulation), with 128x128x32 block tiles staged
// through shared memory by 16-byte loads, the next k-tile prefetched into
// registers while the current one is multiplied; both operands are K-major,
// so the weights stay in nn.Linear's (out, in) layout. The f32 path is a
// plain FMA tiling that reads each operand K-major or row-major, kept for
// exact checks against the f32 plain version.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

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
  void* out;          // (M, N) in the storage type; f32 (splits, M, N) for EPI_F32
  void* aux;          // (M, N) or null: the pre-activation training saves
  float* colsum;      // (gridDim.y, N): column partials of EPI_DGELU
};

// Finishes output element (m, n) from its f32 product; returns the f32 value
// whose columns EPI_DGELU sums.
template <int EPI, typename T>
__device__ __forceinline__ float store_epilogue(float acc, int64_t m, int n,
                                                int64_t M, int N,
                                                const Epi& e) {
  const int64_t idx = m * N + n;
  if constexpr (EPI == EPI_F32) {
    static_cast<float*>(e.out)[(int64_t)blockIdx.z * M * N + idx] = acc;
    return acc;
  } else if constexpr (EPI == EPI_DGELU) {
    const float a = ic_to_f32<T>(static_cast<const T*>(e.res)[idx]);
    const float v = acc * ic_gelu_grad_as(a);
    static_cast<T*>(e.out)[idx] = ic_from_f32<T>(v);
    return v;
  } else {
    const float v = acc + ic_to_f32<T>(static_cast<const T*>(e.bias)[n]);
    if (e.aux != nullptr) static_cast<T*>(e.aux)[idx] = ic_from_f32<T>(v);
    T* out = static_cast<T*>(e.out);
    if constexpr (EPI == EPI_BIAS_GELU) {
      out[idx] = ic_from_f32<T>(ic_gelu_erf_as(v));
    } else {
      const float r = ic_to_f32<T>(static_cast<const T*>(e.res)[idx]);
      const float g = ic_to_f32<T>(static_cast<const T*>(e.gamma)[n]);
      out[idx] = ic_from_f32<T>(r + g * v);
    }
    return v;
  }
}

// ------------------------------------------------------------- row kernels
constexpr int LN_THREADS = 256;
constexpr int ROW_WARPS = LN_THREADS / 32;
constexpr int ROWS_PER_BLOCK = 64;   // backward row kernels: rows a block sums
constexpr int MAX_C = 512;           // ops/block_mlp.py MAX_FUSED_C
constexpr int MAX_Q = MAX_C / 32;    // columns a lane holds

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads a row of x into xv (the lane's columns lane + 32 q), replaces it by
// z = (x - mean) * r and returns r = rsqrt(var + eps): f32 mean and
// E[x^2] - mean^2 variance (the TPU kernel's _norm_stats).
template <typename T>
__device__ __forceinline__ float row_z(const T* __restrict__ xr, int C,
                                       float eps, float (&xv)[MAX_Q]) {
  const int lane = threadIdx.x % 32;
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    const int c = lane + 32 * q;
    xv[q] = c < C ? ic_to_f32<T>(xr[c]) : 0.0f;
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

// (a): one warp a row, xhat = z * s + t in the storage type.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ s,
               const T* __restrict__ t, T* __restrict__ out, int64_t M, int C,
               float eps) {
  const int64_t row = (int64_t)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;   // whole warps: row is the same on every lane
  float z[MAX_Q];
  row_z<T>(x + row * C, C, eps, z);
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    const int c = lane + 32 * q;
    if (c < C)
      out[row * C + c] =
          ic_from_f32<T>(z[q] * ic_to_f32<T>(s[c]) + ic_to_f32<T>(t[c]));
  }
}

// Sums two per-lane column accumulators over the block's warps, in warp
// order, into row blockIdx.x of the (gridDim.x, C) partials p0 and p1.
__device__ __forceinline__ void block_column_partials(
    float (&red)[2][ROW_WARPS][MAX_C], const float (&a0)[MAX_Q],
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
    for (int w = 0; w < ROW_WARPS; ++w) {
      s0 += red[0][w][c];
      s1 += red[1][w][c];
    }
    p0[(int64_t)blockIdx.x * C + c] = s0;
    p1[(int64_t)blockIdx.x * C + c] = s1;
  }
}

// (d): xhat = bf(z s + t), du = bf(dy g); partials of du (db2), dy u (dg).
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
bwd_prep_kernel(const T* __restrict__ x, const T* __restrict__ u,
                const T* __restrict__ dy, const T* __restrict__ s,
                const T* __restrict__ t, const T* __restrict__ g,
                T* __restrict__ xhat, T* __restrict__ du,
                float* __restrict__ part_db2, float* __restrict__ part_dg,
                int64_t M, int C, float eps) {
  __shared__ float red[2][ROW_WARPS][MAX_C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a_db2[MAX_Q], a_dg[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) a_db2[q] = a_dg[q] = 0.0f;
  for (int rr = warp; rr < ROWS_PER_BLOCK; rr += ROW_WARPS) {
    const int64_t m = (int64_t)blockIdx.x * ROWS_PER_BLOCK + rr;
    if (m >= M) break;
    float z[MAX_Q];
    row_z<T>(x + m * C, C, eps, z);
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      const int c = lane + 32 * q;
      if (c < C) {
        const int64_t i = m * C + c;
        xhat[i] = ic_from_f32<T>(z[q] * ic_to_f32<T>(s[c]) + ic_to_f32<T>(t[c]));
        const float dyv = ic_to_f32<T>(dy[i]);
        const float duv = dyv * ic_to_f32<T>(g[c]);
        du[i] = ic_from_f32<T>(duv);
        a_db2[q] += duv;
        a_dg[q] += dyv * ic_to_f32<T>(u[i]);
      }
    }
  }
  block_column_partials(red, a_db2, a_dg, C, part_db2, part_dg);
}

// (g): the LayerNorm backward; partials of dxhat z (ds) and dxhat (dt).
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dxhat,
              const T* __restrict__ s, T* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_dt,
              int64_t M, int C, float eps) {
  __shared__ float red[2][ROW_WARPS][MAX_C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a_ds[MAX_Q], a_dt[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) a_ds[q] = a_dt[q] = 0.0f;
  for (int rr = warp; rr < ROWS_PER_BLOCK; rr += ROW_WARPS) {
    const int64_t m = (int64_t)blockIdx.x * ROWS_PER_BLOCK + rr;
    if (m >= M) break;
    float z[MAX_Q], dz[MAX_Q];
    const float r = row_z<T>(x + m * C, C, eps, z);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      const int c = lane + 32 * q;
      float dxh = 0.0f;
      if (c < C) {
        dxh = dxhat[m * C + c];
        dz[q] = dxh * ic_to_f32<T>(s[c]);
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
      if (c < C) dx[m * C + c] = ic_from_f32<T>(r * (dz[q] - m1 - z[q] * m2));
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

// --------------------------------------------------------- bf16 WMMA GEMM
// out[M, N] = epilogue(sum over k of A(m, k) * B(n, k)), the forward's
// epilogues. A is stored (M, K), B (N, K); K % 8 == 0 (whole 16-byte
// chunks).
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDK = BK + 8;           // pitch of a K-major tile [128][40]
constexpr int TILE_ELEMS = BM * LDK;
constexpr int GEMM_THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int WM = 32, WN = 64;       // warp tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int CHUNKS = BM * BK / 8 / GEMM_THREADS;  // 16-byte loads a thread
static_assert(BM == BN, "one tile shape serves A and B");

__device__ __forceinline__ void load_tile_regs(const bf16* src, int64_t rows,
                                               int64_t K, int64_t row0,
                                               int64_t k0, uint4 (&regs)[CHUNKS]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int idx = threadIdx.x + i * GEMM_THREADS;
    const int64_t gr = row0 + idx / (BK / 8);
    const int64_t gk = k0 + (idx % (BK / 8)) * 8;
    if (gr < rows && gk < K) {
      regs[i] = *reinterpret_cast<const uint4*>(src + gr * K + gk);
    } else {
      regs[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void store_tile_smem(bf16* tile,
                                                const uint4 (&regs)[CHUNKS]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int idx = threadIdx.x + i * GEMM_THREADS;
    *reinterpret_cast<uint4*>(tile + (idx / (BK / 8)) * LDK + (idx % (BK / 8)) * 8) =
        regs[i];
  }
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_wmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                      Epi e, int64_t M, int N, int64_t K) {
  static_assert(EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_SCALE_RESIDUAL,
                "the bf16 WMMA path runs the forward's epilogues");
  __shared__ __align__(128) bf16 As[TILE_ELEMS];
  __shared__ __align__(128) bf16 Bs[TILE_ELEMS];
  __shared__ __align__(128) float Cs[GEMM_THREADS / 32][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN);    // 0..3
  const int wn = warp % (BN / WN);    // 0..1
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[CHUNKS], rb[CHUNKS];
  load_tile_regs(A, M, K, m0, 0, ra);
  load_tile_regs(B, N, K, n0, 0, rb);
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    store_tile_smem(As, ra);
    store_tile_smem(Bs, rb);
    __syncthreads();
    if (k0 + BK < K) {  // prefetch the next k-tile while this one multiplies
      load_tile_regs(A, M, K, m0, k0 + BK, ra);
      load_tile_regs(B, N, K, n0, k0 + BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * WN + j * 16) * LDK + kk, LDK);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each warp stages one 16x16 fragment at a time in its own
  // scratch, then each lane finishes 8 consecutive columns of one row.
  float* scratch = Cs[warp];
  const int r = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * WM + i * 16 + r;
      const int nb = n0 + wn * WN + j * 16 + cc;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (m < M && nb + v < N)
          store_epilogue<EPI, bf16>(scratch[r * 16 + cc + v], m, nb + v, M, N, e);
      }
      __syncwarp();
    }
  }
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
        csum[j] += store_epilogue<EPI, float>(acc[i][j], m, n, M, N, e);
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
int64_t gemm_row_tiles(int dtype, int64_t M) {
  const int bm = dtype == IC_BF16 ? BM : FBM;
  return (M + bm - 1) / bm;
}

template <int EPI, bool A_KMAJOR, bool B_KMAJOR, bool GELU_B>
cudaError_t launch_gemm(int dtype, const void* A, const void* B, const Epi& e,
                        int64_t M, int N, int64_t K, int splits,
                        int64_t kchunk, cudaStream_t st) {
  if constexpr (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_SCALE_RESIDUAL) {
    if (dtype == IC_BF16) {  // the forward: K-major operands, no split
      static_assert(A_KMAJOR && B_KMAJOR && !GELU_B, "the forward's products");
      const dim3 grid((N + BN - 1) / BN, (unsigned)gemm_row_tiles(dtype, M));
      gemm_bf16_wmma_kernel<EPI><<<grid, GEMM_THREADS, 0, st>>>(
          static_cast<const bf16*>(A), static_cast<const bf16*>(B), e, M, N, K);
      return cudaGetLastError();
    }
  }
  {
    const dim3 grid((N + FBN - 1) / FBN, (unsigned)gemm_row_tiles(dtype, M),
                    splits);
    gemm_f32_fma_kernel<EPI, A_KMAJOR, B_KMAJOR, GELU_B>
        <<<grid, F_THREADS, 0, st>>>(static_cast<const float*>(A),
                                     static_cast<const float*>(B), e, M, N, K,
                                     kchunk);
  }
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
  b.gemm_rows = (int)gemm_row_tiles(IC_F32, M);
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

template <typename T>
cudaError_t launch_ln(const void* x, const void* s, const void* t, void* out,
                      int64_t M, int C, float eps, cudaStream_t st) {
  const int64_t blocks = (M + ROW_WARPS - 1) / ROW_WARPS;
  ln_rows_kernel<T><<<(unsigned)blocks, LN_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(t), static_cast<T*>(out), M, C, eps);
  return cudaGetLastError();
}


#define IC_TRY(expr)                        \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

}  // namespace

// All tensors contiguous and of one dtype. x, res, xhat, y: (M, C);
// s, t, b2, g: (C,); w1: (H4, C); b1: (H4,); w2: (C, H4); h: (M, H4).
// xhat and h are scratch the caller allocates. a (M, H4) and u (M, C) are
// the residuals training saves, or null.
extern "C" int ic_block_mlp_fwd(const void* x, const void* res, const void* s,
                                const void* t, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* g,
                                void* xhat, void* h, void* y, void* a, void* u,
                                int64_t M, int C, int H4, float eps, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != IC_F32 && dtype != IC_BF16) return cudaErrorInvalidValue;
  if (C > MAX_C) return cudaErrorInvalidValue;
  IC_TRY(dtype == IC_BF16
             ? launch_ln<bf16>(x, s, t, xhat, M, C, eps, st)
             : launch_ln<float>(x, s, t, xhat, M, C, eps, st));
  const Epi fc1{b1, nullptr, nullptr, h, a, nullptr};
  IC_TRY((launch_gemm<EPI_BIAS_GELU, true, true, false>(dtype, xhat, w1, fc1, M,
                                                        H4, C, 1, C, st)));
  const Epi fc2{b2, res, g, y, u, nullptr};
  return launch_gemm<EPI_BIAS_SCALE_RESIDUAL, true, true, false>(
      dtype, h, w2, fc2, M, C, H4, 1, H4, st);
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
  bwd_prep_kernel<float><<<b.rows_blocks, LN_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(dy), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const float*>(g),
      static_cast<float*>(xhat), static_cast<float*>(du), p_db2, p_dg, M, C, eps);
  IC_TRY(cudaGetLastError());
  IC_TRY(launch_sum_rows(p_db2, b.rows_blocks, C, static_cast<float*>(db2), st));
  IC_TRY(launch_sum_rows(p_dg, b.rows_blocks, C, static_cast<float*>(dg), st));
  // (e) da = (du @ W2) * gelu'(a), partials of db1
  const Epi dh{nullptr, a, nullptr, da, nullptr, p_db1};
  IC_TRY((launch_gemm<EPI_DGELU, true, false, false>(dtype, du, w2, dh, M, H4,
                                                     C, 1, C, st)));
  IC_TRY(launch_sum_rows(p_db1, b.gemm_rows, H4, static_cast<float*>(db1), st));
  // (f) dxhat = da @ W1 in f32
  const Epi dxh{nullptr, nullptr, nullptr, dxhat_f, nullptr, nullptr};
  IC_TRY((launch_gemm<EPI_F32, true, false, false>(dtype, da, w1, dxh, M, C, H4,
                                                   1, H4, st)));
  // (g) the LayerNorm backward, partials of ds, dt
  ln_bwd_kernel<float><<<b.rows_blocks, LN_THREADS, 0, st>>>(
      static_cast<const float*>(x), dxhat_f, static_cast<const float*>(s),
      static_cast<float*>(dx), p_ds, p_dt, M, C, eps);
  IC_TRY(cudaGetLastError());
  IC_TRY(launch_sum_rows(p_ds, b.rows_blocks, C, static_cast<float*>(ds), st));
  IC_TRY(launch_sum_rows(p_dt, b.rows_blocks, C, static_cast<float*>(dt), st));
  // (h) dW1 (H4, C) = da^T @ xhat; dW2 (C, H4) = du^T @ GELU(a)
  const Epi split{nullptr, nullptr, nullptr, p_split, nullptr, nullptr};
  IC_TRY((launch_gemm<EPI_F32, false, false, false>(
      dtype, da, xhat, split, H4, C, M, b.s1.splits, b.s1.kchunk, st)));
  IC_TRY(launch_sum_rows(p_split, b.s1.splits, (int64_t)H4 * C,
                         static_cast<float*>(dw1), st));
  IC_TRY((launch_gemm<EPI_F32, false, false, true>(
      dtype, du, a, split, C, H4, M, b.s2.splits, b.s2.kchunk, st)));
  return launch_sum_rows(p_split, b.s2.splits, (int64_t)C * H4,
                         static_cast<float*>(dw2), st);
}
