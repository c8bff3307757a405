// ConvNeXt block tail, forward: y = res + g * (GELU(LN(x) @ W1^T + b1) @ W2^T + b2)
//
// Replaces: image_classification_tpu/ops/block_mlp.py:_run_fwd and its body
// _fwd_kernel (the fused forward Pallas kernel; the backward _bwd_kernel is
// not ported yet).
//
// What bounds it on the H100: the two matrix products, 2 * M * C * 4C FLOP
// each. At the slice's shapes (M = 256 * 65^2 rows at C = 128, and C = 256,
// 512) they hold ~98% of the block tail's arithmetic. With the 4C-wide
// intermediate h written to and read back from device memory once, the tail
// moves ~12 * M * C bytes at bf16 against 16 * M * C^2 FLOP, so above C ~ 128
// the tensor cores, not memory, set the pace.
//
// What the design does about it: the TPU kernel keeps a (TM, 4C) tile in
// 100 MB of VMEM; 227 KB of shared memory cannot, so the tail is split into
// three launches on one stream:
//   (a) ln_rows: one warp per row, f32 mean and E[x^2] - mean^2 variance
//       (the TPU kernel's _norm_stats), xhat = z * s + t written in the
//       working dtype;
//   (b) h = GELU_erf(xhat @ W1^T + b1), a tiled GEMM whose epilogue adds the
//       bias and applies the A&S-erf GELU in f32 before rounding h;
//   (c) y = res + g * (h @ W2^T + b2), the same GEMM with a residual
//       epilogue.
// The bf16 GEMM runs on the tensor cores through WMMA (16x16x16 bf16
// fragments, f32 accumulation), with 128x128x32 block tiles staged through
// shared memory by 16-byte loads, the next k-tile prefetched into registers
// while the current one is multiplied. Weights stay in nn.Linear's (out, in)
// layout, which is the column-major B operand WMMA loads directly. The f32
// path is a plain FMA tiling, kept for exact checks against the f32 plain
// version. h still round-trips through device memory; keeping it on chip
// (fusing (b) and (c)) and moving to wgmma/TMA are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

enum Epilogue : int { EPI_BIAS_GELU = 0, EPI_BIAS_SCALE_RESIDUAL = 1 };

// Output element (m, n) of the product `acc`; bias/gamma are (N,), res (M, N).
template <int EPI, typename T>
__device__ __forceinline__ void store_epilogue(float acc, int64_t m, int n,
                                               int N, const T* bias,
                                               const T* res, const T* gamma,
                                               T* out) {
  const float v = acc + ic_to_f32<T>(bias[n]);
  const int64_t idx = m * N + n;
  if constexpr (EPI == EPI_BIAS_GELU) {
    out[idx] = ic_from_f32<T>(ic_gelu_erf_as(v));
  } else {
    out[idx] =
        ic_from_f32<T>(ic_to_f32<T>(res[idx]) + ic_to_f32<T>(gamma[n]) * v);
  }
}

// ---------------------------------------------------------------- (a) LN rows
constexpr int LN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ s,
               const T* __restrict__ t, T* __restrict__ out, int64_t M, int C,
               float eps) {
  const int64_t row =
      (int64_t)blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + row * C;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = ic_to_f32<T>(xr[c]);
    sum += v;
    sq += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / C;
  const float var = fmaxf(sq / C - mu * mu, 0.0f);
  const float r = rsqrtf(var + eps);
  T* orow = out + row * C;
  for (int c = lane; c < C; c += 32) {
    const float z = (ic_to_f32<T>(xr[c]) - mu) * r;
    orow[c] = ic_from_f32<T>(z * ic_to_f32<T>(s[c]) + ic_to_f32<T>(t[c]));
  }
}

// ----------------------------------------------- (b), (c) bf16 WMMA GEMM
// out[M, N] = epilogue(A[M, K] @ B[N, K]^T); K % 8 == 0, 16-byte aligned rows.
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;           // smem row pitch in bf16 (80 bytes)
constexpr int GEMM_THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int WM = 32, WN = 64;       // warp tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int CHUNKS = BM * BK / 8 / GEMM_THREADS;  // 16-byte loads a thread

__device__ __forceinline__ void load_tile_regs(const __nv_bfloat16* src,
                                               int64_t rows, int K,
                                               int64_t row0, int k0,
                                               uint4 (&regs)[CHUNKS]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int idx = threadIdx.x + i * GEMM_THREADS;
    const int r = idx / (BK / 8);
    const int kc = (idx % (BK / 8)) * 8;
    const int64_t gr = row0 + r;
    if (gr < rows && k0 + kc < K) {
      regs[i] = *reinterpret_cast<const uint4*>(src + gr * K + k0 + kc);
    } else {
      regs[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void store_tile_smem(__nv_bfloat16* tile,
                                                const uint4 (&regs)[CHUNKS]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int idx = threadIdx.x + i * GEMM_THREADS;
    const int r = idx / (BK / 8);
    const int kc = (idx % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(tile + r * LDS + kc) = regs[i];
  }
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_wmma_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ B,
                      const __nv_bfloat16* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ res,
                      const __nv_bfloat16* __restrict__ gamma,
                      __nv_bfloat16* __restrict__ out, int64_t M, int N,
                      int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDS];
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
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile_smem(As, ra);
    store_tile_smem(Bs, rb);
    __syncthreads();
    if (k0 + BK < K) {  // prefetch the next k-tile while this one multiplies
      load_tile_regs(A, M, K, m0, k0 + BK, ra);
      load_tile_regs(B, N, K, n0, k0 + BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * WN + j * 16) * LDS + kk, LDS);
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
      if (m < M) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (nb + v < N)
            store_epilogue<EPI>(scratch[r * 16 + cc + v], m, nb + v, N, bias,
                                res, gamma, out);
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------ (b), (c) f32 FMA GEMM
constexpr int FBM = 64, FBN = 64, FBK = 16, F_THREADS = 256;

template <int EPI>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ bias,
                    const float* __restrict__ res,
                    const float* __restrict__ gamma, float* __restrict__ out,
                    int64_t M, int N, int K) {
  __shared__ float As[FBK][FBM + 1];
  __shared__ float Bs[FBK][FBN + 1];
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  const int64_t m0 = (int64_t)blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int idx = threadIdx.x; idx < FBM * FBK; idx += F_THREADS) {
      const int rr = idx / FBK, kk = idx % FBK;
      const int64_t gm = m0 + rr;
      const int gn = n0 + rr;
      const bool kin = k0 + kk < K;
      As[kk][rr] = (gm < M && kin) ? A[gm * K + k0 + kk] : 0.0f;
      Bs[kk][rr] = (gn < N && kin) ? B[(int64_t)gn * K + k0 + kk] : 0.0f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        store_epilogue<EPI>(acc[i][j], m, n, N, bias, res, gamma, out);
    }
  }
}

template <typename T>
cudaError_t launch_ln(const void* x, const void* s, const void* t, void* out,
                      int64_t M, int C, float eps, cudaStream_t st) {
  const int64_t blocks = (M + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  ln_rows_kernel<T><<<(unsigned)blocks, LN_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(t), static_cast<T*>(out), M, C, eps);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(int dtype, const void* A, const void* B,
                        const void* bias, const void* res, const void* gamma,
                        void* out, int64_t M, int N, int K, cudaStream_t st) {
  if (dtype == IC_BF16) {
    const dim3 grid((N + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
    using bf = __nv_bfloat16;
    gemm_bf16_wmma_kernel<EPI><<<grid, GEMM_THREADS, 0, st>>>(
        static_cast<const bf*>(A), static_cast<const bf*>(B),
        static_cast<const bf*>(bias), static_cast<const bf*>(res),
        static_cast<const bf*>(gamma), static_cast<bf*>(out), M, N, K);
  } else {
    const dim3 grid((N + FBN - 1) / FBN, (unsigned)((M + FBM - 1) / FBM));
    gemm_f32_fma_kernel<EPI><<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(bias), static_cast<const float*>(res),
        static_cast<const float*>(gamma), static_cast<float*>(out), M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous and of one dtype. x, res, xhat, y: (M, C);
// s, t, b2, g: (C,); w1: (H4, C); b1: (H4,); w2: (C, H4); h: (M, H4).
// xhat and h are scratch the caller allocates.
extern "C" int ic_block_mlp_fwd(const void* x, const void* res, const void* s,
                                const void* t, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* g,
                                void* xhat, void* h, void* y, int64_t M, int C,
                                int H4, float eps, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != IC_F32 && dtype != IC_BF16) return cudaErrorInvalidValue;
  cudaError_t err =
      dtype == IC_BF16
          ? launch_ln<__nv_bfloat16>(x, s, t, xhat, M, C, eps, st)
          : launch_ln<float>(x, s, t, xhat, M, C, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS_GELU>(dtype, xhat, w1, b1, nullptr, nullptr, h, M,
                                   H4, C, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS_SCALE_RESIDUAL>(dtype, h, w2, b2, res, g, y, M,
                                              C, H4, st);
}
