// ConvNeXt block tail, the bf16 backward on Hopper: the nine gradients of
// y = res + g * (GELU(LN(x) @ W1^T + b1) @ W2^T + b2) from x, the saved
// a = fc1 output and u = fc2 output, and dy.
//
// Replaces: image_classification_tpu/ops/block_mlp.py:_block_mlp_bwd (body
// _bwd_kernel, the fused backward Pallas kernel) for bf16 tensors. The f32
// backward, which the exact checks use, stays in block_mlp.cu.
//
// What bounds it on the H100: four matrix products of 2 * M * C * 4C FLOP
// each (dh = du @ W2, dxhat = da @ W1, dW1 = da^T @ xhat, dW2 = du^T @ h),
// 32 * M * C^2 FLOP in all, and ~20 * M * C bytes of bf16 and f32 rows. At
// C = 128 the bytes set the pace; from C = 256 the tensor cores do.
//
// What the design does about it. Seven launches on one stream, in the order
// of _bwd_kernel:
//   (a) prep rows: xhat = LN(x) * s + t and du = dy * g, both rounded to bf16
//       (the products' operands); f32 column partials of du (db2) and of
//       dy * u (dg);
//   (b) dh = du @ W2 on the GEMM core; epilogue: da = dh * gelu'(a) and
//       h = GELU(a), both rounded, and f32 column partials of the unrounded
//       da (db1). h is stored so that dW2 is a plain product;
//   (c) dxhat = da @ W1 on the GEMM core, stored in f32;
//   (d) LN backward rows: dx = r * (dz - mean(dz) - z * mean(dz z)) with
//       dz = dxhat * s and the statistics recomputed from x; f32 column
//       partials of dxhat * z (ds) and dxhat (dt);
//   (e) dW1 = da^T @ xhat and (f) dW2 = du^T @ h on the GEMM core, K = M
//       split over a fixed number of blocks into f32 partials;
//   (g) one pass that sums every set of partials in a fixed order and writes
//       the seven weight and affine gradients outright.
// Hopper's blocks run in no order, so the TPU kernel's grid-carried f32 sums
// become partials plus that pass: no float atomics, so two runs give the
// same bits. Rows past M load as zeros and add nothing to any sum.
//
// The GEMM core (wgmma_gemm.cuh, shared with the forward in block_mlp.cu)
// reads the activations dh and dxhat take as A K-major (stored (rows, K)),
// and every other operand MN-major through the descriptor's transpose bit:
// the weights in nn.Linear's (out, in) layout as B, and da, du as A of the
// weight gradients (stored (K = rows, M)).
#include <stdint.h>

#include "common.cuh"
#include "packed_rows.cuh"
#include "wgmma_gemm.cuh"

namespace {

// ------------------------------------------------------------ the epilogues
// GELU(a) and GELU'(a) by the formulas of ic_gelu_erf_as and ic_gelu_grad_as
// (common.cuh), sharing one exp and one reciprocal, on the fast intrinsics:
// the dh epilogue takes both for 4 * M * C elements, which would otherwise
// keep the special-function units busier than the memory.
__device__ __forceinline__ void gelu_and_grad(float a, float& gelu, float& grad) {
  const float x = a * 0.7071067811865476f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = __expf(-ax * ax);
  float erf = 1.0f - poly * e;
  erf = x < 0.0f ? -erf : (x > 0.0f ? erf : 0.0f);
  gelu = 0.5f * a * (1.0f + erf);
  grad = 0.5f * (1.0f + erf) + a * (0.3989422804014327f * e);
}

// out (f32) = acc, in split blockIdx.z's slab of (splits, M, N).
struct EpiF32 : GemmShape {
  float* out;

  __device__ void operator()(const float (&acc)[64], uint8_t* smem, int64_t m0,
                             int n0) const {
    const float* tile = stage_acc(acc, smem);
    consumer_sync();
    const int cc = threadIdx.x % EPI_COLS, rg = threadIdx.x / EPI_COLS;
    const int n = n0 + 8 * cc;
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int r = rg + i * EPI_ROWS;
      const int64_t m = m0 + r;
      if (m >= M || n >= N) continue;
      // Both halves are read before either is written: the tile is reached
      // through a generic pointer, so a store may not pass a later load.
      const float4* src = reinterpret_cast<const float4*>(tile + r * EPI_LD + 8 * cc);
      const float4 lo = src[0], hi = src[1];
      float4* dst = reinterpret_cast<float4*>(out + ((int64_t)blockIdx.z * M + m) * N + n);
      dst[0] = lo;
      dst[1] = hi;
    }
  }
};

// da = acc * gelu'(a) and h = gelu(a), both rounded, from the saved pre-GELU
// a; the tile's column sums of the unrounded da into row blockIdx.y of
// colsum (row tiles, N). A thread loads its rows of a before the tile is
// read, so all of them are in flight at once.
struct EpiDgelu : GemmShape {
  const bf16* a;
  bf16* da;
  bf16* h;
  float* colsum;

  __device__ void operator()(const float (&acc)[64], uint8_t* smem, int64_t m0,
                             int n0) const {
    float* tile = stage_acc(acc, smem);
    const int cc = threadIdx.x % EPI_COLS, rg = threadIdx.x / EPI_COLS;
    const int n = n0 + 8 * cc;
    uint4 araw[EPI_ROWS_A_THREAD];
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int64_t m = m0 + rg + i * EPI_ROWS;
      araw[i] = m < M && n < N ? *reinterpret_cast<const uint4*>(a + m * N + n)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    consumer_sync();
    float csum[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) csum[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < EPI_ROWS_A_THREAD; ++i) {
      const int r = rg + i * EPI_ROWS;
      const int64_t m = m0 + r;
      if (m >= M || n >= N) continue;
      float dh[8], av[8], dav[8], hv[8];
      tile_row8(tile, r, cc, dh);
      unpack8(araw[i], av);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float grad;
        gelu_and_grad(av[v], hv[v], grad);
        dav[v] = dh[v] * grad;
        csum[v] += dav[v];
      }
      const int64_t idx = m * N + n;
      store8(da + idx, dav);
      store8(h + idx, hv);
    }
    // Column sums of the tile: each row group's, then the groups in order.
    float* red = tile + BM * EPI_LD;
#pragma unroll
    for (int v = 0; v < 8; ++v) red[rg * BN + 8 * cc + v] = csum[v];
    consumer_sync();
    if (threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
      float s = 0.0f;
      for (int g = 0; g < EPI_ROWS; ++g) s += red[g * BN + threadIdx.x];
      colsum[(int64_t)blockIdx.y * N + n0 + threadIdx.x] = s;
    }
  }
};

// ------------------------------------------------------------ row kernels
// The row helpers and their layout are in packed_rows.cuh. A group walks
// its rows U at a time (2 where Q = 1, 1 where Q = 2, which would spill
// with two) and loads every input of those rows, packed, before their
// reductions, so the loads are in flight together. Two blocks fit on an SM,
// and the grid gives each group at least ROW_MIN rows, up to ROW_GRID
// blocks, one wave on 132 SMs: a count that depends on the shape alone, so
// the order of the column sums does not depend on the card.
constexpr int ROW_GRID = 264;
constexpr int ROW_MIN = 4;
constexpr int RED_FLOATS = 4096;          // row groups of a block x C, at most

int row_grid(int64_t M, int C) {
  const int64_t rows = (int64_t)ROW_WARPS * (32 / row_lanes(C)) * ROW_MIN;
  const int64_t need = (M + rows - 1) / rows;
  return (int)(need < ROW_GRID ? need : ROW_GRID);
}

// The block's two column accumulators summed over its row groups in order,
// into row blockIdx.x of the (grid, C) partials p0 and p1.
template <int Q>
__device__ __forceinline__ void block_partials(float (*red)[RED_FLOATS],
                                               const float (&a0)[Q][8],
                                               const float (&a1)[Q][8], int C,
                                               int lanes, int li, int gb, int groups,
                                               float* __restrict__ p0,
                                               float* __restrict__ p1) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int col = 8 * (li + q * lanes);
    if (col < C) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        red[0][gb * C + col + v] = a0[q][v];
        red[1][gb * C + col + v] = a1[q][v];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += ROW_THREADS) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int g = 0; g < groups; ++g) {
      s0 += red[0][g * C + c];
      s1 += red[1][g * C + c];
    }
    p0[(int64_t)blockIdx.x * C + c] = s0;
    p1[(int64_t)blockIdx.x * C + c] = s1;
  }
}

// (a): xhat = bf(z s + t), du = bf(dy g); partials of du (db2) and dy u (dg).
template <int Q, int U>
__global__ void __launch_bounds__(ROW_THREADS, 2)
prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
            const bf16* __restrict__ dy, const bf16* __restrict__ s,
            const bf16* __restrict__ t, const bf16* __restrict__ g,
            bf16* __restrict__ xhat, bf16* __restrict__ du,
            float* __restrict__ p_db2, float* __restrict__ p_dg, int64_t M,
            int C, float eps, int lanes) {
  __shared__ float red[2][RED_FLOATS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gpw = 32 / lanes, li = lane % lanes;
  const int gb = warp * gpw + lane / lanes;
  uint4 sp[Q], tp[Q], gp[Q];
  load_packed<Q>(s, 0, true, C, lanes, li, sp);
  load_packed<Q>(t, 0, true, C, lanes, li, tp);
  load_packed<Q>(g, 0, true, C, lanes, li, gp);
  float a0[Q][8], a1[Q][8];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) a0[q][v] = a1[q][v] = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * ROW_WARPS * gpw;
  for (int64_t base = ((int64_t)blockIdx.x * ROW_WARPS + warp) * gpw + lane / lanes;
       base - lane / lanes < M; base += U * stride) {
    uint4 xr[U][Q], dyr[U][Q], ur[U][Q];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t m = base + j * stride;
      load_packed<Q>(x, m, m < M, C, lanes, li, xr[j]);
      load_packed<Q>(dy, m, m < M, C, lanes, li, dyr[j]);
      load_packed<Q>(u, m, m < M, C, lanes, li, ur[j]);
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
        float sv[8], tv[8], gv[8], dyv[8], uv[8], xh[8], duv[8];
        unpack8(sp[q], sv);
        unpack8(tp[q], tv);
        unpack8(gp[q], gv);
        unpack8(dyr[j][q], dyv);
        unpack8(ur[j][q], uv);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          xh[v] = z[q][v] * sv[v] + tv[v];
          duv[v] = dyv[v] * gv[v];
          a0[q][v] += duv[v];
          a1[q][v] += dyv[v] * uv[v];
        }
        const int64_t i = m * C + col;
        store8(xhat + i, xh);
        store8(du + i, duv);
      }
    }
  }
  block_partials<Q>(red, a0, a1, C, lanes, li, gb, ROW_WARPS * gpw, p_db2, p_dg);
}

// (d): the LayerNorm backward; partials of dxhat z (ds) and dxhat (dt).
template <int Q, int U>
__global__ void __launch_bounds__(ROW_THREADS, 2)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxhat,
              const bf16* __restrict__ s, bf16* __restrict__ dx,
              float* __restrict__ p_ds, float* __restrict__ p_dt, int64_t M,
              int C, float eps, int lanes) {
  __shared__ float red[2][RED_FLOATS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gpw = 32 / lanes, li = lane % lanes;
  const int gb = warp * gpw + lane / lanes;
  uint4 sp[Q];
  load_packed<Q>(s, 0, true, C, lanes, li, sp);
  float a0[Q][8], a1[Q][8];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) a0[q][v] = a1[q][v] = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * ROW_WARPS * gpw;
  for (int64_t base = ((int64_t)blockIdx.x * ROW_WARPS + warp) * gpw + lane / lanes;
       base - lane / lanes < M; base += U * stride) {
    uint4 xr[U][Q];
    float4 dr[U][Q][2];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t m = base + j * stride;
      load_packed<Q>(x, m, m < M, C, lanes, li, xr[j]);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int col = 8 * (li + q * lanes);
        if (m < M && col < C) {
          const float4* p = reinterpret_cast<const float4*>(dxhat + m * C + col);
          dr[j][q][0] = p[0];
          dr[j][q][1] = p[1];
        } else {
          dr[j][q][0] = dr[j][q][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t m = base + j * stride;
      float z[Q][8], dz[Q][8];
      unpack_row<Q>(xr[j], z);
      const float r = row_z<Q>(z, C, lanes, eps);
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float sv[8];
        unpack8(sp[q], sv);
        const float4 lo = dr[j][q][0], hi = dr[j][q][1];
        const float dxh[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          dz[q][v] = dxh[v] * sv[v];   // 0 past C: dxh and sv are 0 there
          s1 += dz[q][v];
          s2 += dz[q][v] * z[q][v];
          a0[q][v] += dxh[v] * z[q][v];
          a1[q][v] += dxh[v];
        }
      }
      const float m1 = group_sum(s1, lanes) / C;
      const float m2 = group_sum(s2, lanes) / C;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int col = 8 * (li + q * lanes);
        if (m >= M || col >= C) continue;
        float out[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) out[v] = r * (dz[q][v] - m1 - z[q][v] * m2);
        store8(dx + m * C + col, out);
      }
    }
  }
  block_partials<Q>(red, a0, a1, C, lanes, li, gb, ROW_WARPS * gpw, p_ds, p_dt);
}

template <int Q, int U>
cudaError_t launch_rows(int grid, const bf16* x, const void* u, const void* dy,
                        const void* s, const void* t, const void* g, void* xhat,
                        void* du, const float* dxhat, void* dx, float* p0,
                        float* p1, int64_t M, int C, float eps, bool prep,
                        cudaStream_t st) {
  const int lanes = row_lanes(C);
  if (prep) {
    prep_kernel<Q, U><<<grid, ROW_THREADS, 0, st>>>(
        x, static_cast<const bf16*>(u), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(s), static_cast<const bf16*>(t),
        static_cast<const bf16*>(g), static_cast<bf16*>(xhat),
        static_cast<bf16*>(du), p0, p1, M, C, eps, lanes);
  } else {
    ln_bwd_kernel<Q, U><<<grid, ROW_THREADS, 0, st>>>(
        x, dxhat, static_cast<const bf16*>(s), static_cast<bf16*>(dx), p0, p1,
        M, C, eps, lanes);
  }
  return cudaGetLastError();
}

cudaError_t launch_rows(int grid, const bf16* x, const void* u, const void* dy,
                        const void* s, const void* t, const void* g, void* xhat,
                        void* du, const float* dxhat, void* dx, float* p0,
                        float* p1, int64_t M, int C, float eps, bool prep,
                        cudaStream_t st) {
  return C <= 256 ? launch_rows<1, 2>(grid, x, u, dy, s, t, g, xhat, du, dxhat,
                                      dx, p0, p1, M, C, eps, prep, st)
                  : launch_rows<2, 1>(grid, x, u, dy, s, t, g, xhat, du, dxhat,
                                      dx, p0, p1, M, C, eps, prep, st);
}

// ------------------------------------------------------------- the last pass
// Each segment sums the rows of its (rows, n) f32 partials, in row order, into
// dst (n): wide segments a column a thread; narrow ones (many rows, few
// columns) 32 columns a block, in 16 row slices added in slice order.
constexpr int SUM_THREADS = 512;
constexpr int SUM_SLICES = 16;
constexpr int MAX_SEGS = 7;

struct Seg {
  const float* src;
  float* dst;
  int rows;
  int n;
  int narrow;
};

struct Segs {
  Seg seg[MAX_SEGS];
  int first_block[MAX_SEGS + 1];
};

__global__ void __launch_bounds__(SUM_THREADS) sum_partials_kernel(const Segs ss) {
  __shared__ float red[SUM_SLICES][32];
  int k = 0;
  while ((int)blockIdx.x >= ss.first_block[k + 1]) ++k;
  const Seg sg = ss.seg[k];
  const int b = blockIdx.x - ss.first_block[k];
  if (!sg.narrow) {
    const int64_t col = (int64_t)b * SUM_THREADS + threadIdx.x;
    if (col >= sg.n) return;
    float s = 0.0f;
    for (int r = 0; r < sg.rows; ++r) s += sg.src[(int64_t)r * sg.n + col];
    sg.dst[col] = s;
    return;
  }
  const int tx = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int col = b * 32 + tx;
  float s = 0.0f;
  if (col < sg.n)
    for (int r = slice; r < sg.rows; r += SUM_SLICES) s += sg.src[(int64_t)r * sg.n + col];
  red[slice][tx] = s;
  __syncthreads();
  if (slice == 0 && col < sg.n) {
    float total = 0.0f;
    for (int i = 0; i < SUM_SLICES; ++i) total += red[i][tx];
    sg.dst[col] = total;
  }
}

// ------------------------------------------------------------------- host
// Splits of a K = M weight-gradient product: at most two blocks on each of
// 132 SMs in all, one wave (a fixed count, so the sums' order does not
// depend on the card), each split a whole number of k-tiles.
constexpr int SPLIT_TARGET_BLOCKS = 264;

struct Split {
  int splits;
  int64_t kchunk;
};

Split weight_grad_split(int I, int J, int64_t K) {
  const int64_t tiles = (int64_t)((I + BM - 1) / BM) * ((J + BN - 1) / BN);
  const int64_t ktiles = (K + BK - 1) / BK;
  int64_t s = SPLIT_TARGET_BLOCKS / tiles;
  if (s > ktiles) s = ktiles;
  if (s < 1) s = 1;
  const int64_t kchunk = ((ktiles + s - 1) / s) * BK;
  return {(int)((K + kchunk - 1) / kchunk), kchunk};
}

// Offsets (in floats) of the backward's f32 scratch.
struct Scratch {
  int grid, row_tiles;
  Split s1, s2;
  int64_t db2, dg, db1, ds, dt, w1, w2, total;
};

Scratch scratch_layout(int64_t M, int C) {
  const int H4 = 4 * C;
  Scratch b;
  b.grid = row_grid(M, C);
  b.row_tiles = (int)((M + BM - 1) / BM);
  b.s1 = weight_grad_split(H4, C, M);
  b.s2 = weight_grad_split(C, H4, M);
  b.db2 = 0;                                          // (grid, C)
  b.dg = b.db2 + (int64_t)b.grid * C;                 // (grid, C)
  b.ds = b.dg + (int64_t)b.grid * C;                  // (grid, C)
  b.dt = b.ds + (int64_t)b.grid * C;                  // (grid, C)
  b.db1 = b.dt + (int64_t)b.grid * C;                 // (row tiles, 4C)
  b.w1 = b.db1 + (int64_t)b.row_tiles * H4;           // (splits1, 4C, C)
  b.w2 = b.w1 + (int64_t)b.s1.splits * H4 * C;        // (splits2, C, 4C)
  b.total = b.w2 + (int64_t)b.s2.splits * C * H4;
  return b;
}

bool shape_ok(int64_t M, int C) {
  return M >= 1 && C >= 8 && C % 8 == 0 && C <= MAX_C &&
         (M + BM - 1) / BM <= 65535;
}

}  // namespace

// Floats of f32 scratch ic_block_mlp_bwd_bf16 needs for these shapes.
extern "C" int64_t ic_block_mlp_bwd_bf16_scratch(int64_t M, int C) {
  return shape_ok(M, C) ? scratch_layout(M, C).total : -1;
}

// bf16, contiguous, 16-byte aligned. Inputs: x, u, dy (M, C); a (M, 4C);
// s, t, g (C,); w1 (4C, C); w2 (C, 4C). Scratch: xhat, du (M, C) and da, h
// (M, 4C) bf16; dxhat (M, C) f32; scratch f32 of the size above. Outputs,
// written outright: dx (M, C) bf16; f32 ds, dt, db2, dg (C,), db1 (4C,), dw1
// (4C, C), dw2 (C, 4C). M >= 1, C a multiple of 8 up to 512.
extern "C" int ic_block_mlp_bwd_bf16(
    const void* x, const void* a, const void* u, const void* s, const void* t,
    const void* w1, const void* w2, const void* g, const void* dy, void* xhat,
    void* du, void* da, void* h, void* dxhat, void* scratch, void* dx, void* ds,
    void* dt, void* dw1, void* db1, void* dw2, void* db2, void* dg, int64_t M,
    int C, float eps, void* stream) {
  if (!shape_ok(M, C)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H4 = 4 * C;
  const Scratch b = scratch_layout(M, C);
  float* f = static_cast<float*>(scratch);
  const bf16* xb = static_cast<const bf16*>(x);

  CUtensorMap dh_a, dh_b, dxh_a, dxh_b, w1_a, w1_b, w2_a, w2_b;
  IC_TRY(make_maps(&dh_a, &dh_b, du, w2, true, false, M, H4, C));
  IC_TRY(make_maps(&dxh_a, &dxh_b, da, w1, true, false, M, C, H4));
  IC_TRY(make_maps(&w1_a, &w1_b, da, xhat, false, false, H4, C, M));
  IC_TRY(make_maps(&w2_a, &w2_b, du, h, false, false, C, H4, M));

  // (a) xhat, du and the partials of db2, dg
  IC_TRY(launch_rows(b.grid, xb, u, dy, s, t, g, xhat, du, nullptr, nullptr,
                     f + b.db2, f + b.dg, M, C, eps, true, st));
  // (b) da = (du @ W2) * gelu'(a), h = gelu(a), partials of db1
  const EpiDgelu dh{{M, H4, C, ((C + BK - 1) / BK) * BK},
                    static_cast<const bf16*>(a), static_cast<bf16*>(da),
                    static_cast<bf16*>(h), f + b.db1};
  IC_TRY((launch_gemm<EpiDgelu, true, false>(dh_a, dh_b, dh, 1, st)));
  // (c) dxhat = da @ W1 in f32
  const EpiF32 dxh{{M, C, H4, ((H4 + BK - 1) / BK) * BK}, static_cast<float*>(dxhat)};
  IC_TRY((launch_gemm<EpiF32, true, false>(dxh_a, dxh_b, dxh, 1, st)));
  // (d) the LayerNorm backward, partials of ds, dt
  IC_TRY(launch_rows(b.grid, xb, nullptr, nullptr, s, nullptr, nullptr, nullptr,
                     nullptr, static_cast<const float*>(dxhat), dx, f + b.ds,
                     f + b.dt, M, C, eps, false, st));
  // (e) dW1 (4C, C) = da^T @ xhat; (f) dW2 (C, 4C) = du^T @ h, split over M
  const EpiF32 gw1{{H4, C, M, b.s1.kchunk}, f + b.w1};
  IC_TRY((launch_gemm<EpiF32, false, false>(w1_a, w1_b, gw1, b.s1.splits, st)));
  const EpiF32 gw2{{C, H4, M, b.s2.kchunk}, f + b.w2};
  IC_TRY((launch_gemm<EpiF32, false, false>(w2_a, w2_b, gw2, b.s2.splits, st)));
  // (g) every gradient from its partials
  const Seg segs[MAX_SEGS] = {
      {f + b.w1, static_cast<float*>(dw1), b.s1.splits, H4 * C, 0},
      {f + b.w2, static_cast<float*>(dw2), b.s2.splits, C * H4, 0},
      {f + b.db1, static_cast<float*>(db1), b.row_tiles, H4, 1},
      {f + b.db2, static_cast<float*>(db2), b.grid, C, 1},
      {f + b.dg, static_cast<float*>(dg), b.grid, C, 1},
      {f + b.ds, static_cast<float*>(ds), b.grid, C, 1},
      {f + b.dt, static_cast<float*>(dt), b.grid, C, 1},
  };
  Segs ss;
  ss.first_block[0] = 0;
  for (int k = 0; k < MAX_SEGS; ++k) {
    ss.seg[k] = segs[k];
    const int per = segs[k].narrow ? 32 : SUM_THREADS;
    ss.first_block[k + 1] = ss.first_block[k] + (segs[k].n + per - 1) / per;
  }
  sum_partials_kernel<<<ss.first_block[MAX_SEGS], SUM_THREADS, 0, st>>>(ss);
  return cudaGetLastError();
}

// Splits over K that ic_block_mlp_gemm makes with split_k: those of the
// backward's weight-gradient products.
extern "C" int ic_block_mlp_gemm_splits(int64_t M, int N, int64_t K) {
  return weight_grad_split((int)M, N, K).splits;
}

// The GEMM core alone, for checks and timing on the card: out f32 = A B with
// A bf16 K-major (stored (M, K)) if a_kmajor, else MN-major (stored (K, M)),
// and B bf16 stored (K, N). Without split_k out is (M, N); with it, K splits
// as in the weight-gradient products and out is (splits, M, N), each split's
// partial product. M, N, K >= 1; N and the contiguous dimension of A
// multiples of 8.
extern "C" int ic_block_mlp_gemm(const void* a, const void* b, void* out,
                                 int a_kmajor, int split_k, int64_t M, int N,
                                 int64_t K, void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < 1 || (M + BM - 1) / BM > 65535 ||
      (a_kmajor ? K % 8 : M % 8))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  IC_TRY(make_maps(&ma, &mb, a, b, a_kmajor != 0, false, M, N, K));
  const Split sp = split_k ? weight_grad_split((int)M, N, K)
                           : Split{1, ((K + BK - 1) / BK) * BK};
  const EpiF32 args{{M, N, K, sp.kchunk}, static_cast<float*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_kmajor ? launch_gemm<EpiF32, true, false>(ma, mb, args, sp.splits, st)
                  : launch_gemm<EpiF32, false, false>(ma, mb, args, sp.splits, st);
}

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
