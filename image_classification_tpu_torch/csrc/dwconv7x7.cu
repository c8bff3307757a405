// 7x7 depthwise convolution, SAME padding, no bias, channels-last (NHWC): the
// fused backward, dx and dw in one pass. The forward stencil and the
// wgrad-only backward are in dwconv7x7_fwd_wgrad.cu.
//
// Replaces: image_classification_tpu/ops/dwconv.py:_bwd_pallas (body
// _bwd_kernel), which the JAX package runs where its VMEM estimate of one
// image stays within 16 MiB; past it (stage 0 of ConvNeXt-L at 260 px) both
// packages split the backward into the forward stencil on g with the
// flipped filter (dx) and the wgrad-only kernel (dw).
//
// What bounds it on the H100: the backward reads x and g and writes dx
// (3 * B*H*W*C elements) for 4 * 49 FLOP an element: about 33 FLOP a byte
// in bf16, near the card's balance for FP32 work. The danger is reading the
// inputs 49 times.
//
// What the design does about it: one block owns an 8x8 tile of output pixels
// for 32 channels of one image. It stages the 14x14 tile of g (the halo of 3
// on each side, zero outside the image), the 8x8 tile of x and the 49
// flipped taps for its 32 channels in shared memory as f32, so every element
// leaves device memory about (14*14)/(8*8) = 3 times at worst, from L2 for
// the overlap. Threads run along the channels, so global loads and stores of
// a pixel's channels coalesce and shared-memory reads hit 32 distinct banks;
// where C allows, the tile is filled with 16-byte loads (8 bf16 or 4 f32
// channels a thread). dx is the forward stencil over g with the flipped
// filter: each thread accumulates the 49 taps in f32 for 8 output pixels of
// one row, reusing each loaded row across the 7 horizontal taps. For dw each
// thread keeps the 49 per-tap sums of its (channel, row) in registers:
// dw[i][j] += x[h][w] * g[h - i + 3][w - j + 3] over its 8 pixels, each
// product rounded to the storage type first, as the Pallas kernel multiplies
// its bf16 tiles. The TPU kernel carries dw across its sequential grid;
// Hopper's blocks run in no order, so each block walks a fixed set of tiles,
// sums its 8 rows in a fixed order in shared memory, and writes one f32
// partial (49, 32); a second kernel adds the partials of each (tap, channel)
// in block order. No float atomics: two runs give the same bits. The
// kernel's template keeps a WITH_DX=false form (dw alone), which nothing
// launches: the wgrad-only kernel has its own design.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int KS = 7;
constexpr int PAD = KS / 2;
constexpr int TH = 8;                 // output rows per block
constexpr int TW = 8;                 // output columns per block
constexpr int CB = 32;                // channels per block
constexpr int IH = TH + KS - 1;       // 14 staged input rows
constexpr int IW = TW + KS - 1;       // 14 staged input columns
constexpr int THREADS = CB * TH;      // one thread per (channel, output row)
// The backward aims at this many blocks in all, split between channel
// groups and groups of tiles (a fixed number, so the sums' order and bits
// do not depend on the card).
constexpr int BWD_TARGET_BLOCKS = 1024;

// Stage rows x cols pixels starting at (h_org, w_org) of image xb, channels
// c0..c0+CB, into dst as f32; zero outside the image or past C. The +1
// column of padding in dst keeps the 16-byte fill free of bank conflicts.
template <typename T, bool VEC>
__device__ __forceinline__ void fill_tile(float (*dst)[CB + 1],
                                          const T* __restrict__ xb, int rows,
                                          int cols, int h_org, int w_org,
                                          int H, int W, int C, int c0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);   // channels per 16-byte load
    constexpr int GROUPS = CB / V;      // loads per staged pixel
    for (int i = tid; i < rows * cols * GROUPS; i += THREADS) {
      const int p = i / GROUPS, grp = i % GROUPS;
      const int ih = h_org + p / cols, iw = w_org + p % cols;
      const int c = c0 + grp * V;
      float vals[V];
      if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xb + ((size_t)ih * W + iw) * C + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < V; ++v) vals[v] = ic_to_f32<T>(e[v]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) vals[v] = 0.0f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) dst[p][grp * V + v] = vals[v];
    }
  } else {
    for (int i = tid; i < rows * cols * CB; i += THREADS) {
      const int p = i / CB, cc = i % CB;
      const int ih = h_org + p / cols, iw = w_org + p % cols;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W && c0 + cc < C;
      dst[p][cc] =
          in ? ic_to_f32<T>(xb[((size_t)ih * W + iw) * C + c0 + cc]) : 0.0f;
    }
  }
}

// The 49 taps of channels c0..c0+CB as f32, flipped in both spatial dims
// when FLIP (the backward's dx stencil).
template <typename T, bool FLIP>
__device__ __forceinline__ void fill_taps(float (*ws)[CB],
                                          const T* __restrict__ w, int C,
                                          int c0) {
  for (int i = threadIdx.x; i < KS * KS * CB; i += THREADS) {
    const int k = i / CB, c = i % CB;
    const int src = FLIP ? KS * KS - 1 - k : k;
    ws[k][c] = (c0 + c < C) ? ic_to_f32<T>(w[(size_t)src * C + c0 + c]) : 0.0f;
  }
}

// acc[j] = sum over taps of xs[(r + kh) * IW + j + kw] * ws[kh * KS + kw]
__device__ __forceinline__ void stencil_row(const float (*xs)[CB + 1],
                                            const float (*ws)[CB], int r,
                                            int c, float (&acc)[TW]) {
#pragma unroll
  for (int j = 0; j < TW; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int kh = 0; kh < KS; ++kh) {
    float row[IW];
#pragma unroll
    for (int j = 0; j < IW; ++j) row[j] = xs[(r + kh) * IW + j][c];
#pragma unroll
    for (int kw = 0; kw < KS; ++kw) {
      const float wv = ws[kh * KS + kw][c];
#pragma unroll
      for (int j = 0; j < TW; ++j) acc[j] = fmaf(row[j + kw], wv, acc[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ yb, const float (&acc)[TW],
                                          int oh, int w0, int W, int C, int c) {
  T* yrow = yb + (size_t)oh * W * C + c;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    if (w0 + j < W) yrow[(size_t)(w0 + j) * C] = ic_from_f32<T>(acc[j]);
  }
}

// WITH_DX: the fused backward; without it, the wgrad-only kernel (w and dx
// unused).
template <typename T, bool VEC, bool WITH_DX>
__global__ void __launch_bounds__(THREADS)
dwconv7x7_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ w, T* __restrict__ dx,
                     float* __restrict__ partial, int B, int H, int W, int C,
                     int tiles_w, int tiles) {
  __shared__ float gs[IH * IW][CB + 1];   // g with its halo
  __shared__ float xs[TH * TW][CB + 1];   // x, the tile's centre
  __shared__ float ws[KS * KS][CB];       // flipped taps
  __shared__ float red[KS * KS][CB];      // the block's dw, summed over rows

  const int c0 = blockIdx.y * CB;
  const int c = threadIdx.x % CB;
  const int r = threadIdx.x / CB;
  if constexpr (WITH_DX) fill_taps<T, true>(ws, w, C, c0);

  float dwacc[KS * KS];
#pragma unroll
  for (int k = 0; k < KS * KS; ++k) dwacc[k] = 0.0f;

  for (int tt = blockIdx.x; tt < B * tiles; tt += gridDim.x) {
    const int b = tt / tiles, tile = tt % tiles;
    const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
    const size_t img = (size_t)b * H * W * C;
    __syncthreads();  // the previous tile is done with gs and xs
    fill_tile<T, VEC>(gs, g + img, IH, IW, h0 - PAD, w0 - PAD, H, W, C, c0);
    fill_tile<T, VEC>(xs, x + img, TH, TW, h0, w0, H, W, C, c0);
    __syncthreads();

    if constexpr (WITH_DX) {
      float acc[TW];
      stencil_row(gs, ws, r, c, acc);
      if (h0 + r < H && c0 + c < C)
        store_row(dx + img, acc, h0 + r, w0, W, C, c0 + c);
    }

    float xr[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) xr[j] = xs[r * TW + j][c];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      float grow[IW];
#pragma unroll
      for (int j = 0; j < IW; ++j) grow[j] = gs[(r + KS - 1 - i) * IW + j][c];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int col = 0; col < TW; ++col)
          s += ic_round<T>(xr[col] * grow[col + KS - 1 - j]);
        dwacc[i * KS + j] += s;
      }
    }
  }

  // Sum the 8 rows of each channel in row order, then write the partial.
  for (int rr = 0; rr < TH; ++rr) {
    if (r == rr) {
#pragma unroll
      for (int k = 0; k < KS * KS; ++k)
        red[k][c] = (rr == 0 ? 0.0f : red[k][c]) + dwacc[k];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < KS * KS * CB; i += THREADS) {
    const int k = i / CB, cc = i % CB;
    if (c0 + cc < C)
      partial[((size_t)blockIdx.x * KS * KS + k) * C + c0 + cc] = red[k][cc];
  }
}

// dw[k][c] = sum over groups, in group order, of partial[group][k][c].
__global__ void dw_reduce_kernel(const float* __restrict__ partial, int groups,
                                 int n, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int grp = 0; grp < groups; ++grp) s += partial[(size_t)grp * n + i];
  dw[i] = s;
}

int bwd_groups(int B, int H, int W, int C) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int cgroups = (C + CB - 1) / CB;
  int groups = (BWD_TARGET_BLOCKS + cgroups - 1) / cgroups;
  if (groups > B * tiles) groups = B * tiles;
  return groups < 1 ? 1 : groups;
}

template <typename T>
bool vec_ok(int C, const void* a, const void* b) {
  return (C % (16 / sizeof(T)) == 0) &&
         (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* w, void* dx,
                       float* partial, float* dw, int groups, int B, int H,
                       int W, int C, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  const dim3 grid(groups, (C + CB - 1) / CB);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* wt = static_cast<const T*>(w);
  T* dxt = static_cast<T*>(dx);
  if (vec_ok<T>(C, x, g)) {
    dwconv7x7_bwd_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(
        xt, gt, wt, dxt, partial, B, H, W, C, tiles_w, tiles);
  } else {
    dwconv7x7_bwd_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(
        xt, gt, wt, dxt, partial, B, H, W, C, tiles_w, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = KS * KS * C;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, groups, n, dw);
  return cudaGetLastError();
}

}  // namespace

// Number of tile groups (blocks along the grid's x) of the backward, which
// sizes its f32 scratch `partial`: (groups, 49, C).
extern "C" int ic_dwconv7x7_bwd_groups(int B, int H, int W, int C) {
  return bwd_groups(B, H, W, C);
}

// x, g, dx (B, H, W, C) and w (7, 7, C) contiguous, of one dtype; dw (7, 7, C)
// f32; partial (groups, 49, C) f32 scratch, groups from the function above.
extern "C" int ic_dwconv7x7_bwd(const void* x, const void* g, const void* w,
                                void* dx, void* partial, void* dw, int groups,
                                int B, int H, int W, int C, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups != bwd_groups(B, H, W, C)) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  switch (dtype) {
    case IC_F32:
      return launch_bwd<float>(x, g, w, dx, p, d, groups, B, H, W, C, st);
    case IC_BF16:
      return launch_bwd<__nv_bfloat16>(x, g, w, dx, p, d, groups, B, H, W, C,
                                       st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
