// 7x7 depthwise convolution, SAME padding, no bias, channels-last (NHWC).
//
// Replaces: image_classification_tpu/ops/dwconv.py:_conv_same_pallas and its
// body _fwd_kernel (the forward Pallas stencil; the backward kernels
// _bwd_kernel and _dw_kernel are not ported yet).
//
// What bounds it on the H100: device memory. Each output element costs 49
// FMAs and, ideally, one read of x and one write of y, so at bf16 the kernel
// does about 25 FLOP per byte moved, far below the ~295 the card needs before
// arithmetic becomes the limit. The danger is reading x 49 times.
//
// What the design does about it: one block owns an 8x8 tile of output pixels
// for 32 channels of one image. It stages the 14x14 input tile (the halo of 3
// on each side, zero outside the image) and the 49 taps for its 32 channels
// in shared memory as f32, so every x element leaves device memory about
// (14*14)/(8*8) = 3 times at worst, from L2 for the overlap. Threads run along
// the channels, so global loads and stores of a pixel's channels coalesce and
// shared-memory reads hit 32 distinct banks; where C allows, the tile is
// filled with 16-byte loads (8 bf16 or 4 f32 channels a thread). Each thread
// accumulates the 49 taps in f32 for 8 output pixels of one row, reusing each
// loaded input row across the 7 horizontal taps.
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dwconv7x7_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int H, int W, int C, int tiles_w) {
  // +1 column of padding keeps the 16-byte fill free of bank conflicts.
  __shared__ float xs[IH * IW][CB + 1];
  __shared__ float ws[KS * KS][CB];

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CB;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)b * H * W * C;

  for (int i = tid; i < KS * KS * CB; i += THREADS) {
    const int k = i / CB, c = i % CB;
    ws[k][c] = (c0 + c < C) ? ic_to_f32<T>(w[(size_t)k * C + c0 + c]) : 0.0f;
  }

  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);   // channels per 16-byte load
    constexpr int GROUPS = CB / V;      // loads per staged pixel
    for (int i = tid; i < IH * IW * GROUPS; i += THREADS) {
      const int p = i / GROUPS, g = i % GROUPS;
      const int ih = h0 - PAD + p / IW, iw = w0 - PAD + p % IW;
      const int c = c0 + g * V;
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
      for (int v = 0; v < V; ++v) xs[p][g * V + v] = vals[v];
    }
  } else {
    for (int i = tid; i < IH * IW * CB; i += THREADS) {
      const int p = i / CB, cc = i % CB;
      const int ih = h0 - PAD + p / IW, iw = w0 - PAD + p % IW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W && c0 + cc < C;
      xs[p][cc] =
          in ? ic_to_f32<T>(xb[((size_t)ih * W + iw) * C + c0 + cc]) : 0.0f;
    }
  }
  __syncthreads();

  const int c = tid % CB;
  const int r = tid / CB;
  float acc[TW];
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

  const int oh = h0 + r;
  if (oh >= H || c0 + c >= C) return;
  T* yrow = y + ((size_t)b * H + oh) * W * C + c0 + c;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    if (w0 + j < W) yrow[(size_t)(w0 + j) * C] = ic_from_f32<T>(acc[j]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int H, int W,
                   int C, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (C + CB - 1) / CB, B);
  const bool vec = (C % (16 / sizeof(T)) == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (vec) {
    dwconv7x7_fwd_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        H, W, C, tiles_w);
  } else {
    dwconv7x7_fwd_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        H, W, C, tiles_w);
  }
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) and w (7, 7, C) contiguous, of one dtype; y like x.
extern "C" int ic_dwconv7x7_fwd(const void* x, const void* w, void* y, int B,
                                int H, int W, int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case IC_F32:
      return launch<float>(x, w, y, B, H, W, C, st);
    case IC_BF16:
      return launch<__nv_bfloat16>(x, w, y, B, H, W, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
