// Bilinear warp with reflect-101 borders: the one resampling of the training
// augmentation (RandomResizedCrop + flips + ShiftScaleRotate + distortion,
// composed into one per-pixel source coordinate upstream).
//
// Replaces: image_classification_tpu/ops/warp.py:warp_pallas (body
// _warp_kernel). The TPU kernel builds dense hat matrices and contracts them
// on the MXU, because TPU gathers are near-serial; its (B, W, C*Hp) layout
// and 2048-pixel chunks exist for the MXU and VMEM and are not carried over.
// On Hopper a gather is cheap, so each output pixel reads its four taps.
//
// What bounds it on the H100: device memory. Per output pixel it reads 8
// bytes of coordinates and writes C elements, against ~30 FLOP; at V4's
// 32x60x80x3 -> 32x260x260x3 in bf16 that is 17.3 MB of coordinates and
// 13.0 MB of output against a 0.9 MB source.
//
// What the design does about it: one thread per output pixel computes all C
// channels. Coordinates are read once as one float2 each, coalesced; the
// source is read through the read-only cache (__ldg), where a 60x80x3 image
// (28.8 KB in bf16) stays resident in L1/L2, so device memory sees the
// coordinates and the output and little else. The fold runs in the kernel.
//
// Rounding points are the Pallas kernel's (it contracts x first): the x-hats
// max(0, 1 - |x - w|) in f32, rounded to the image type; each source row's
// two products summed in f32; the y-hats in f32; one rounding at the end.
// Multiplies and adds are __fmul_rn / __fadd_rn, never contracted into an
// FMA, so the kernel gives the bits of its plain version (ops/warp.py
// warp_reference). A tap past the edge has hat 0 and is not read.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// jnp.mod(c, 2n - 2) then the reflect-101 fold into [0, n - 1], in f32.
__device__ __forceinline__ float reflect101(float c, int n) {
  if (n == 1) return 0.0f;
  const float period = static_cast<float>(2 * n - 2);
  float m = fmodf(c, period);  // exact
  if (m < 0.0f) m = __fadd_rn(m, period);
  return m > static_cast<float>(n - 1) ? __fsub_rn(period, m) : m;
}

__device__ __forceinline__ float hat(float c, float w) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, w))));
}

template <typename T>
__device__ __forceinline__ float load(const T* p) {
  return ic_to_f32<T>(__ldg(p));
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    warp_kernel(const T* __restrict__ img, const float2* __restrict__ coords,
                T* __restrict__ out, int H, int W, int P) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const float2 yx = __ldg(coords + b * P + p);
  const float y = reflect101(yx.x, H);
  const float x = reflect101(yx.y, W);
  const float y0 = floorf(y), x0 = floorf(x);
  const int iy = static_cast<int>(y0), ix = static_cast<int>(x0);
  const float hx0 = ic_round<T>(hat(x, x0));
  const float hx1 = ic_round<T>(hat(x, x0 + 1.0f));
  const float hy[2] = {hat(y, y0), hat(y, y0 + 1.0f)};
  const T* src = img + b * H * W * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (iy + r >= H) continue;  // y <= H - 1, so this tap's hat is 0
    const T* row = src + (static_cast<size_t>(iy + r) * W + ix) * C;
    const bool right = ix + 1 < W;  // else x = W - 1 and hx1 = 0
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float t = __fmul_rn(hx0, load(row + c));
      if (right) t = __fadd_rn(t, __fmul_rn(hx1, load(row + C + c)));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hy[r], t));
    }
  }
  T* o = out + (b * P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = ic_from_f32<T>(acc[c]);
}

template <typename T>
int launch(const void* img, const void* coords, void* out, int B, int H,
           int W, int C, int P, cudaStream_t st) {
  const dim3 grid((P + THREADS - 1) / THREADS, B);
  const T* in = static_cast<const T*>(img);
  const float2* yx = static_cast<const float2*>(coords);
  T* o = static_cast<T*>(out);
  switch (C) {
    case 1:
      warp_kernel<T, 1><<<grid, THREADS, 0, st>>>(in, yx, o, H, W, P);
      break;
    case 2:
      warp_kernel<T, 2><<<grid, THREADS, 0, st>>>(in, yx, o, H, W, P);
      break;
    case 3:
      warp_kernel<T, 3><<<grid, THREADS, 0, st>>>(in, yx, o, H, W, P);
      break;
    case 4:
      warp_kernel<T, 4><<<grid, THREADS, 0, st>>>(in, yx, o, H, W, P);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W, C) of the dtype's type, coords (B, P, 2) f32 [y, x] 8-byte
// aligned, out (B, P, C); all contiguous. P = Ho * Wo, C in 1..4.
extern "C" int ic_warp(const void* img, const void* coords, void* out, int B,
                       int H, int W, int C, int P, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || P < 1 || C < 1 || C > 4)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case IC_F32:
      return launch<float>(img, coords, out, B, H, W, C, P, st);
    case IC_BF16:
      return launch<__nv_bfloat16>(img, coords, out, B, H, W, C, P, st);
    default:
      return cudaErrorInvalidValue;
  }
}
