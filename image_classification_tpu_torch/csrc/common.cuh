// Shared helpers for the port's CUDA kernels: dtype codes and f32 <-> storage
// conversions. Every kernel reads its storage type, computes in f32, and
// writes its storage type, as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Must match image_classification_tpu_torch/ops/_build.py DTYPE_CODES.
enum IcDtype : int { IC_F32 = 0, IC_BF16 = 1 };

template <typename T>
__device__ __forceinline__ float ic_to_f32(T v);
template <>
__device__ __forceinline__ float ic_to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float ic_to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T ic_from_f32(float v);
template <>
__device__ __forceinline__ float ic_from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 ic_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the storage type T and back (the identity for f32).
template <typename T>
__device__ __forceinline__ float ic_round(float v) {
  return ic_to_f32<T>(ic_from_f32<T>(v));
}

// Exact GELU with the Abramowitz & Stegun 7.1.26 erf (one exp, a 5-term
// polynomial, |err| <= 1.5e-7): the formula of ops/block_mlp.py:_gelu_exact
// in the JAX package and of ops/gelu.py in the port.
__device__ __forceinline__ float ic_gelu_erf_as(float a) {
  const float x = a * 0.7071067811865476f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float erf = 1.0f - poly * expf(-ax * ax);
  erf = x < 0.0f ? -erf : (x > 0.0f ? erf : 0.0f);
  return 0.5f * a * (1.0f + erf);
}

// d/da of ic_gelu_erf_as with one exp: erf's exp(-x^2) at x = a / sqrt(2) is
// the Gaussian pdf's exp(-a^2 / 2) (ops/block_mlp.py:_gelu_grad in the JAX
// package).
__device__ __forceinline__ float ic_gelu_grad_as(float a) {
  const float x = a * 0.7071067811865476f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = expf(-ax * ax);
  float erf = 1.0f - poly * e;
  erf = x < 0.0f ? -erf : (x > 0.0f ? erf : 0.0f);
  return 0.5f * (1.0f + erf) + a * (0.3989422804014327f * e);
}
