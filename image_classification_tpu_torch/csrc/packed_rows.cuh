// Row helpers of the block tail's bf16 row passes, shared by its forward
// (block_mlp.cu: the LayerNorm) and its backward (block_mlp_bwd.cu: prep and
// the LayerNorm backward), and 16-byte packing of 8 bf16 values.
//
// A group of `lanes` lanes (8, 16 or 32) takes one row; lane i holds the
// 8-column chunks i + q lanes, q < Q (C <= 512 = 32 lanes x 2 chunks x 8;
// Q = 1 up to C = 256, which halves the registers a thread holds).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int MAX_C = 512;                // ops/block_mlp.py MAX_FUSED_C

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

inline int row_lanes(int C) {
  const int chunks = C / 8;
  int lanes = 8;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Replaces a row of x, unpacked into xv (zeros past C), by z = (x - mean) * r
// and returns r = rsqrt(var + eps): f32 mean and E[x^2] - mean^2 variance
// (the TPU kernel's _norm_stats). Every lane of the warp calls it.
template <int Q>
__device__ __forceinline__ float row_z(float (&xv)[Q][8], int C, int lanes,
                                       float eps) {
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      sum += xv[q][v];
      sq += xv[q][v] * xv[q][v];
    }
  sum = group_sum(sum, lanes);
  sq = group_sum(sq, lanes);
  const float mu = sum / C;
  const float r = rsqrtf(fmaxf(sq / C - mu * mu, 0.0f) + eps);
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) xv[q][v] = (xv[q][v] - mu) * r;
  return r;
}

// The lane's chunks of row m of a (rows, C) bf16 tensor, packed; zeros past
// C or where !ok.
template <int Q>
__device__ __forceinline__ void load_packed(const __nv_bfloat16* __restrict__ p,
                                            int64_t m, bool ok, int C, int lanes,
                                            int li, uint4 (&v)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int col = 8 * (li + q * lanes);
    v[q] = ok && col < C ? *reinterpret_cast<const uint4*>(p + m * C + col)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int Q>
__device__ __forceinline__ void unpack_row(const uint4 (&raw)[Q], float (&v)[Q][8]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) unpack8(raw[q], v[q]);
}

}  // namespace
