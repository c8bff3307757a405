// Exact GELU forward with the Abramowitz & Stegun 7.1.26 erf, elementwise.
//
// Replaces: image_classification_tpu/ops/gelu.py:_run_elementwise with
// _gelu_fwd_kernel (via _gelu_pallas_fwd). The TPU kernel walks (8, 128)
// tiles through VMEM; here the tensor is one flat array.
//
// What bounds it on the H100: device memory, closely followed by
// instruction issue. An element is read once and written once (4 bytes in
// bf16, 8 in f32); the A&S formula is ~14 FP32 instructions and two MUFU
// ones an element, so at 3.35 TB/s the issue time is over half the byte
// time, and an IEEE-rounded reciprocal (a Newton sequence, ~8 more
// instructions) or a sign select on top no longer hides behind the bytes
// (tools/time_gelu_warp.py --variants: __frcp_rn costs 5-20%).
//
// What the design does about it:
// - the formula in as few instructions as its bounds allow (gelu_as):
//   rcp.approx and ex2.approx (as Triton's tl.exp), Horner on FMAs, no
//   sign select;
// - 16-byte loads and stores (8 bf16 or 4 f32 elements a thread an
//   iteration), a scalar head up to the first 16-byte boundary of x and a
//   scalar tail for the last n % 8 (or n % 4); where x and y are not aligned
//   alike, every element takes the scalar path;
// - where x and y together outgrow three quarters of L2, one grid-stride
//   pass of a vector a thread with the evict-first hint (__ldcs / __stcs):
//   nothing of them is read again from L2. Where they fit, x may come from
//   L2 and y be read from it next: as many blocks as the card holds at once
//   walk the array by grid stride, with the default cache policy. Measured
//   both ways at every shape the port runs, each choice was the faster
//   (the persistent grid 7-10% slower on the large arrays, the hints up to
//   24% slower on the small ones; 2 to 8 loads in flight a thread were no
//   faster than one on either grid's better shapes).
//
// Arithmetic (f32, the plain version's formula, ops/gelu.py:gelu_f32):
// within 1 bf16 ulp of the plain version, and ~1e-7 relative in f32.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 1;  // 16-byte loads a thread an iteration (variants: 2-8)

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// gelu(a) = a / 2 (1 + erf(x)), x = a / sqrt(2), with erf(x) = sign(x) E and
// E = 1 - t poly(t) exp(-x^2), t = 1 / (1 + p |x|) >= 0: written as
// a / 2 + |a| / 2 E, it needs neither the sign nor a select (erf(0) = 0
// holds: |a| / 2 = 0). EXACT: the reciprocal rounded as IEEE division
// rounds it (__frcp_rn, a Newton sequence, timed as a variant); else one
// rcp.approx (the kernel's: within 1 ulp, and ~8 fewer instructions).
template <bool EXACT = false>
__device__ __forceinline__ float gelu_as(float a) {
  const float ax = fabsf(a * 0.7071067811865476f);
  const float d = fmaf(0.3275911f, ax, 1.0f);
  const float t = EXACT ? __frcp_rn(d) : rcp_approx(d);
  float poly = fmaf(t, 1.061405429f, -1.453152027f);
  poly = fmaf(t, poly, 1.421413741f);
  poly = fmaf(t, poly, -0.284496736f);
  poly = fmaf(t, poly, 0.254829592f);
  // exp(-x^2) = 2^(-x^2 log2(e))
  const float e = ex2_approx(ax * (ax * -1.4426950408889634f));
  const float big_e = fmaf(-poly, t * e, 1.0f);
  const float h = 0.5f * a;
  return fmaf(fabsf(h), big_e, h);
}

// 16 bytes of T through the formula.
template <typename T, bool EXACT>
struct GeluVec;

template <bool EXACT>
struct GeluVec<float, EXACT> {
  static __device__ __forceinline__ uint4 apply(uint4 v) {
    return make_uint4(__float_as_uint(gelu_as<EXACT>(__uint_as_float(v.x))),
                      __float_as_uint(gelu_as<EXACT>(__uint_as_float(v.y))),
                      __float_as_uint(gelu_as<EXACT>(__uint_as_float(v.z))),
                      __float_as_uint(gelu_as<EXACT>(__uint_as_float(v.w))));
  }
};

template <bool EXACT>
struct GeluVec<__nv_bfloat16, EXACT> {
  static __device__ __forceinline__ uint32_t pair(uint32_t w) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(gelu_as<EXACT>(f.x), gelu_as<EXACT>(f.y));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  static __device__ __forceinline__ uint4 apply(uint4 v) {
    return make_uint4(pair(v.x), pair(v.y), pair(v.z), pair(v.w));
  }
};

// STREAM: the evict-first hint on both streams (the kernel's); else plain
// loads and stores (timed as a variant).
template <bool STREAM>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  return STREAM ? __ldcs(p) : *p;
}
template <bool STREAM>
__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  if (STREAM) __stcs(p, v); else *p = v;
}

// Vectors [0, nvec) of x + head by grid stride, UNROLL loads in flight; then
// the scalar elements [0, head) and [head + nvec * VEC, n).
template <typename T, int U, bool STREAM, bool EXACT>
__global__ void __launch_bounds__(THREADS)
    gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t head,
                    int64_t nvec, int64_t n) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t i = first;
  for (; i + (U - 1) * stride < nvec; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load16<STREAM>(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u)
      store16<STREAM>(yv + i + u * stride, GeluVec<T, EXACT>::apply(v[u]));
  }
  for (; i < nvec; i += stride)
    store16<STREAM>(yv + i, GeluVec<T, EXACT>::apply(load16<STREAM>(xv + i)));
  const int64_t tail = head + nvec * VEC;
  for (int64_t s = first; s < head + (n - tail); s += stride) {
    const int64_t e = s < head ? s : tail + (s - head);
    y[e] = ic_from_f32<T>(gelu_as<EXACT>(ic_to_f32<T>(x[e])));
  }
}

// Blocks of the kernel resident on the card at once, and the card's L2 size,
// each read once a process from the device current at the first launch:
// sound at one device a process, as the port runs (one rank a GPU under
// torchrun).
template <typename T, int U, bool STREAM, bool EXACT>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gelu_fwd_kernel<T, U, STREAM, EXACT>, THREADS, 0) != cudaSuccess)
      return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

int64_t l2_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev) != cudaSuccess)
      bytes = -1;
  }
  return bytes;
}

// One launch over n elements on `blocks` blocks (0: as many as are resident
// at once, the kernel's; never more than the work needs).
template <typename T, int U = UNROLL, bool STREAM = true, bool EXACT = false>
int launch_gelu_fwd(const void* x, void* y, int64_t n, int blocks,
                    cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  int64_t head = n;  // no common alignment: every element is scalar
  if ((xa - ya) % 16 == 0) {
    head = static_cast<int64_t>((16 - xa % 16) % 16 / sizeof(T));
    if (head > n) head = n;
  }
  const int64_t nvec = (n - head) / VEC;
  const int64_t scalars = n - nvec * VEC;
  const int64_t want = ((nvec > scalars ? nvec : scalars) + THREADS - 1) / THREADS;
  if (blocks <= 0) blocks = resident_blocks<T, U, STREAM, EXACT>();
  if (blocks <= 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorUnknown;
  }
  if (want < blocks) blocks = static_cast<int>(want);
  gelu_fwd_kernel<T, U, STREAM, EXACT><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), head, nvec, n);
  return cudaGetLastError();
}

// x, y (n,) of T, contiguous. Where x and y together outgrow three quarters
// of L2, little of them is read again from it: one grid-stride pass (a
// vector a thread) with the evict-first hint. Where they fit, x may come from
// L2 (its producer just wrote it) and y may be read from it next: a grid of
// resident blocks, the default policy. (On the H100, 50 MiB of L2, the
// measured crossover lies between 32 MB and 51 MB of x and y.)
template <typename T>
int gelu_fwd(const void* x, void* y, int64_t n, cudaStream_t st) {
  if (4 * 2 * n * static_cast<int64_t>(sizeof(T)) > 3 * l2_bytes())
    return launch_gelu_fwd<T, UNROLL, true, false>(x, y, n, INT32_MAX, st);
  return launch_gelu_fwd<T, UNROLL, false, false>(x, y, n, 0, st);
}

}  // namespace

// x, y (n,) of the dtype's type, contiguous. y = gelu(x) with f32 internals.
extern "C" int ic_gelu_fwd(const void* x, void* y, int64_t n, int dtype,
                           void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case IC_F32:
      return gelu_fwd<float>(x, y, n, st);
    case IC_BF16:
      return gelu_fwd<__nv_bfloat16>(x, y, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
