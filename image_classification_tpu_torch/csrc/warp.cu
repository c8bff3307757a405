// Bilinear warp with reflect-101 borders: the one resampling of the training
// augmentation (RandomResizedCrop + flips + ShiftScaleRotate + distortion,
// composed into one per-pixel source coordinate upstream; RandAugment's
// affine slots after it).
//
// Replaces: image_classification_tpu/ops/warp.py:warp_pallas (body
// _warp_kernel). The TPU kernel builds dense hat matrices and contracts them
// on the MXU, because TPU gathers are near-serial; its (B, W, C*Hp) layout
// and 2048-pixel chunks exist for the MXU and VMEM and are not carried over.
// On Hopper a gather is cheap, so each output pixel reads its four taps.
//
// What bounds it on the H100: device memory, and nearly as much instruction
// issue. Per output pixel it reads 8 bytes of coordinates and writes C
// elements; at V4's 32x60x80x3 -> 32x260x260x3 in bf16 that is 17.3 MB of
// coordinates and 13.0 MB of output against a 0.9 MB source, 9.3 us at
// 3.35 TB/s. But a pixel also takes ~100 instructions (the fold, four hats,
// 4 C taps, 6 C unfused products and sums), ~7 us of issue on 132 SMs.
//
// What the design does about it (the faster of each choice at every launch
// shape the port runs, tools/time_gelu_warp.py --variants):
// - N output pixels a thread, the first at a batch index that is a multiple
//   of N: their coordinates in N / 2 16-byte loads and their N C outputs in
//   C stores of N elements, with the evict-first hint (each byte is touched
//   once). An image's first pixels before such an index (P not a multiple
//   of N) and a ragged last group are taken one at a time;
// - two paths, chosen by the wrapper alone (ops/warp.py:warp_staged). The
//   gather path (N = 2) reads each tap's C elements through the read-only
//   cache (__ldg), one pass of a block each: a 60x80 source stays in L1.
//   The staged path (N = 4) copies the block's image into shared memory
//   once, each pixel padded to 4 channels (8-byte texels in bf16, 16-byte
//   in f32), so a tap is one shared-memory load and ~20 fewer instructions
//   a pixel; its blocks, about one wave of them, each cover a span of the
//   image's outputs. The copy is of the whole image, so it pays only where
//   each block has several images' worth of outputs (V3.1's batch of 128);
// - the reflect-101 fold skips its two fmodf where the coordinate already
//   lies in [0, n - 1], where the fold is the identity.
//
// Rounding points are the Pallas kernel's (it contracts x first): the x-hats
// max(0, 1 - |x - w|) in f32, rounded to the image type; each source row's
// two products summed in f32; the y-hats in f32; one rounding at the end.
// Multiplies and adds are __fmul_rn / __fadd_rn, never contracted into an
// FMA, so the kernel gives the bits of its plain version (ops/warp.py
// warp_reference) on both paths. A tap past the edge has hat 0 and is not
// read.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// Output pixels a thread takes a pass, on each path (the fastest of 1, 2
// and 4 on each, tools/time_gelu_warp.py --variants).
constexpr int GATHER_PIX = 2;
constexpr int STAGED_PIX = 4;

// N elements of T in one word (2 to 16 bytes): a staged texel (N = 4) and a
// thread's packed output.
template <int BYTES>
struct Bits;
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};
template <typename T, int N>
using Word = typename Bits<N * sizeof(T)>::type;

__device__ __forceinline__ uint32_t raw(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t raw(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// v[0..N) as one word, the first element in the lowest bytes.
template <typename T, int N>
__device__ __forceinline__ Word<T, N> pack(const T* v) {
  constexpr int LANES = (N * sizeof(T) + 3) / 4;  // 32-bit lanes
  uint32_t l[LANES];
#pragma unroll
  for (int i = 0; i < LANES; ++i) l[i] = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) l[k * sizeof(T) / 4] |= raw(v[k]) << (k * sizeof(T) % 4 * 8);
  if constexpr (N * sizeof(T) == 2) return static_cast<unsigned short>(l[0]);
  else if constexpr (N * sizeof(T) == 4) return l[0];
  else if constexpr (N * sizeof(T) == 8) return make_uint2(l[0], l[1]);
  else return make_uint4(l[0], l[1], l[2], l[3]);
}

// The first C elements of a 4-element texel, in f32.
template <typename T, int C>
__device__ __forceinline__ void unpack(Word<T, 4> w, float* v) {
  if constexpr (sizeof(T) == 4) {
    const uint32_t l[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __uint_as_float(l[c]);
  } else {
    const uint32_t l[2] = {w.x, w.y};
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = __uint_as_float(c & 1 ? l[c >> 1] & 0xFFFF0000u : l[c >> 1] << 16);
  }
}

// jnp.mod(c, 2n - 2) then the reflect-101 fold into [0, n - 1], in f32.
__device__ __forceinline__ float reflect101(float c, int n) {
  if (n == 1) return 0.0f;
  if (c >= 0.0f && c <= static_cast<float>(n - 1)) return c;  // the identity
  const float period = static_cast<float>(2 * n - 2);
  float m = fmodf(c, period);  // exact
  if (m < 0.0f) m = __fadd_rn(m, period);
  return m > static_cast<float>(n - 1) ? __fsub_rn(period, m) : m;
}

__device__ __forceinline__ float hat(float c, float w) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, w))));
}

// Where a block reads its image: shared-memory texels (STAGED) or the image
// in device memory.
template <typename T, int C, bool STAGED>
struct Source {
  const T* img;            // image b, (H, W, C)
  const Word<T, 4>* tex;   // image b, (H, W) texels
  __device__ __forceinline__ void tap(int i, float* v) const {
    if constexpr (STAGED) {
      unpack<T, C>(tex[i], v);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = ic_to_f32<T>(__ldg(img + i * C + c));
    }
  }
};

// One output pixel at source coordinate (cy, cx): acc[c] as the Pallas
// kernel rounds it.
template <typename T, int C, bool STAGED>
__device__ __forceinline__ void sample(const Source<T, C, STAGED>& src, int H,
                                       int W, float cy, float cx, float* acc) {
  const float y = reflect101(cy, H);
  const float x = reflect101(cx, W);
  const float y0 = floorf(y), x0 = floorf(x);
  const int iy = static_cast<int>(y0), ix = static_cast<int>(x0);
  const float hx0 = ic_round<T>(hat(x, x0));
  const float hx1 = ic_round<T>(hat(x, x0 + 1.0f));
  const float hy[2] = {hat(y, y0), hat(y, y0 + 1.0f)};
  const bool right = ix + 1 < W;  // else x = W - 1 and hx1 = 0
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (iy + r >= H) continue;  // y <= H - 1, so this tap's hat is 0
    const int i = (iy + r) * W + ix;
    float v0[C], v1[C];
    src.tap(i, v0);
    if (right) src.tap(i + 1, v1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float t = __fmul_rn(hx0, v0[c]);
      if (right) t = __fadd_rn(t, __fmul_rn(hx1, v1[c]));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hy[r], t));
    }
  }
}

// The image (HW pixels, C elements each) into 4-channel texels. 16-byte
// loads of 8 pixels at a time where the image is 16-byte aligned and HW a
// multiple of 8, else element by element.
template <typename T, int C>
__device__ void stage(const T* __restrict__ img, Word<T, 4>* tex, int HW) {
  if (reinterpret_cast<uintptr_t>(img) % 16 == 0 && HW % 8 == 0) {
    constexpr int WORDS = 8 * C * sizeof(T) / 16;  // 16-byte loads, 8 pixels
    const uint4* src = reinterpret_cast<const uint4*>(img);
    for (int g = threadIdx.x; g < HW / 8; g += THREADS) {
      uint4 w[WORDS];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) w[k] = __ldg(src + g * WORDS + k);
      const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        T v[4] = {};
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = e[p * C + c];
        tex[g * 8 + p] = pack<T, 4>(v);
      }
    }
  } else {
    for (int p = threadIdx.x; p < HW; p += THREADS) {
      T v[4] = {};
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = img[p * C + c];
      tex[p] = pack<T, 4>(v);
    }
  }
}

// Output pixels [q, q + N) of the batch (q a multiple of N where N > 1): N
// coordinates in N / 2 16-byte loads (one 8-byte load for N = 1), and the
// N C outputs in C stores of N elements.
template <typename T, int C, bool STAGED, int N>
__device__ __forceinline__ void warp_pixels(const Source<T, C, STAGED>& src,
                                            const float* __restrict__ coords,
                                            T* __restrict__ out, int H, int W,
                                            int64_t q) {
  float yx[2 * N];
  if constexpr (N == 1) {
    const float2 c = __ldcs(reinterpret_cast<const float2*>(coords) + q);
    yx[0] = c.x;
    yx[1] = c.y;
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float4 c = __ldcs(reinterpret_cast<const float4*>(coords + 2 * q) + k);
      yx[4 * k] = c.x;
      yx[4 * k + 1] = c.y;
      yx[4 * k + 2] = c.z;
      yx[4 * k + 3] = c.w;
    }
  }
  float acc[N * C];
#pragma unroll
  for (int k = 0; k < N; ++k)
    sample<T, C, STAGED>(src, H, W, yx[2 * k], yx[2 * k + 1], acc + k * C);
  T o[N * C];
#pragma unroll
  for (int k = 0; k < N * C; ++k) o[k] = ic_from_f32<T>(acc[k]);
  Word<T, N>* dst = reinterpret_cast<Word<T, N>*>(out + q * C);
#pragma unroll
  for (int w = 0; w < C; ++w) __stcs(dst + w, pack<T, N>(o + N * w));
}

// Block (x, b): pixels [x span, (x + 1) span) of image b's P, in groups of N
// whose first pixel's index in the batch is a multiple of N, after the head
// (the image's first (-b P) mod N pixels, taken one at a time by block 0);
// a ragged last group is taken one pixel at a time too. STAGED: the block
// first copies image b into shared memory.
template <typename T, int C, bool STAGED, int N>
__global__ void __launch_bounds__(THREADS)
    warp_kernel(const T* __restrict__ img, const float* __restrict__ coords,
                T* __restrict__ out, int H, int W, int P, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const Source<T, C, STAGED> src{img + static_cast<int64_t>(b) * H * W * C,
                                 reinterpret_cast<const Word<T, 4>*>(smem)};
  if constexpr (STAGED) {
    stage<T, C>(src.img, reinterpret_cast<Word<T, 4>*>(smem), H * W);
    __syncthreads();
  }
  const int64_t base = static_cast<int64_t>(b) * P;  // image b's first pixel
  const int head = static_cast<int>(min(int64_t{P}, (N - base % N) % N));
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < head)
    warp_pixels<T, C, STAGED, 1>(src, coords, out, H, W, base + threadIdx.x);
  const int p0 = head + static_cast<int>(blockIdx.x) * span;
  const int p1 = min(P, p0 + span);
  for (int p = p0 + N * static_cast<int>(threadIdx.x); p < p1; p += N * THREADS) {
    if (p + N <= P) {
      warp_pixels<T, C, STAGED, N>(src, coords, out, H, W, base + p);
    } else {
      for (int k = p; k < P; ++k)
        warp_pixels<T, C, STAGED, 1>(src, coords, out, H, W, base + k);
    }
  }
}

// Read once a process from the device current at the first launch: sound
// at one device a process, as the port runs (one rank a GPU under torchrun).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// spans: blocks an image (0: the kernel's). Gathering: one pass of a block
// each (N THREADS pixels), as many blocks as that takes. Staged: about one
// wave, as many blocks in all as the card holds at once with the image in
// shared memory, so each image's fill is paid by as few blocks as keep every
// SM busy.
template <typename T, int C, bool STAGED, int N>
int launch_c(const void* img, const void* coords, void* out, int B, int H,
             int W, int P, int spans, cudaStream_t st) {
  const size_t smem = STAGED ? size_t{4} * sizeof(T) * H * W : 0;
  auto kernel = warp_kernel<T, C, STAGED, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int pass = N * THREADS;
  const int passes = (P + pass - 1) / pass;  // an image's, one block each
  if (spans <= 0 && STAGED) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1 || sm_count() < 1) return cudaErrorInvalidConfiguration;
    spans = per_sm * sm_count() / B > 1 ? per_sm * sm_count() / B : 1;
  }
  if (spans <= 0 || spans > passes) spans = passes;
  const int span = ((P + spans - 1) / spans + N - 1) / N * N;
  const dim3 grid((P + span - 1) / span, B);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(img),
                                      static_cast<const float*>(coords),
                                      static_cast<T*>(out), H, W, P, span);
  return cudaGetLastError();
}

template <typename T, bool STAGED, int N>
int launch(const void* img, const void* coords, void* out, int B, int H, int W,
           int C, int P, int spans, cudaStream_t st) {
  switch (C) {
    case 1:
      return launch_c<T, 1, STAGED, N>(img, coords, out, B, H, W, P, spans, st);
    case 2:
      return launch_c<T, 2, STAGED, N>(img, coords, out, B, H, W, P, spans, st);
    case 3:
      return launch_c<T, 3, STAGED, N>(img, coords, out, B, H, W, P, spans, st);
    case 4:
      return launch_c<T, 4, STAGED, N>(img, coords, out, B, H, W, P, spans, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int NG = GATHER_PIX, int NS = STAGED_PIX>
int launch_path(const void* img, const void* coords, void* out, int B, int H,
                int W, int C, int P, int staged, int spans, cudaStream_t st) {
  return staged ? launch<T, true, NS>(img, coords, out, B, H, W, C, P, spans, st)
                : launch<T, false, NG>(img, coords, out, B, H, W, C, P, spans, st);
}

}  // namespace

// img (B, H, W, C) of the dtype's type, coords (B, P, 2) f32 [y, x] 16-byte
// aligned, out (B, P, C); all contiguous. P = Ho * Wo, C in 1..4. staged: 1
// stages each image in shared memory (4 H W element-sizes of it, which the
// caller has checked against its limit), 0 gathers from device memory.
extern "C" int ic_warp(const void* img, const void* coords, void* out, int B,
                       int H, int W, int C, int P, int dtype, int staged,
                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || P < 1 || C < 1 || C > 4 ||
      int64_t{H} * W * C > INT32_MAX || int64_t{P} * C > INT32_MAX ||
      reinterpret_cast<uintptr_t>(coords) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case IC_F32:
      return launch_path<float>(img, coords, out, B, H, W, C, P, staged, 0, st);
    case IC_BF16:
      return launch_path<__nv_bfloat16>(img, coords, out, B, H, W, C, P, staged,
                                        0, st);
    default:
      return cudaErrorInvalidValue;
  }
}
