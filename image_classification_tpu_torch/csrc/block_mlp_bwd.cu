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
// The GEMM core: a 128 x 128 output tile a block, K in steps of 64. One
// producer warp issues TMA loads (cp.async.bulk.tensor, 128-byte swizzle)
// into a ring of 3 shared-memory stages guarded by mbarriers; two consumer
// warpgroups, 64 rows each, run wgmma.mma_async m64n128k16 (bf16 in, f32
// accumulators) straight from the swizzled stages and release a stage as
// soon as the wgmma that reads it has retired. No operand is transposed in
// memory: the activations dh and dxhat read as A are K-major (stored
// (rows, K)); every other operand is read MN-major through the
// descriptor's transpose bit: the weights in nn.Linear's (out, in) layout as
// B, and da, du as A of the weight gradients (stored (K = rows, M)). A tile
// of a product is staged in f32 in the freed stages, and the epilogue then
// walks it row by row with 16-byte loads and stores. Two blocks fit on an SM
// (99 KB of shared memory each), so one block's epilogue overlaps the
// other's loads. 64 accumulators a thread fit the register budget without
// setmaxnreg.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ the GEMM core
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;                   // two warpgroups
constexpr int GEMM_THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;           // one TMA box: 64 x 128 bytes
constexpr int TILE_BYTES = 2 * BOX_BYTES;        // 128 x 64 bf16
constexpr int STAGE_BYTES = 2 * TILE_BYTES;      // A and B
constexpr int EPI_LD = BN + 8;                   // f32 pitch of the staged tile
constexpr int EPI_COLS = BN / 8;                 // 8-column chunks of a row
constexpr int EPI_ROWS = CONSUMERS / EPI_COLS;   // rows the epilogue walks at once
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM * EPI_LD * 4 + EPI_ROWS * BN * 4 <= STAGES * STAGE_BYTES,
              "the staged tile and its column sums fit in the stages");

enum Epilogue : int {
  EPI_DGELU = 0,  // da = acc * gelu'(a), h = gelu(a); column partials of da
  EPI_F32 = 1,    // out (f32) = acc, in split blockIdx.z's slab
};

struct GemmArgs {
  int64_t M;        // rows of the output
  int N;            // columns of the output
  int64_t K;
  int64_t kchunk;   // K a split covers, a multiple of BK
  float* out;       // EPI_F32: (splits, M, N)
  const bf16* a;    // EPI_DGELU: the saved pre-GELU a, (M, N)
  bf16* da;         // EPI_DGELU: (M, N)
  bf16* h;          // EPI_DGELU: (M, N)
  float* colsum;    // EPI_DGELU: (row tiles, N)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map at (c0 innermost, c1) into shared memory;
// completes bytes on bar. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128): A K-major (TRANS_A = 0) or
// MN-major (1), B MN-major. d's layout: register 4j + 2i + v of lane l in
// warp w holds row 16w + l/4 + 8i, column 8j + 2(l%4) + v.
template <int TRANS_A>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

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

// out[m, n] = sum over k in this split of A(m, k) B(k, n). The tensor maps
// (bf16, 128-byte swizzle, boxes 64 wide in the contiguous dimension): A
// K-major, stored (M, K), boxes of 128 rows; A MN-major, stored (K, M), and
// B, stored (K, N), boxes of 64 rows. Grid: (N tiles, M tiles, splits).
template <int EPI, bool A_KMAJOR>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const GemmArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t kbeg = (int64_t)blockIdx.z * args.kchunk;
  const int64_t kend = kbeg + args.kchunk < args.K ? kbeg + args.kchunk : args.K;
  const int nk = (int)((kend - kbeg + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t a_s = smem_u32(smem + s * STAGE_BYTES);
        const uint32_t b_s = a_s + TILE_BYTES;
        const int k0 = (int)(kbeg + (int64_t)kt * BK);
        if constexpr (A_KMAJOR) {
          tma_load(a_s, &map_a, bar, k0, (int)m0);
        } else {
          tma_load(a_s, &map_a, bar, (int)m0, k0);
          tma_load(a_s + BOX_BYTES, &map_a, bar, (int)m0 + 64, k0);
        }
        tma_load(b_s, &map_b, bar, n0, k0);
        tma_load(b_s + BOX_BYTES, &map_b, bar, n0 + 64, k0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t a_s = smem_u32(smem + s * STAGE_BYTES) + wg * BOX_BYTES;
    const uint32_t b_s = smem_u32(smem + s * STAGE_BYTES) + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // K-major A: the 16-column slice j of 128-byte rows, 8-row groups 1024
      // bytes apart. MN-major operands: K rows 16j.., 128 bytes a row, 8-row
      // groups 1024 bytes apart, 64-wide MN boxes BOX_BYTES apart.
      const uint64_t da = A_KMAJOR ? gmma_desc(a_s + 32 * j, 16, 1024)
                                   : gmma_desc(a_s + 2048 * j, BOX_BYTES, 1024);
      const uint64_t db = gmma_desc(b_s + 2048 * j, BOX_BYTES, 1024);
      wgmma_m64n128k16<A_KMAJOR ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();   // the previous stage's products have retired
      if (lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();

  // Epilogue. Every stage has been read; stage the f32 tile over them. A
  // thread then finishes 8 columns of BM / EPI_ROWS rows: for the dh
  // epilogue it loads those rows of a first, so all of them are in flight
  // at once.
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int ROWS = BM / EPI_ROWS;
  const int cc = threadIdx.x % EPI_COLS, rg = threadIdx.x / EPI_COLS;
  const int n = n0 + 8 * cc;
  {
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float2*>(tile + (r0 + 8 * i) * EPI_LD + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
  uint4 araw[ROWS];
  if constexpr (EPI == EPI_DGELU) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int64_t m = m0 + rg + i * EPI_ROWS;
      araw[i] = m < args.M && n < args.N
                    ? *reinterpret_cast<const uint4*>(args.a + m * args.N + n)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  float csum[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) csum[v] = 0.0f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = rg + i * EPI_ROWS;
    const int64_t m = m0 + r;
    if (m >= args.M || n >= args.N) continue;
    const float4* src = reinterpret_cast<const float4*>(tile + r * EPI_LD + 8 * cc);
    const float4 lo = src[0], hi = src[1];
    if constexpr (EPI == EPI_F32) {
      float4* dst = reinterpret_cast<float4*>(
          args.out + ((int64_t)blockIdx.z * args.M + m) * args.N + n);
      dst[0] = lo;
      dst[1] = hi;
    } else {
      const float dh[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const int64_t idx = m * args.N + n;
      float a[8], da[8], h[8];
      unpack8(araw[i], a);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float grad;
        gelu_and_grad(a[v], h[v], grad);
        da[v] = dh[v] * grad;
        csum[v] += da[v];
      }
      store8(args.da + idx, da);
      store8(args.h + idx, h);
    }
  }
  if constexpr (EPI == EPI_DGELU) {
    // Column sums of the tile: each row group's, then the groups in order.
    float* red = tile + BM * EPI_LD;
#pragma unroll
    for (int v = 0; v < 8; ++v) red[rg * BN + 8 * cc + v] = csum[v];
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (threadIdx.x < BN && n0 + (int)threadIdx.x < args.N) {
      float s = 0.0f;
      for (int g = 0; g < EPI_ROWS; ++g) s += red[g * BN + threadIdx.x];
      args.colsum[(int64_t)blockIdx.y * args.N + n0 + threadIdx.x] = s;
    }
  }
}

// ------------------------------------------------------------ row kernels
// A group of `lanes` lanes (8, 16 or 32) takes one row; lane i holds the
// 8-column chunks i + q lanes, q < Q (C <= 512 = 32 lanes x 2 chunks x 8;
// Q = 1 up to C = 256, which halves the registers a thread holds). A group
// walks its rows U at a time (2 where Q = 1, 1 where Q = 2, which would
// spill with two) and loads every input of
// those rows, packed, before their reductions, so the loads are in flight
// together. Two blocks fit on an SM, and the grid gives each group at least
// ROW_MIN rows, up to ROW_GRID blocks, one wave on 132 SMs: a count that
// depends on the shape alone, so the order of the column sums does not
// depend on the card.
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int MAX_C = 512;                // ops/block_mlp.py MAX_FUSED_C
constexpr int ROW_GRID = 264;
constexpr int ROW_MIN = 4;
constexpr int RED_FLOATS = 4096;          // row groups of a block x C, at most

int row_lanes(int C) {
  const int chunks = C / 8;
  int lanes = 8;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

int row_grid(int64_t M, int C) {
  const int64_t rows = (int64_t)ROW_WARPS * (32 / row_lanes(C)) * ROW_MIN;
  const int64_t need = (M + rows - 1) / rows;
  return (int)(need < ROW_GRID ? need : ROW_GRID);
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
__device__ __forceinline__ void load_packed(const bf16* __restrict__ p, int64_t m,
                                            bool ok, int C, int lanes, int li,
                                            uint4 (&v)[Q]) {
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
#define IC_TRY(expr)                        \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (rows, cols) tensor, cols contiguous, read in boxes of box_rows x 64
// columns with the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t rows,
                     int64_t cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = A B with A K-major (stored (M, K)) or MN-major (stored (K, M)) and B
// stored (K, N): the maps of the GEMM core.
cudaError_t make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                      const void* b, bool a_kmajor, int64_t M, int N, int64_t K) {
  IC_TRY(a_kmajor ? make_map(ma, a, M, K, BM) : make_map(ma, a, K, M, 64));
  return make_map(mb, b, K, N, 64);
}

template <int EPI, bool A_KMAJOR>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                        const GemmArgs& args, int splits, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    IC_TRY(cudaFuncSetAttribute(gemm_kernel<EPI, A_KMAJOR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_BYTES));
    IC_TRY(cudaFuncSetAttribute(gemm_kernel<EPI, A_KMAJOR>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared));
    configured = true;
  }
  const dim3 grid((args.N + BN - 1) / BN, (unsigned)((args.M + BM - 1) / BM), splits);
  gemm_kernel<EPI, A_KMAJOR><<<grid, GEMM_THREADS, SMEM_BYTES, st>>>(ma, mb, args);
  return cudaGetLastError();
}

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
  IC_TRY(make_maps(&dh_a, &dh_b, du, w2, true, M, H4, C));
  IC_TRY(make_maps(&dxh_a, &dxh_b, da, w1, true, M, C, H4));
  IC_TRY(make_maps(&w1_a, &w1_b, da, xhat, false, H4, C, M));
  IC_TRY(make_maps(&w2_a, &w2_b, du, h, false, C, H4, M));

  // (a) xhat, du and the partials of db2, dg
  IC_TRY(launch_rows(b.grid, xb, u, dy, s, t, g, xhat, du, nullptr, nullptr,
                     f + b.db2, f + b.dg, M, C, eps, true, st));
  // (b) da = (du @ W2) * gelu'(a), h = gelu(a), partials of db1
  GemmArgs dh{M, H4, C, ((C + BK - 1) / BK) * BK, nullptr,
              static_cast<const bf16*>(a), static_cast<bf16*>(da),
              static_cast<bf16*>(h), f + b.db1};
  IC_TRY((launch_gemm<EPI_DGELU, true>(dh_a, dh_b, dh, 1, st)));
  // (c) dxhat = da @ W1 in f32
  GemmArgs dxh{M, C, H4, ((H4 + BK - 1) / BK) * BK, static_cast<float*>(dxhat),
               nullptr, nullptr, nullptr, nullptr};
  IC_TRY((launch_gemm<EPI_F32, true>(dxh_a, dxh_b, dxh, 1, st)));
  // (d) the LayerNorm backward, partials of ds, dt
  IC_TRY(launch_rows(b.grid, xb, nullptr, nullptr, s, nullptr, nullptr, nullptr,
                     nullptr, static_cast<const float*>(dxhat), dx, f + b.ds,
                     f + b.dt, M, C, eps, false, st));
  // (e) dW1 (4C, C) = da^T @ xhat; (f) dW2 (C, 4C) = du^T @ h, split over M
  GemmArgs gw1{H4, C, M, b.s1.kchunk, f + b.w1, nullptr, nullptr, nullptr, nullptr};
  IC_TRY((launch_gemm<EPI_F32, false>(w1_a, w1_b, gw1, b.s1.splits, st)));
  GemmArgs gw2{C, H4, M, b.s2.kchunk, f + b.w2, nullptr, nullptr, nullptr, nullptr};
  IC_TRY((launch_gemm<EPI_F32, false>(w2_a, w2_b, gw2, b.s2.splits, st)));
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
  IC_TRY(make_maps(&ma, &mb, a, b, a_kmajor != 0, M, N, K));
  const Split sp = split_k ? weight_grad_split((int)M, N, K)
                           : Split{1, ((K + BK - 1) / BK) * BK};
  const GemmArgs args{M, N, K, sp.kchunk, static_cast<float*>(out),
                      nullptr, nullptr, nullptr, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_kmajor ? launch_gemm<EPI_F32, true>(ma, mb, args, sp.splits, st)
                  : launch_gemm<EPI_F32, false>(ma, mb, args, sp.splits, st);
}

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
