// The bf16 GEMM core of the block tail on Hopper, shared by its forward
// (block_mlp.cu: fc1 and fc2) and its backward (block_mlp_bwd.cu: dh, dxhat,
// dW1, dW2). Each file brings its own epilogues.
//
// A 128 x 128 output tile a block, K in steps of 64. One producer warp
// starts TMA loads (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 3
// shared-memory stages guarded by mbarriers; two consumer warpgroups, 64 rows
// each, run wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators) straight
// from the swizzled stages and release a stage as soon as the wgmma that
// reads it has retired. Either operand is read K-major (stored (rows, K),
// boxes of 128 rows) or MN-major (stored (K, rows), boxes of 64 K-rows by 64
// elements, through the descriptor's transpose bit), so no operand is ever
// transposed in memory: nn.Linear's (out, in) weights are K-major B of the
// forward's products and MN-major B of the backward's. After the last k-step
// the epilogue stages the f32 tile over the freed stages (stage_acc) and
// walks it row by row, 8 columns a thread (16-byte loads and stores). Two
// blocks fit on an SM (99 KB of shared memory each), so one block's epilogue
// overlaps the other's loads. 64 accumulators a thread fit the register
// budget without setmaxnreg.
//
// An epilogue is a struct derived from GemmShape with
//   __device__ void operator()(const float (&acc)[64], uint8_t* smem,
//                              int64_t m0, int n0) const;
// which every consumer thread calls once with its accumulators.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

#ifndef IC_TRY
#define IC_TRY(expr)                        \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;                   // two warpgroups
constexpr int GEMM_THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;           // one 64 x 128-byte box
constexpr int TILE_BYTES = 2 * BOX_BYTES;        // 128 x 64 bf16
constexpr int STAGE_BYTES = 2 * TILE_BYTES;      // A and B
constexpr int EPI_LD = BN + 8;                   // f32 pitch of the staged tile
constexpr int EPI_COLS = BN / 8;                 // 8-column chunks of a row
constexpr int EPI_ROWS = CONSUMERS / EPI_COLS;   // rows the epilogue walks at once
constexpr int EPI_ROWS_A_THREAD = BM / EPI_ROWS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM * EPI_LD * 4 + EPI_ROWS * BN * 4 <= STAGES * STAGE_BYTES,
              "the staged tile and its column sums fit in the stages");

// M, N of the output; the product's K; and the K a split covers (a multiple
// of BK; K itself without split-K).
struct GemmShape {
  int64_t M;
  int N;
  int64_t K;
  int64_t kchunk;
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

// The consumers' own barrier (the producer warp has left by then).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), each operand K-major
// (TRANS = 0) or MN-major (1). d's layout: register 4j + 2i + v of lane l in
// warp w holds row 16w + l/4 + 8i, column 8j + 2(l%4) + v.
template <int TRANS_A, int TRANS_B>
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
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// Descriptor of the 16-deep slice j of a stage's operand tile at addr:
// K-major, the 16-column slice j of 128-byte rows, 8-row groups 1024 bytes
// apart; MN-major, K rows 16j.., 128 bytes a row, 8-row groups 1024 bytes
// apart, 64-wide MN boxes BOX_BYTES apart.
template <bool KMAJOR>
__device__ __forceinline__ uint64_t slice_desc(uint32_t addr, int j) {
  return KMAJOR ? gmma_desc(addr + 32 * j, 16, 1024)
                : gmma_desc(addr + 2048 * j, BOX_BYTES, 1024);
}

// One operand tile (128 rows of the output's M or N by BK of K) at
// (row0, k0) into dst: K-major in one box of 128 rows, MN-major in two
// 64-wide boxes.
template <bool KMAJOR>
__device__ __forceinline__ void load_operand(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int row0, int k0) {
  if constexpr (KMAJOR) {
    tma_load(dst, map, bar, k0, row0);
  } else {
    tma_load(dst, map, bar, row0, k0);
    tma_load(dst + BOX_BYTES, map, bar, row0 + 64, k0);
  }
}

// The consumer's f32 tile staged over the stages, which every wgmma has
// read once the first barrier passes. The epilogue syncs (consumer_sync)
// before it reads the tile.
__device__ __forceinline__ float* stage_acc(const float (&acc)[64], uint8_t* smem) {
  consumer_sync();
  float* tile = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<float2*>(tile + (r0 + 8 * i) * EPI_LD + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
  return tile;
}

// Row r's 8 columns 8 cc.. of the staged tile.
__device__ __forceinline__ void tile_row8(const float* tile, int r, int cc,
                                          float (&v)[8]) {
  const float4* src = reinterpret_cast<const float4*>(tile + r * EPI_LD + 8 * cc);
  const float4 lo = src[0], hi = src[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// out = epilogue(A B) over the k-tiles of split blockIdx.z. The tensor maps
// (bf16, 128-byte swizzle, boxes 64 wide in the contiguous dimension): a
// K-major operand stored (rows, K) in boxes of 128 rows, an MN-major one
// stored (K, rows) in boxes of 64 rows. Grid: (N tiles, M tiles, splits).
template <class EpiT, bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const EpiT epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t kbeg = (int64_t)blockIdx.z * epi.kchunk;
  const int64_t kend = kbeg + epi.kchunk < epi.K ? kbeg + epi.kchunk : epi.K;
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
        const int k0 = (int)(kbeg + (int64_t)kt * BK);
        load_operand<A_KMAJOR>(a_s, &map_a, bar, (int)m0, k0);
        load_operand<B_KMAJOR>(a_s + TILE_BYTES, &map_b, bar, n0, k0);
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
      wgmma_m64n128k16<A_KMAJOR ? 0 : 1, B_KMAJOR ? 0 : 1>(
          acc, slice_desc<A_KMAJOR>(a_s, j), slice_desc<B_KMAJOR>(b_s, j));
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();   // the previous stage's products have retired
      if (lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  epi(acc, smem, m0, n0);
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled fetched through the runtime's entry-point query,
// so the library needs no -lcuda.
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

// The maps of C (M, N) = A B: A K-major (stored (M, K)) or MN-major (stored
// (K, M)); B K-major (stored (N, K)) or MN-major (stored (K, N)).
cudaError_t make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                      const void* b, bool a_kmajor, bool b_kmajor, int64_t M,
                      int N, int64_t K) {
  IC_TRY(a_kmajor ? make_map(ma, a, M, K, BM) : make_map(ma, a, K, M, 64));
  return b_kmajor ? make_map(mb, b, N, K, BN) : make_map(mb, b, K, N, 64);
}

// The attributes are set once a process, on the device current at the
// first launch: sound at one device a process, as the port runs (one rank a
// GPU under torchrun). A process that launched on a second device would
// have to set them there too.
template <class EpiT, bool A_KMAJOR, bool B_KMAJOR>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                        const EpiT& epi, int splits, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    IC_TRY(cudaFuncSetAttribute(gemm_kernel<EpiT, A_KMAJOR, B_KMAJOR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_BYTES));
    IC_TRY(cudaFuncSetAttribute(gemm_kernel<EpiT, A_KMAJOR, B_KMAJOR>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared));
    configured = true;
  }
  const dim3 grid((epi.N + BN - 1) / BN, (unsigned)((epi.M + BM - 1) / BM), splits);
  gemm_kernel<EpiT, A_KMAJOR, B_KMAJOR><<<grid, GEMM_THREADS, SMEM_BYTES, st>>>(
      ma, mb, epi);
  return cudaGetLastError();
}

}  // namespace
