// 7x7 depthwise convolution, SAME padding, no bias, channels-last (NHWC): the
// forward stencil and the wgrad-only backward (dw alone). Together they are
// the whole backward: dx is the forward stencil on g with the flipped filter.
//
// Replaces: image_classification_tpu/ops/dwconv.py:_conv_same_pallas (body
// _fwd_kernel), _wgrad_pallas (body _dw_kernel) and, as that pair,
// _bwd_pallas (body _bwd_kernel, dx and dw in one pass where its VMEM
// estimate of an image allows). On the H100 the backward is bound by its
// FP32 operations, not its bytes: fusing dx and dw saves one read of g but
// makes one thread hold the 49 taps, the 49 dw sums and its dx sums at
// once, so ops/dwconv.py runs the two kernels at every shape, each with its
// own register budget. The forward also serves every block's forward pass.
//
// What bounds them on the H100: instruction issue, the FP32 units first. An
// output element of the forward costs 49 FMAs against 4 bytes moved in bf16
// (~25 FLOP a byte; the card balances at ~20 for FP32 work). The wgrad does
// 49 products and 49 f32 adds an element, each product rounded to the
// storage type first, as the Pallas kernel multiplies its bf16 tiles. So the
// kernels must issue little besides that arithmetic. In NHWC the columns of
// a row lie C elements apart, a stride known only at run time, and loading
// them from device memory costs each load its own 64-bit address arithmetic:
// more instructions than the products they feed. Both kernels therefore
// stage rows in shared memory, [column][channel] with a fixed channel count
// per block, where every read a thread makes is a compile-time offset from
// one base register.
//
// Staging: 16-byte cp.async copies (zero-filled outside the map or past C)
// into a ring of rows, issued ahead of the rows being computed and waited
// for with cp.async.wait_group, one barrier a row; where C or alignment
// forbids 16-byte copies, the same kernels stage with element copies.
//
// Forward. A block owns 32 channels of a strip of columns: ng groups of TW
// output columns. A thread owns one channel of one group and walks down the
// rows: its 49 taps stay in registers in f32; for each input row it reads TW
// + 6 staged values and adds the row's products into the 7 output rows the
// row touches. The 7 rows of TW accumulators rotate through a loop unrolled
// by 7, so every register index is known at compile time, and the output row
// that the input row completes is stored at once. Each output is summed in
// f32 in tap order and rounded once, whatever TW and ng, so the choice
// between the two compiled shapes (see FWD_WIDE_WARPS) changes no bit:
// groups of 9 columns filling the map's width (65 -> 8 groups) where the
// grid is large, one group of 5 a block where it is small.
//
// Wgrad. A block owns 32 lanes of channels (a pair of bf16 channels a lane
// where C allows) of a segment of rows of one image; its 7 warps take the 7
// tap rows. Per row h the block stages g's row h and x's row h + 3 (x keeps
// a ring of 8 rows: h - 3 .. h + 3 and the next); warp i pairs g's row with
// x's row h + i - 3, 13 columns at a time, so a thread keeps the 7 x 2 sums
// of one tap row. For bf16 pairs one mul.rn.bf16x2 gives both products
// rounded to nearest-even in bf16, the bits of rounding the exact f32
// product, and each half widens to f32 with one integer op: ~2.5
// instructions a product and nothing on the conversion pipe. Each 13
// products are summed first, then added to the thread's totals; a block
// writes one f32 partial (49, its channels), and a second kernel adds the
// partials of each (tap, channel) in a fixed order (strided runs, then a
// fixed tree in shared memory). The segments depend only on the shape, not
// on the card, and there are no float atomics: two runs give the same bits.
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int KS = 7;
constexpr int PAD = KS / 2;

// ------------------------------------------------------------------ staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's share of the 16-byte copies that stage a row: the copies
// q = tid + n * nthreads of the row's cols x CB / V, worked out once, so each
// staged row costs a thread one 64-bit add and one cp.async a copy.
template <typename T, int CB, int NC>
struct RowCopies {
  static constexpr int V = 16 / sizeof(T);
  int soff[NC];                     // element offset in the staged row
  int goff[NC];                     // element offset from the row's start
  unsigned live = 0, ok = 0;        // copies this thread makes, and which read

  __device__ __forceinline__ RowCopies(int tid, int nthreads, int col0,
                                       int cols, int W, int C, int c0) {
    constexpr int CH = CB / V;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int q = tid + n * nthreads;
      const int p = q / CH, k = q % CH;
      const int col = col0 + p, c = c0 + k * V;
      soff[n] = p * CB + k * V;
      goff[n] = col * C + c;
      if (q < cols * CH) live |= 1u << n;
      if (q < cols * CH && (unsigned)col < (unsigned)W && c < C) ok |= 1u << n;
    }
  }

  // Stage row r (starting at row) into dst; zero-fill where a copy reads
  // nothing.
  __device__ __forceinline__ void issue(T* dst, const T* row) const {
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (live >> n & 1u) {
        const bool good = ok >> n & 1u;
        cp_async16(dst + soff[n], good ? row + goff[n] : row, good);
      }
  }
};

// Stages rows of image xb, columns col0 .. col0 + cols - 1 and channels
// c0 .. c0 + CB - 1, into [cols][CB] in shared memory; zero outside [0, W)
// or past C. VEC: 16-byte cp.async copies (C and the base 16-byte aligned),
// at most NC a thread; else element copies.
template <typename T, int CB, bool VEC, int NC>
struct RowStager {
  RowCopies<T, CB, NC> copies;
  int W, C;
  __device__ __forceinline__ RowStager(int tid, int nthreads, int col0, int cols,
                                       int W_, int C_, int c0)
      : copies(tid, nthreads, col0, cols, W_, C_, c0), W(W_), C(C_) {}
  __device__ __forceinline__ void stage(T* dst, const T* xb, int r) const {
    copies.issue(dst, xb + (size_t)r * W * C);
  }
};

template <typename T, int CB, int NC>
struct RowStager<T, CB, false, NC> {
  int tid, nthreads, col0, cols, W, C, c0;
  __device__ __forceinline__ RowStager(int tid_, int nthreads_, int col0_,
                                       int cols_, int W_, int C_, int c0_)
      : tid(tid_), nthreads(nthreads_), col0(col0_), cols(cols_), W(W_), C(C_),
        c0(c0_) {}
  __device__ __forceinline__ void stage(T* dst, const T* xb, int r) const {
    const T* row = xb + (size_t)r * W * C;
    for (int q = tid; q < cols * CB; q += nthreads) {
      const int p = q / CB, k = q % CB;
      const int col = col0 + p, c = c0 + k;
      dst[p * CB + k] = (unsigned)col < (unsigned)W && c < C
                            ? row[(size_t)col * C + c] : ic_from_f32<T>(0.0f);
    }
  }
};

// Copies a thread makes to stage `cols` columns of CB channels over
// `nthreads` threads, at most.
__host__ __device__ constexpr int copies_per_thread(int cols, int cb_bytes,
                                                   int nthreads) {
  return (cols * (cb_bytes / 16) + nthreads - 1) / nthreads;
}

bool aligned16(int C, size_t elem, const void* a, const void* b) {
  return (C * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// Lets kernel K take `bytes` of dynamic shared memory on the current device
// (above 48 KB only on request); set before every such launch, as the
// attribute belongs to one device. The wgrad's ring needs ~89 KB.
template <auto K>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ------------------------------------------------------------------ forward

constexpr int FB = 32;                // channels per block
constexpr int FWD_AHEAD = 3;          // rows staged ahead of the one computed
constexpr int FWD_RING = FWD_AHEAD + 1;

// Column groups a block may hold for a strip width TW: the widest map of the
// main path (65) in one strip, within the registers a thread needs.
__host__ __device__ constexpr int fwd_max_groups(int tw) { return (72 + tw - 1) / tw; }

template <typename T, int TW, bool VEC>
__global__ void __launch_bounds__(FB * fwd_max_groups(TW))
dwconv7x7_fwd_tile(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int H, int W, int C, int ng, int strips) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int sc = ng * TW + KS - 1;                  // staged columns
  const int slot = sc * FB;                         // elements a staged row
  const int lane = threadIdx.x % FB, grp = threadIdx.x / FB;
  const int c0 = blockIdx.y * FB, c = c0 + lane;
  const int strip = blockIdx.x % strips;
  const int b = blockIdx.x / strips;
  const int w0 = strip * ng * TW;                   // the block's first column
  const int tw0 = w0 + grp * TW;                    // the thread's first column
  const T* __restrict__ xb = x + (size_t)b * H * W * C;
  T* __restrict__ yb = y + (size_t)b * H * W * C + c;
  const RowStager<T, FB, VEC, copies_per_thread(TW + KS - 1, FB * sizeof(T), FB)>
      stager(threadIdx.x, blockDim.x, w0 - PAD, sc, W, C, c0);

  float wt[KS][KS];
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < KS; ++j)
      wt[i][j] = c < C ? ic_to_f32<T>(w[(i * KS + j) * C + c]) : 0.0f;

  for (int r = 0; r < FWD_AHEAD; ++r) {
    if (r < H)
      stager.stage(ring + r * slot, xb, r);
    cp_async_commit();
  }
  const T* mine = ring + grp * TW * FB + lane;

  // acc[s] holds output row h with (h - r0) mod 7 == s, r0 the first row of
  // the current 7-row step; input rows outside [0, H) are zero.
  float acc[KS][TW];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int t = 0; t < TW; ++t) acc[s][t] = 0.0f;

  for (int r0 = -PAD; r0 < H + PAD; r0 += KS) {
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const int r = r0 + u;
      if (r >= H + PAD) break;
      if (r >= 0 && r < H) {                        // the same for the block
        cp_async_wait<FWD_AHEAD - 1>();             // row r has landed
        __syncthreads();                            // and row r - 1 is read
        if (r + FWD_AHEAD < H)
          stager.stage(ring + ((r + FWD_AHEAD) % FWD_RING) * slot, xb,
                       r + FWD_AHEAD);
        cp_async_commit();
        const T* src = mine + (r % FWD_RING) * slot;
        float v[TW + KS - 1];
#pragma unroll
        for (int k = 0; k < TW + KS - 1; ++k) v[k] = ic_to_f32<T>(src[k * FB]);
        // Input row r adds tap row i to output row r + PAD - i. Tap row 0
        // is the first contribution any output row receives, so it assigns.
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          float(&a)[TW] = acc[(u + PAD - i + KS) % KS];
#pragma unroll
          for (int j = 0; j < KS; ++j)
#pragma unroll
            for (int t = 0; t < TW; ++t)
              a[t] = (i == 0 && j == 0) ? v[t] * wt[0][0]
                                        : fmaf(v[t + j], wt[i][j], a[t]);
        }
      }
      const int h = r - PAD;                        // complete once row r is in
      if (h >= 0 && c < C) {
        const float(&a)[TW] = acc[(u - PAD + KS) % KS];
        T* yrow = yb + ((size_t)h * W + tw0) * C;
        if (tw0 + TW <= W) {
#pragma unroll
          for (int t = 0; t < TW; ++t, yrow += C) *yrow = ic_from_f32<T>(a[t]);
        } else {
#pragma unroll
          for (int t = 0; t < TW; ++t, yrow += C)
            if (tw0 + t < W) *yrow = ic_from_f32<T>(a[t]);
        }
      }
    }
  }
}

template <typename T, int TW>
cudaError_t launch_fwd_tw(const void* x, const void* w, void* y, int B, int H,
                          int W, int C, int ng, cudaStream_t stream) {
  if (ng < 1 || ng > fwd_max_groups(TW)) return cudaErrorInvalidValue;
  const int strips = (W + ng * TW - 1) / (ng * TW);
  const dim3 grid((unsigned)(B * strips), (C + FB - 1) / FB);
  const size_t smem = (size_t)FWD_RING * (ng * TW + KS - 1) * FB * sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (aligned16(C, sizeof(T), x, x)) {            // smem <= 48 KB: no opt-in
    dwconv7x7_fwd_tile<T, TW, true><<<grid, FB * ng, smem, stream>>>(
        xt, wt, yt, H, W, C, ng, strips);
  } else {
    dwconv7x7_fwd_tile<T, TW, false><<<grid, FB * ng, smem, stream>>>(
        xt, wt, yt, H, W, C, ng, strips);
  }
  return cudaGetLastError();
}

// Where the map gives at least this many warps with strips of 9-column
// groups (a block of up to 8 warps holds a 65-wide map whole), the forward
// takes them; below it, blocks of one warp and 5 columns, which keep more
// blocks in flight. The crossover, measured by tools/time_dwconv.py
// --variants on an H100 (80GB HBM3, 700 W) at ConvNeXt-B's and -L's four
// maps and batches 16-256: at 512 and 768 warps (the train microbatch) the
// wide launch takes 2-46% longer; at 1,024 the narrow one takes 18-25%
// longer, and from 2,048 up (eval and predict batches) 11-22% longer on
// maps up to 33 wide; at 1,536 each wins somewhere, by up to 10%. On
// 65-wide maps the wide strip computes 72 columns and from 3,072 warps up
// takes 2-4% longer.
constexpr long long FWD_WIDE_WARPS = 1024;

// The wide launch's groups a block, and the warps of its grid.
int fwd_wide_groups(int W) {
  return (W + 8) / 9 < fwd_max_groups(9) ? (W + 8) / 9 : fwd_max_groups(9);
}

long long fwd_wide_warps(int B, int W, int C) {
  const int ng = fwd_wide_groups(W);
  return (long long)B * ((W + 9 * ng - 1) / (9 * ng)) * ((C + FB - 1) / FB) * ng;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int B, int H,
                       int W, int C, cudaStream_t stream) {
  return fwd_wide_warps(B, W, C) >= FWD_WIDE_WARPS
             ? launch_fwd_tw<T, 9>(x, w, y, B, H, W, C, fwd_wide_groups(W), stream)
             : launch_fwd_tw<T, 5>(x, w, y, B, H, W, C, 1, stream);
}

// ------------------------------------------------------------------ wgrad

constexpr int WG_LANES = 32;          // lanes of channels per block
constexpr int WG_L = 13;              // g columns per chunk
constexpr int WG_CHUNKS = 5;          // chunks a block strip: 65 columns
constexpr int WG_XRING = 8;           // staged x rows: h - 3 .. h + 3, h + 4
constexpr int WG_GRING = 2;           // staged g rows: h, h + 1
// The wgrad aims at this many blocks in all (two waves of two blocks on each
// of 132 SMs), split between channel groups and segments of rows; a fixed
// number, so the partials and the bits of dw do not depend on the card.
constexpr int WG_TARGET_BLOCKS = 528;
constexpr int RED_SLICES = 8;         // partial runs per element in the reduce

// Channel access of one lane: V channels of storage type T.
struct Bf16Pair {
  using T = __nv_bfloat16;
  using Raw = uint32_t;
  static constexpr int V = 2;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  // Both products rounded to bf16 (one mul.rn.bf16x2), widened to f32.
  static __device__ __forceinline__ void mul(Raw a, Raw b, float (&p)[V]) {
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    const uint32_t bits = *reinterpret_cast<const uint32_t*>(&r);
    p[0] = __uint_as_float(bits << 16);
    p[1] = __uint_as_float(bits & 0xffff0000u);
  }
};

struct Bf16One {
  using T = __nv_bfloat16;
  using Raw = uint16_t;
  static constexpr int V = 1;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
  static __device__ __forceinline__ void mul(Raw a, Raw b, float (&p)[V]) {
    const float prod = __fmul_rn(__uint_as_float((uint32_t)a << 16),
                                 __uint_as_float((uint32_t)b << 16));
    p[0] = ic_round<__nv_bfloat16>(prod);
  }
};

struct F32One {
  using T = float;
  using Raw = float;
  static constexpr int V = 1;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void mul(Raw a, Raw b, float (&p)[V]) {
    p[0] = __fmul_rn(a, b);
  }
};

template <typename A, bool VEC>
__global__ void __launch_bounds__(WG_LANES * KS)
dwconv7x7_wgrad_tile(const typename A::T* __restrict__ x,
                     const typename A::T* __restrict__ g,
                     float* __restrict__ partial, int H, int W, int C,
                     int strips, int segs) {
  using T = typename A::T;
  using Raw = typename A::Raw;
  constexpr int V = A::V;
  constexpr int CB = WG_LANES * V;                  // channels per block
  constexpr int SW = WG_L * WG_CHUNKS;              // columns per strip
  constexpr int XC = SW + KS - 1;                   // staged x columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xring = reinterpret_cast<T*>(smem_raw);        // [WG_XRING][XC][CB]
  T* gring = xring + WG_XRING * XC * CB;            // [WG_GRING][SW][CB]
  const int tid = threadIdx.y * WG_LANES + threadIdx.x;
  const int nthreads = WG_LANES * KS;
  const int i = threadIdx.y;                        // tap row
  const int lane = threadIdx.x;
  const int c0 = blockIdx.y * CB, c = c0 + lane * V;
  const int strip = blockIdx.x % strips;
  const int seg = (blockIdx.x / strips) % segs;
  const int b = blockIdx.x / (strips * segs);
  const int w0 = strip * SW;
  const int chunks = min(WG_CHUNKS, (W - w0 + WG_L - 1) / WG_L);
  const int h0 = (int)((long long)seg * H / segs);
  const int h1 = (int)((long long)(seg + 1) * H / segs);
  const T* __restrict__ xb = x + (size_t)b * H * W * C;
  const T* __restrict__ gb = g + (size_t)b * H * W * C;
  constexpr int NC = copies_per_thread(XC, CB * sizeof(T), WG_LANES * KS);
  const RowStager<T, CB, VEC, NC> xstager(tid, nthreads, w0 - PAD, XC, W, C, c0);
  const RowStager<T, CB, VEC, NC> gstager(tid, nthreads, w0, SW, W, C, c0);

  // x rows h0 - 3 .. h0 + 3 and g row h0, then one x and one g row a step.
  for (int r = max(0, h0 - PAD); r <= min(H - 1, h0 + PAD); ++r)
    xstager.stage(xring + (r % WG_XRING) * XC * CB, xb, r);
  gstager.stage(gring + (h0 % WG_GRING) * SW * CB, gb, h0);
  cp_async_commit();

  float tot[KS][V];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) tot[j][v] = 0.0f;

  for (int h = h0; h < h1; ++h) {
    cp_async_wait<0>();
    __syncthreads();               // step h is staged, step h - 1 is read
    if (h + 1 < h1) {
      if (h + 1 + PAD < H)
        xstager.stage(xring + ((h + 1 + PAD) % WG_XRING) * XC * CB, xb, h + 1 + PAD);
      gstager.stage(gring + ((h + 1) % WG_GRING) * SW * CB, gb, h + 1);
    }
    cp_async_commit();
    const int xr = h + i - PAD;
    if ((unsigned)xr >= (unsigned)H || c >= C) continue;  // zero padding
    const T* xs = xring + (xr % WG_XRING) * XC * CB + lane * V;
    const T* gs = gring + (h % WG_GRING) * SW * CB + lane * V;
    for (int ch = 0; ch < chunks; ++ch) {
      Raw gv[WG_L], xv[WG_L + KS - 1];
#pragma unroll
      for (int t = 0; t < WG_L; ++t) gv[t] = A::load(gs + (ch * WG_L + t) * CB);
#pragma unroll
      for (int k = 0; k < WG_L + KS - 1; ++k)
        xv[k] = A::load(xs + (ch * WG_L + k) * CB);
      // dw[i][j] += x[h + i - 3][w + j - 3] * g[h][w]: g column w0 + t of
      // the chunk meets staged x column t + j.
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float s[V], p[V];
        A::mul(xv[j], gv[0], s);
#pragma unroll
        for (int t = 1; t < WG_L; ++t) {
          A::mul(xv[t + j], gv[t], p);
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] = __fadd_rn(s[v], p[v]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) tot[j][v] = __fadd_rn(tot[j][v], s[v]);
      }
    }
  }
  if (c >= C) return;
  float* out = partial + ((size_t)blockIdx.x * KS * KS + i * KS) * C + c;
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) out[(size_t)j * C + v] = tot[j][v];
}

// dw[e] = the sum over groups of partial[group][e]: slice s of RED_SLICES adds
// groups s, s + RED_SLICES, ... in order, then the slices add in a fixed
// tree. 32 consecutive elements a block, so the reads coalesce.
__global__ void __launch_bounds__(32 * RED_SLICES)
dwconv7x7_wgrad_reduce(const float* __restrict__ partial, int groups, int n,
                       float* __restrict__ dw) {
  __shared__ float red[RED_SLICES][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int s = threadIdx.y;
  float sum = 0.0f;
  if (e < n)
    for (int grp = s; grp < groups; grp += RED_SLICES)
      sum += partial[(size_t)grp * n + e];
  red[s][threadIdx.x] = sum;
  __syncthreads();
#pragma unroll
  for (int half = RED_SLICES / 2; half > 0; half /= 2) {
    if (s < half) red[s][threadIdx.x] += red[s + half][threadIdx.x];
    __syncthreads();
  }
  if (s == 0 && e < n) dw[e] = red[0][threadIdx.x];
}

int wgrad_strips(int W) {
  const int sw = WG_L * WG_CHUNKS;
  return (W + sw - 1) / sw;
}

// Segments of rows: WG_TARGET_BLOCKS over the images, column strips and
// channel groups of 32 lanes of bf16 pairs (the same count for every
// variant, so it depends on the shape only).
int wgrad_segs(int B, int H, int W, int C) {
  const long long per_seg =
      (long long)B * wgrad_strips(W) * ((C + 2 * WG_LANES - 1) / (2 * WG_LANES));
  long long segs = (WG_TARGET_BLOCKS + per_seg - 1) / per_seg;
  if (segs > H) segs = H;
  return segs < 1 ? 1 : (int)segs;
}

template <typename A>
cudaError_t launch_wgrad(const void* x, const void* g, float* partial, float* dw,
                         int segs, int B, int H, int W, int C,
                         cudaStream_t stream) {
  using T = typename A::T;
  constexpr int CB = WG_LANES * A::V;
  const int strips = wgrad_strips(W);
  const int groups = B * strips * segs;
  const dim3 grid(groups, (C + CB - 1) / CB);
  const size_t smem = ((size_t)WG_XRING * (WG_L * WG_CHUNKS + KS - 1) +
                       (size_t)WG_GRING * WG_L * WG_CHUNKS) * CB * sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  cudaError_t err;
  if (aligned16(C, sizeof(T), x, g)) {
    if ((err = allow_smem<dwconv7x7_wgrad_tile<A, true>>(smem)) != cudaSuccess)
      return err;
    dwconv7x7_wgrad_tile<A, true><<<grid, dim3(WG_LANES, KS), smem, stream>>>(
        xt, gt, partial, H, W, C, strips, segs);
  } else {
    if ((err = allow_smem<dwconv7x7_wgrad_tile<A, false>>(smem)) != cudaSuccess)
      return err;
    dwconv7x7_wgrad_tile<A, false><<<grid, dim3(WG_LANES, KS), smem, stream>>>(
        xt, gt, partial, H, W, C, strips, segs);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = KS * KS * C;
  dwconv7x7_wgrad_reduce<<<(n + 31) / 32, dim3(32, RED_SLICES), 0, stream>>>(
      partial, groups, n, dw);
  return cudaGetLastError();
}

bool pair_ok(int C, const void* a, const void* b) {
  return C % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

}  // namespace

// x and w (7, 7, C) contiguous, of one dtype; y like x.
extern "C" int ic_dwconv7x7_fwd(const void* x, const void* w, void* y, int B,
                                int H, int W, int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case IC_F32:
      return launch_fwd<float>(x, w, y, B, H, W, C, st);
    case IC_BF16:
      return launch_fwd<__nv_bfloat16>(x, w, y, B, H, W, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Number of row segments of the wgrad, and the partial count it gives: the
// f32 scratch `partial` is (partials, 49, C).
extern "C" int ic_dwconv7x7_wgrad_segs(int B, int H, int W, int C) {
  return wgrad_segs(B, H, W, C);
}

extern "C" int ic_dwconv7x7_wgrad_partials(int B, int H, int W, int segs) {
  return B * wgrad_strips(W) * segs;
}

// The wgrad-only backward: dw (7, 7, C) f32 of the conv at x for the output
// gradient g; x and g (B, H, W, C) contiguous, of one dtype; partial
// (partials, 49, C) f32 scratch, 1 <= segs <= H.
extern "C" int ic_dwconv7x7_wgrad(const void* x, const void* g, void* partial,
                                  void* dw, int segs, int B, int H, int W,
                                  int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs < 1 || segs > H) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  switch (dtype) {
    case IC_F32:
      return launch_wgrad<F32One>(x, g, p, d, segs, B, H, W, C, st);
    case IC_BF16:
      return pair_ok(C, x, g)
                 ? launch_wgrad<Bf16Pair>(x, g, p, d, segs, B, H, W, C, st)
                 : launch_wgrad<Bf16One>(x, g, p, d, segs, B, H, W, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
