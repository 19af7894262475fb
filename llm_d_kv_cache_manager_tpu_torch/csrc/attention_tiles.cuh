// The attention tile loop shared by the bf16 kernels (flash_prefill.cu,
// ring_partial.cu), the Hopper instructions under it (TMA, mbarrier,
// wgmma, setmaxnreg), and the float32 per-row loop of their float32
// variants.
//
// What bounds the loop on an H100: at the serving shapes both kernels
// do ~300 or more operations per byte they read, so the tensor cores
// are the limit, and only `wgmma` reaches their full rate.  The design
// follows from that:
// - A CTA is 3 warpgroups (384 threads, one CTA per SM).  Warpgroup 0
//   is the producer: it gives most of its registers away (setmaxnreg)
//   and one of its threads issues TMA loads.  Warpgroups 1 and 2 are
//   consumers, 64 query rows each, with 240 registers a thread.
// - A work item is one (batch, head, 128-row q tile, key-tile range).
//   Items come from a list that ops/tile_plan.py builds and sorts
//   longest first; the grid is at most one CTA per SM, and CTA c walks
//   the list in rounds of gridDim.x items, taking position c of even
//   rounds and gridDim.x-1-c of odd ones.  The next item's loads then
//   overlap this item's epilogue.
// - Q (128 x D) stays in shared memory for the whole item; K and V go
//   through a ring of kStages stages of BK keys (128, or 64 above a
//   head dim of 128, where two stages of 128 would not fit beside Q),
//   K and V each with a full/empty mbarrier pair per stage.  TMA loads
//   D in boxes of 64 columns (128 bytes, the 128-byte swizzle's width)
//   over 4-D maps [B, T, heads, head dim], so rows past T and columns
//   past the head dim are zero-filled by the hardware and never read
//   the next row or batch.
// - Head dims.  A kernel is compiled for a width D, a multiple of 64
//   (64, 128, 192, 256), and serves every head dim in (D - 64, D] that
//   is a multiple of 16: the columns past the true head dim load as
//   zeros, so they add nothing to Q K^T and give zero columns of O,
//   which the epilogue does not write.  The scale is that of the true
//   head dim, which the kernel is given.
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory
//   (K-major); O += P V is wgmma with P in registers (the S accumulator
//   of key columns 16j..16j+15, rounded to bf16, is the A fragment of
//   k-step j) and V in shared memory, MN-major (transposed), in
//   products of 128 columns of O (and one of 64 for D = 192).
// - The softmax hides behind the products: a warpgroup issues S of
//   tile j with P V of tile j-1 and runs the softmax of tile j while
//   P V still runs (FlashAttention-3's intra-warpgroup overlap), and
//   the two consumer warpgroups run independently, so one's softmax
//   also overlaps the other's products.  FlashAttention-3's ping-pong
//   (named barriers that make the warpgroups take turns issuing),
//   measured on top of this, made the continuation 4% faster and the
//   other serving shapes up to 1.5% slower (PERF.md), so it is not here.
// - Only the tiles that straddle a row's key end, or under a sliding
//   window a row's key begin, are masked, element by element; the tiles
//   inside every row's range skip the compare, and tiles below every
//   row's begin are not in the item's key range, so never loaded.
//
// A key is visible to a row while it is below the row's end (`row_end`,
// given by each kernel): causal prefill gives min(q_offset + row + 1,
// Tk), a ring step clamp(row + offset + 1, 0, Tk) or Tk unmasked; and at
// or above the row's begin (`row_begin`): 0, or under a window of W keys
// max(row_end - W, 0) (flash_prefill.cu's windowed layers).  The
// running max is kept in raw score units and written in log2 units of
// the scaled score (scale_log2 = log2(e) / sqrt(D)).
//
// Accumulator layout (PTX ISA, wgmma m64nNk16, f32): warp w of the
// warpgroup holds rows 16w..16w+15; with g = lane / 4 and t = lane % 4
// a thread holds, for each 8-column block j, d[4j], d[4j+1] = (row g,
// columns 8j+2t, 8j+2t+1) and d[4j+2], d[4j+3] = (row g+8, the same).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;        // query rows per work item (2 consumer warpgroups x 64)
constexpr int kStages = 2;      // K/V stages in shared memory
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64;        // head-dim columns per TMA box: 128 bytes of bf16
constexpr int kRowBytes = kBox * 2;
constexpr int kItemInts = 8;    // ints per work item (ops/tile_plan.py ITEM_FIELDS)
constexpr int kRowsF32 = 8;     // float32 kernels: warps (= query rows) per CTA

// Field order of a work item, as ops/tile_plan.py writes it.
enum { kItB, kItH, kItQt, kItBegin, kItFullEnd, kItEnd, kItSplit, kItFullBegin };

// Keys per K/V stage for compiled width D (ops/tile_plan.py:key_tile).
template <int D>
constexpr int key_tile() {
  return D <= 128 ? 128 : 64;
}

// The compiled width that serves head dim d: the next multiple of 64.
inline int compiled_width(int d) { return (d + 63) / 64 * 64; }

// The head dims the kernels take: multiples of 16 from 32 to 256.
inline bool head_dim_ok(int d) { return d >= 32 && d <= 256 && d % 16 == 0; }

template <int D>
struct TileBytes {
  static constexpr int BK = key_tile<D>();
  static constexpr int q = kBQ * D * 2;
  static constexpr int kv = BK * D * 2;  // one of K or V, one stage
  static constexpr int bars = 8 * (2 + 4 * kStages);
  // 1024 bytes of slack to align the tiles to the swizzle atom.
  static constexpr int smem = q + 2 * kStages * kv + bars + 1024;
  static_assert(D % 64 == 0 && D <= 256, "compiled widths are 64, 128, 192, 256");
  static_assert(smem <= 232448, "a CTA has 227 KB of shared memory");
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh
// barrier counts its (never run) phase of parity 1 as complete, so a
// first wait on parity 1 passes at once.  A wait that has not completed
// after 2^28 tries (seconds) traps, so a fault in the pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D map into shared memory; its bytes complete `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand
// registers across a wgmma fence or wait (the wait names no registers),
// and keeps an A operand's registers from reuse while a product that
// reads them may still run.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_ACC8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A(64x16, shared, K-major) * B(16x128, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24), WG_ACC8(d, 32),
        WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] (+)= A(64x16, shared, K-major) * B(16x64, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A(64x16, registers) * B(16x128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24), WG_ACC8(d, 32),
        WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A(64x16, registers) * B(16x64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_ACC8

// S (+)= Q K^T over one k-step, N = BK keys.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(s, da, db, accumulate);
  } else {
    wgmma_ss_n64(s, da, db, accumulate);
  }
}

// O += P V over one k-step: products of 128 columns of O, then one of
// 64 for a width that is an odd multiple of 64.  `v` is the shared
// address of the step's 16 V rows in the first 64-column chunk; chunk
// c lies c * `chunk_bytes` further on.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a, uint32_t v,
                                         uint32_t chunk_bytes) {
#pragma unroll
  for (int c = 0; c < D / 128; ++c) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 64 * c), a,
                  smem_desc(v + 2 * c * chunk_bytes, chunk_bytes, 1024));
  }
  if constexpr (D % 128 != 0) {
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(o + 64 * (D / 128)), a,
                 smem_desc(v + 2 * (D / 128) * chunk_bytes, chunk_bytes, 1024));
  }
}

// 2^x, flushing subnormal inputs and results to 0 (one MUFU.EX2; the
// plain exp2f adds the subnormal handling around it).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------ host: tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so
// the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A TMA map over a contiguous bf16 [B, T, heads, D] tensor, innermost
// first (D, heads, T, B), with a box of kBox columns x 1 head x `rows`
// rows x 1 batch and the 128-byte swizzle.  Rows past T read as zero.
// Returns 0 or a cudaError_t.
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int T, int heads,
                         int D, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T};  // bytes
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult rc =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
         box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// --------------------------------------------------------- the tile loop

// One consumer thread's share of its item: the unnormalized accumulator
// (wgmma layout above), the row max in log2 units of the scaled score
// (-inf while no key was visible) and the row sum, for its rows g and
// g+8.
template <int D>
struct TileRows {
  float o[D / 2];
  float m0, m1;
  float l0, l1;
};

// Item index of round r for this CTA (see the note at the top).
__device__ __forceinline__ int item_index(int r) {
  const int c = (r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  return r * static_cast<int>(gridDim.x) + c;
}

// The whole body of a bf16 attention kernel: walks this CTA's items
// and calls `epilogue(b, h, split, rows, row0, row1)` on each consumer
// thread once per item, row0 and row0 + 8 being its rows (which may lie
// past Tq).  `row_end(row)` is a row's key end and `row_begin(row)` its
// first visible key.  `smem` is the kernel's dynamic shared memory,
// TileBytes<D>::smem bytes.
//
// A consumer warpgroup's loop over the key tiles of an item overlaps
// its own work: with S_j = Q K_j^T and P_j its probabilities, one
// issue of wgmma runs S_j and O += P_{j-1} V_{j-1} together, and the
// softmax of S_j runs while the second product is still in flight.  K
// and V have their own full/empty barriers: K_j is released as soon as
// S_j is done, V_j after its product.
template <int D, class RowEnd, class RowBegin, class Epilogue>
__device__ __forceinline__ void attend_items_in(const CUtensorMap* qmap,
                                                const CUtensorMap* kmap,
                                                const CUtensorMap* vmap,
                                                const int* __restrict__ items, int n_items,
                                                int group, float scale_log2,
                                                unsigned char* smem, RowEnd row_end,
                                                RowBegin row_begin, Epilogue epilogue) {
  using Bytes = TileBytes<D>;
  constexpr int kBK = Bytes::BK;         // keys per K/V stage
  constexpr int kBoxes = D / kBox;       // TMA boxes (64-column chunks) per row
  constexpr int kQSteps = D / 16;        // k-steps of Q K^T over the head dim
  constexpr int kPSteps = kBK / 16;      // k-steps of P V over the keys
  constexpr int kKeyBlocks = kBK / 8;    // 8-column blocks of S
  constexpr int kDBlocks = D / 8;        // 8-column blocks of O

  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sq = base;                      // Q: kBoxes chunks of kBQ x 128 B
  const uint32_t skv = base + Bytes::q;          // stage s: K, then V
  const uint32_t bars = skv + 2 * kStages * Bytes::kv;
  const uint32_t q_full = bars, q_empty = bars + 8;
  // Barrier w (0: K full, 1: K empty, 2: V full, 3: V empty) of stage s.
  auto bar = [&](int w, int s) { return bars + 16 + 8 * (w * kStages + s); };
  auto k_tile = [&](int s) { return skv + s * 2 * Bytes::kv; };
  auto v_tile = [&](int s) { return skv + s * 2 * Bytes::kv + Bytes::kv; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), kConsumerWarps);
      mbar_init(bar(2, s), 1);
      mbar_init(bar(3, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    uint32_t tile = 0, q_phase = 0;  // K/V tiles loaded so far, Q phase
    for (int r = 0;; ++r) {
      const int i = item_index(r);
      if (i >= n_items) break;
      const int* it = items + i * kItemInts;
      const int b = it[kItB], h = it[kItH], qt = it[kItQt];
      const int kt_begin = it[kItBegin], kt_end = it[kItEnd];
      if (kt_begin >= kt_end) continue;
      const int kvh = h / group;
      mbar_wait(q_empty, q_phase ^ 1);
      q_phase ^= 1;
      mbar_expect_tx(q_full, Bytes::q);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(sq + c * kBQ * kRowBytes, qmap, q_full, c * kBox, h, qt * kBQ, b);
      }
      for (int kt = kt_begin; kt < kt_end; ++kt, ++tile) {
        const int s = tile % kStages;
        const uint32_t ph = (tile / kStages) & 1;
        mbar_wait(bar(1, s), ph ^ 1);
        mbar_expect_tx(bar(0, s), Bytes::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(k_tile(s) + c * kBK * kRowBytes, kmap, bar(0, s), c * kBox, kvh,
                      kt * kBK, b);
        }
        mbar_wait(bar(3, s), ph ^ 1);
        mbar_expect_tx(bar(2, s), Bytes::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(v_tile(s) + c * kBK * kRowBytes, vmap, bar(2, s), c * kBox, kvh,
                      kt * kBK, b);
        }
      }
    }
    return;
  }

  // ------------------- consumer warpgroups: 64 query rows each.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // This warpgroup's 64 rows of each Q chunk.
  const uint32_t sq_wg = sq + wg * 64 * kRowBytes;
  // A warp is done with a barrier's buffer: one arrival per warp.
  auto release = [&](uint32_t b) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };
  uint32_t tile = 0, q_phase = 0;  // K/V tiles consumed so far, Q phase

  for (int r = 0;; ++r) {
    const int i = item_index(r);
    if (i >= n_items) break;
    const int* it = items + i * kItemInts;
    const int b = it[kItB], h = it[kItH], qt = it[kItQt];
    const int kt_begin = it[kItBegin], kt_full_end = it[kItFullEnd];
    const int kt_end = it[kItEnd], kt_full_begin = it[kItFullBegin];
    const int row0 = qt * kBQ + wg * 64 + warp * 16 + g;
    const int row1 = row0 + 8;

    TileRows<D> st;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) st.o[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // raw score units
    float l0 = 0.f, l1 = 0.f;

    if (kt_begin < kt_end) {
      const int end0 = row_end(row0), end1 = row_end(row1);
      const int beg0 = row_begin(row0), beg1 = row_begin(row1);
      uint32_t p[kBK / 4];  // P_{j-1}, bf16 pairs: registers 4kk.. are k-step kk's A
      float corr0 = 1.f, corr1 = 1.f;

      // Issue S = Q K^T for the tile in stage `ks`, 16 head-dim columns
      // a step (the 64-column chunks of Q and K lie kBQ and kBK rows of
      // 128 bytes apart).  Each tile's S is a fresh array: one carried
      // from tile to tile would be written between wgmma issue and wait
      // (register moves at the loop's back edge), and ptxas then
      // serializes every wgmma.
      auto issue_s = [&](float (&s)[kBK / 2], int ks) {
#pragma unroll
        for (int kk = 0; kk < kQSteps; ++kk) {
          const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
          const uint64_t da = smem_desc(sq_wg + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
          const uint64_t db =
              smem_desc(k_tile(ks) + (kk / 4) * kBK * kRowBytes + col, 16, 1024);
          wgmma_qk<kBK>(s, da, db, kk > 0);
        }
        wgmma_commit();
      };
      // Issue O += P V for the tile in stage `vs`, 16 keys a step: V rows
      // 16kk.. start 16 x 128 bytes further, its chunks kBK rows apart.
      auto issue_pv = [&](int vs) {
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk) {
          wgmma_pv<D>(st.o, p + 4 * kk, v_tile(vs) + kk * 16 * kRowBytes, kBK * kRowBytes);
        }
        wgmma_commit();
      };
      // The online softmax of S (tile kt), in place: masks S if the tile
      // straddles a row's end or begin, moves the running max, sets corr
      // (the factor for O and l so far), turns S into probabilities and
      // adds their row sums to l.
      auto softmax = [&](float (&s)[kBK / 2], int kt) {
        if (kt >= kt_full_end || kt < kt_full_begin) {
          const int k0 = kt * kBK + 2 * t;
#pragma unroll
          for (int j = 0; j < kKeyBlocks; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + j * 8 + e;
              if (kpos >= end0 || kpos < beg0) s[4 * j + e] = -INFINITY;
              if (kpos >= end1 || kpos < beg1) s[4 * j + 2 + e] = -INFINITY;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < kKeyBlocks; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // A row with every key so far masked keeps max -inf; subtract 0
        // instead so exp2 gives 0, never NaN.
        const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
        const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
        corr0 = exp2_ftz(m0 * scale_log2 - base0);
        corr1 = exp2_ftz(m1 * scale_log2 - base1);
        m0 = mx0;
        m1 = mx1;
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          s[e] = exp2_ftz(fmaf(s[e], scale_log2, (e & 2) ? -base1 : -base0));
        }
        float sum0 = s[0] + s[1], sum1 = s[2] + s[3];
#pragma unroll
        for (int j = 1; j < kKeyBlocks; ++j) {
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
      };
      // P for the next P V product: S's probabilities as bf16 pairs.
      auto to_p = [&](const float (&s)[kBK / 2]) {
#pragma unroll
        for (int j = 0; j < kKeyBlocks; ++j) {
          p[2 * j] = pack_floats(s[4 * j], s[4 * j + 1]);
          p[2 * j + 1] = pack_floats(s[4 * j + 2], s[4 * j + 3]);
        }
      };
      auto rescale_o = [&] {
#pragma unroll
        for (int j = 0; j < kDBlocks; ++j) {
          st.o[4 * j] *= corr0;
          st.o[4 * j + 1] *= corr0;
          st.o[4 * j + 2] *= corr1;
          st.o[4 * j + 3] *= corr1;
        }
      };

      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      // Tile kt_begin: S alone.
      {
        const int ks = tile % kStages;
        float s[kBK / 2];
        mbar_wait(bar(0, ks), (tile / kStages) & 1);
        wgmma_fence();
        issue_s(s, ks);
        wgmma_wait<0>();
        fence_regs(s);
        release(bar(1, ks));
        if (kt_begin + 1 == kt_end) release(q_empty);
        softmax(s, kt_begin);
        to_p(s);
      }

      // Tile kt: issue S_kt, then O = O * corr + P_{kt-1} V_{kt-1} (corr
      // from the softmax of tile kt-1), and run the softmax of S_kt
      // while that product is still in flight.  Only S's registers are
      // written while a product runs (S's own product is done by then):
      // P is made from them after the wait.
      for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
        const int vs = tile % kStages;  // V of the previous tile
        const uint32_t v_phase = (tile / kStages) & 1;
        ++tile;
        const int ks = tile % kStages;
        float s[kBK / 2];
        mbar_wait(bar(0, ks), (tile / kStages) & 1);
        mbar_wait(bar(2, vs), v_phase);
        wgmma_fence();
        issue_s(s, ks);
        rescale_o();
        fence_regs(st.o);
        wgmma_fence();
        issue_pv(vs);
        wgmma_wait<1>();  // S done; the P V product may still run
        fence_regs(s);
        release(bar(1, ks));
        if (kt + 1 == kt_end) release(q_empty);  // Q is no longer read
        softmax(s, kt);
        wgmma_wait<0>();
        fence_regs(st.o);
        fence_regs(p);
        release(bar(3, vs));
        to_p(s);
      }

      // The last tile's P V.
      const int vs = tile % kStages;
      mbar_wait(bar(2, vs), (tile / kStages) & 1);
      ++tile;
      rescale_o();
      fence_regs(st.o);
      wgmma_fence();
      issue_pv(vs);
      wgmma_wait<0>();
      fence_regs(st.o);
      fence_regs(p);
      release(bar(3, vs));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    st.m0 = m0 * scale_log2;
    st.m1 = m1 * scale_log2;
    st.l0 = l0;
    st.l1 = l1;
    epilogue(b, h, it[kItSplit], st, row0, row1);
  }
}

// attend_items_in with every key from 0 on visible below the row's end.
template <int D, class RowEnd, class Epilogue>
__device__ __forceinline__ void attend_items(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                             const CUtensorMap* vmap,
                                             const int* __restrict__ items, int n_items,
                                             int group, float scale_log2,
                                             unsigned char* smem, RowEnd row_end,
                                             Epilogue epilogue) {
  attend_items_in<D>(qmap, kmap, vmap, items, n_items, group, scale_log2, smem, row_end,
                     [](int) { return 0; }, epilogue);
}

// The float32 online softmax of one query row over keys [begin, end),
// one warp per row, lanes splitting the head dimension (kDPL = D / 32
// elements each, element i of lane l being column l + 32 i; columns at
// or past the true head dim `dv` count as zeros): the unnormalized
// accumulator `o`, the row max `m` (natural-log units of the scaled
// score; -inf when the range is empty) and the row sum `l`.
template <int D>
__device__ __forceinline__ void attend_row_f32(
    const float* __restrict__ qrow, const float* __restrict__ kb,
    const float* __restrict__ vb, long kv_stride, int end, int dv, float scale,
    float (&o)[D / 32], float& m, float& l, int begin = 0) {
  constexpr int kDPL = D / 32;
  const int lane = threadIdx.x % 32;
  float qv[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qv[i] = lane + 32 * i < dv ? qrow[lane + 32 * i] * scale : 0.f;
    o[i] = 0.f;
  }
  m = -INFINITY;
  l = 0.f;
  for (int j = begin; j < end; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      if (lane + 32 * i < dv) dot += qv[i] * kb[j * kv_stride + lane + 32 * i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float m_new = fmaxf(m, dot);
    const float corr = expf(m - m_new);  // 0 on the first key
    const float p = expf(dot - m_new);
    l = l * corr + p;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const float vv = lane + 32 * i < dv ? vb[j * kv_stride + lane + 32 * i] : 0.f;
      o[i] = o[i] * corr + p * vv;
    }
    m = m_new;
  }
}

}  // namespace
