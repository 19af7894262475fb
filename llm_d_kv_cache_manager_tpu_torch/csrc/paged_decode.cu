// One decode step of attention read straight from the paged KV pool,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/paged_decode_pallas.py, reached
// through `paged_decode_attention_pallas`).  Same function: for each
// sequence b and query head h, softmax(q k^T * D^-0.5) v over the
// positions below context_len[b] of the blocks block_table[b] names in
// one layer's pool [num_blocks, 2, block_size, Hkv, D], with the running
// max, sum and accumulator in float32.  The pool's block size is a
// runtime argument (8, 16, 32, 64 or 128), and so is the head dim (a
// multiple of 16 from 32 to 256) and the group H / Hkv (1 to 16).
//
// What bounds it on an H100: every K/V byte of the context is read once
// for about one multiply-add per element and query head of its group,
// so it is memory-bound (the contexts' K and V over 3.35 TB/s; the
// arithmetic is a fifth of that time even on float32 CUDA cores).  The
// design is therefore about bytes in flight and an even spread:
//
// * Work split on the device, from the lengths.  The unit of work is
//   one key tile of 16 tokens of one KV head, whatever the pool's block
//   size: a tile lies inside one pool block of 16 or more tokens, and
//   spans two blocks of 8.  The units of all sequences, in (KV head,
//   sequence, tile) order, form one line of
//   Hkv * sum_b ceil(min(context_len[b], max_blocks * block_size) / 16)
//   units, which the grid's CTAs cut into equal runs: CTA c takes units
//   [c * per, (c + 1) * per).  (KV head outermost, so that the pieces of
//   a short sequence, each a pipeline fill of its own, fall into Hkv
//   different runs.)  The grid is one wave (SMs x resident CTAs)
//   whatever the lengths, so ragged batches spread as evenly as uniform
//   ones and the host plan needs shapes only.  A run crosses (sequence,
//   KV head) boundaries; each stretch of it inside one pair is a
//   *piece*.  `ops/paged_decode_cuda.py:work_items` mirrors this
//   arithmetic.
// * Bytes in flight.  A warp owns a ring of shared-memory stages, each
//   one tile's K and V for the KV head (8 KB at D 128 bf16), filled by
//   16-byte `cp.async` of all its lanes; the warps of a CTA take the
//   tiles of a piece in turn.  V arrives with K, so nothing waits for a
//   softmax, and warps run free of each other: a stage is guarded by
//   `cp.async.wait_group` and `__syncwarp` alone.  One fat CTA an SM, 8
//   warps of 2 stages (128 KB, 64 KB on their way while the other 64 KB
//   are multiplied), was the fastest split measured: a tile's chain of
//   dependent `ldmatrix` and `mma` is long, so more warps hide it better
//   than deeper rings do (4 warps of 4 stages took a sixth longer), and
//   more, smaller CTAs an SM leave more partials to merge (2 warps of 4
//   stages, 3 CTAs an SM: three quarters longer).  Wider rows keep the
//   two stages and take fewer warps (6 at D 256 bf16).  TMA filling the
//   same rings (two 4 KB boxes a block over a 5-D map of the layer's
//   pool, a full `mbarrier` a stage) measured within 1.5% of `cp.async`
//   at every shape, the lanes' own copies not being what the kernel
//   waits for, so `cp.async`, which float32 rows need anyway, is the one
//   load path.  `hack/attention_kernel_ab.py` times these variants,
//   built from `hack/kernel_variants/paged_decode_options.cu`.
// * Pool blocks of 8 tokens.  A tile then spans two blocks, so its
//   variant (kHalves) reads two table entries a tile, the second only
//   when a token of it is live, and copies each half from its block;
//   blocks of 16 or more take one entry and one copy a tile.
// * Head dims.  A kernel is compiled for a width D, a multiple of 64
//   (64, 128, 192, 256), and serves every head dim dv in (D - 64, D]:
//   a stage keeps rows of D elements, the copies fill the first dv, and
//   the columns past dv are zeros (written when a piece starts), as are
//   Q's, so they add nothing to a score and give zero columns of O,
//   which are not written.
// * Dot products on the tensor cores (bf16), route (a) of the two that
//   fit: `mma.sync.m16n8k16` with the G query heads of the KV head as
//   the M rows (for G <= 8, rows G..15 are zero and their results are
//   dropped; above 8 the second half of the rows is live, one more
//   accumulator a lane): S[16 x 16 tokens] = Q K^T with K read by
//   `ldmatrix` from a stage swizzled by 16-byte chunk (chunk ^ row % 8),
//   scaled in float32; O[16 x D] += P V with V through
//   `ldmatrix.trans`.  P stays float32 in effect: it enters the product
//   as a high and a low bf16 part (two `mma`s), so the result is within
//   2^-16 of the float32 product and the port's limit for this kernel
//   stands.  A tile costs a warp 2 shuffles (the row max over a quad)
//   where the lane-per-dim layout took 640.  `wgmma` wants M = 64: seven
//   eighths of it would multiply zeros, and its operand descriptors buy
//   nothing for a kernel that waits on memory.  float32 inputs keep
//   CUDA-core arithmetic (a lane per D/32 dims, 4 tokens at a time,
//   a butterfly per score) over the same ring; on bf16 that engine took
//   a quarter longer than the tensor cores.  The float32 engine holds
//   at most kSimtHeads<D> heads' state a lane: a larger group is cut
//   into sub-groups of equal size, each its own line of units over the
//   same K and V (the host picks the cut, `ops/paged_decode_cuda.py:
//   head_split`).
// * One kernel.  A CTA merges its warps' states in shared memory.  A
//   piece that is a whole (sequence, KV head) writes the output; else
//   the CTA writes an unnormalized partial (at most two a CTA: its
//   run's first and last piece), and the last CTA of the pair to arrive
//   (a counter after `__threadfence`) merges the pair's partials by
//   log-sum-exp.  The C entry zeroes the counters with a memset on the
//   same stream before the launch, so a replayed graph starts clean.
//
// The kernel reads the block table itself and never reads an entry at
// or past ceil(context_len / block_size): the tail of the table may hold
// anything.  Block ids are clamped into the pool.  context_len 0 gives
// 0, as the TPU kernel does.
//
// A sliding window of W positions (`window` > 0, a runtime argument; 0
// is none), for the windowed layers of a mixed model (Mellum's): a row
// attends to positions [ctx - W, ctx) alone.  Its units then start at
// the tile that holds position ctx - W, so the tiles below it are not in
// the line of units at all: never read, and no table entry of theirs is
// read either (with blocks of 8, the first tile's lower block is skipped
// when it lies wholly below the window).  The tokens of that first tile
// below ctx - W are masked as the ones past the context are.  The
// reference has no window.
//
// C interface for ctypes; every entry returns cudaGetLastError().

#include "attention_tiles.cuh"  // smem_u32

namespace {

constexpr int kTok = 16;  // tokens a key tile (a unit of work)
constexpr int kWarpsWanted = 8;   // warps a CTA
constexpr int kStagesWanted = 2;  // shared-memory stages a warp
constexpr int kRingBudget = 200 * 1024;  // shared memory for a CTA's rings
constexpr float kLog2e = 1.4426950408889634f;

// Heads of a group the float32 engine keeps a lane: its state is
// 2 * kSimtHeads * D / 32 registers.
template <int D>
constexpr int kSimtHeads = 1024 / D;

template <typename T, int D>
struct Tile {
  static constexpr int row_bytes = D * static_cast<int>(sizeof(T));
  static constexpr int chunks = row_bytes / 16;  // 16-byte chunks a row
  static constexpr int half_bytes = kTok * row_bytes;  // a tile's K (or V)
  static constexpr int stage_bytes = 2 * half_bytes;
  // kWarpsWanted warps of kStagesWanted stages, or what fits: fewer
  // stages first (never under 2), then fewer warps.
  static constexpr int most = kRingBudget / (2 * stage_bytes);
  static constexpr int warps = kWarpsWanted <= most ? kWarpsWanted : most;
  static constexpr int fit = kRingBudget / (warps * stage_bytes);
  static constexpr int stages = kStagesWanted <= fit ? kStagesWanted : fit;
  static constexpr int threads = warps * 32;
  static constexpr int smem = warps * stages * stage_bytes;
  // Byte offset in a stage of 16-byte chunk c of row t of K (kv = 0) or
  // V (kv = 1): rows whole, K before V, the chunks of a row swizzled by
  // t % 8 against bank conflicts.
  static __device__ __forceinline__ int offset(int kv, int t, int c) {
    return kv * half_bytes + t * row_bytes + ((c ^ (t & 7)) << 4);
  }
  static_assert(chunks % 8 == 0, "the swizzle permutes 8 chunks of a row");
  static_assert(kStagesWanted >= 2 && warps >= 1, "a ring needs two stages");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One warp copies K and V of one key tile for one KV head into a
// stage.  In a pool block of 16 or more tokens (kHalves false) the
// tile's rows are consecutive from `lo`, K's row of its first token for
// that head.  Over two blocks of 8 (kHalves), rows 0..7 come from `lo`
// and rows 8..15 from `hi` (null: no token of it is live, nothing is
// read).  Rows are `tok_bytes` apart and a row's V lies `v_off` bytes
// after its K.  Only the first `dchunks` 16-byte chunks of a row (the
// true head dim) are copied.
template <typename T, int D, bool kHalves>
__device__ __forceinline__ void load_tile(uint32_t stage, const char* lo, const char* hi,
                                          long tok_bytes, long v_off, int dchunks, int lane) {
  using Tl = Tile<T, D>;
  constexpr int kTotal = 2 * kTok * Tl::chunks;
  const char* vlo = lo + v_off;
#pragma unroll
  for (int i = 0; i < kTotal / 32; ++i) {
    const int idx = i * 32 + lane;
    const int c = idx % Tl::chunks;
    const int row = idx / Tl::chunks;  // 0..31: K's rows, then V's
    const int t = row % kTok;
    // Two address forms: ptxas keeps each variant's registers (174 for
    // the serving kernel, 212 at blocks of 8) only with its own.
    if constexpr (kHalves) {
      const char* src = t < 8 ? lo : hi;
      if (c < dchunks && src != nullptr) {
        cp_async16(stage + Tl::offset(row / kTok, t, c),
                   src + (t & 7) * tok_bytes + (row / kTok) * v_off + c * 16);
      }
    } else if (c < dchunks) {
      cp_async16(stage + Tl::offset(row / kTok, t, c),
                 (row < kTok ? lo : vlo) + t * tok_bytes + c * 16);
    }
  }
}

// Zero V's rows outside [lo, valid): a slot past the context, or one
// below the window that was not loaded, may hold anything, and 0 * NaN
// is no 0.
template <typename T, int D>
__device__ __forceinline__ void zero_stale_rows(char* stage, int lo, int valid, int lane) {
  using Tl = Tile<T, D>;
  for (int idx = lane; idx < kTok * Tl::chunks; idx += 32) {
    const int t = idx / Tl::chunks;
    if (t < lo || t >= valid) {
      *reinterpret_cast<uint4*>(stage + Tl::offset(1, t, idx % Tl::chunks)) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// Zero the chunks past the true head dim of every row of a warp's ring.
template <typename T, int D>
__device__ __forceinline__ void zero_pad_chunks(char* ring, int stages, int dchunks,
                                                int lane) {
  using Tl = Tile<T, D>;
  const int pad = Tl::chunks - dchunks;
  for (int idx = lane; idx < stages * 2 * kTok * pad; idx += 32) {
    const int c = dchunks + idx % pad;
    const int row = idx / pad;  // (stage, kv, t)
    *reinterpret_cast<uint4*>(ring + (row / (2 * kTok)) * Tl::stage_bytes +
                              Tl::offset((row / kTok) % 2, row % kTok, c)) =
        make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[0..1] += A B for rows 0..7 of an m16n8k16 bf16 product whose A rows
// 8..15 are zero: a_lo holds k 0..7 of this lane's row, a_hi k 8..15.
__device__ __forceinline__ void mma_top_rows(float& c0, float& c1,
                                             uint32_t a_lo, uint32_t a_hi,
                                             uint32_t b0, uint32_t b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%5}, {%7,%8}, {%0,%1,%9,%9};"
      : "+f"(c0), "+f"(c1), "=f"(d2), "=f"(d3)
      : "r"(a_lo), "r"(0u), "r"(a_hi), "r"(b0), "r"(b1), "f"(0.f));
}

// d[0..3] += A B, a whole m16n8k16 bf16 product: a0/a2 hold k 0..7 /
// 8..15 of this lane's row g, a1/a3 the same of row g + 8; d[0..1] is
// row g, d[2..3] row g + 8.
__device__ __forceinline__ void mma_rows16(float (&d)[4], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B over the live halves of A's rows (kH = 1: rows 0..7, the
// others zero; kH = 2: all 16).  a[h + kH * j] holds k 8j..8j+7 of this
// lane's row g + 8h, and d[2h + {0, 1}] that row's two columns.
template <int kH>
__device__ __forceinline__ void mma_rows(float (&d)[2 * kH], const uint32_t (&a)[2 * kH],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kH == 1) {
    mma_top_rows(d[0], d[1], a[0], a[1], b0, b1);
  } else {
    mma_rows16(d, a[0], a[1], a[2], a[3], b0, b1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// A warp's state over the tiles it takes of one piece, bf16 on the
// tensor cores.  The group's query heads are the M rows of the
// product: Rows = 8 for G <= 8 (rows G..15 zero, their results
// dropped), 16 for 9 to 16.  Lane 4 * g + c holds, for head g + 8 h of
// the group (h < Rows / 8), the columns 8 * n + 2 * c + {0, 1} of O and
// a quarter of the row sum.
template <int D, int Rows>
struct MmaEngine {
  using T = __nv_bfloat16;
  using Tl = Tile<T, D>;
  static constexpr int kH = Rows / 8;  // live halves of the rows
  static constexpr int kSteps = D / 16;
  static constexpr int kTiles = D / 8;
  static constexpr int kHeads = Rows;  // most heads of a group
  uint32_t qa[kSteps][2 * kH];  // Q's A fragment of k step k, as mma_rows takes it
  float o[kTiles][2 * kH];      // [2 h + {0, 1}]: head g + 8 h
  float m[kH], l[kH];

  // q: the group's G query rows of dv elements; columns past dv are 0.
  __device__ __forceinline__ void init(const T* q, int G, int dv, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const T* p = q + (g + 8 * h) * dv + k * 16 + 2 * c;
        const bool live = g + 8 * h < G && k * 16 < dv;
        qa[k][h] = live ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        qa[k][kH + h] = live ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
      }
    }
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2 * kH; ++e) o[n][e] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
  }

  // One tile whose tokens [start, valid) are live, from a stage; scores
  // are kept in log2 units (scale_log2 = dv^-0.5 * log2 e).
  __device__ __forceinline__ void block(char* stage, int start, int valid,
                                        float scale_log2, int lane) {
    const uint32_t base = smem_u32(stage);
    const int mat = lane >> 3, r = lane & 7;
    // s[n][2 h + i]: token 8 n + 2 c + i of head g + 8 h.
    float s[2][2 * kH] = {};
    {
      // Even and odd k steps add up apart: two chains of half the length.
      float odd[2][2 * kH] = {};
      const int t = r + 8 * (mat >> 1);
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        uint32_t b[4];
        ldmatrix_x4(b, base + Tl::offset(0, t, 2 * k + (mat & 1)));
        float(&to)[2][2 * kH] = k % 2 ? odd : s;
        mma_rows<kH>(to[0], qa[k], b[0], b[1]);
        mma_rows<kH>(to[1], qa[k], b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2 * kH; ++e) s[n][e] += odd[n][e];
      }
    }
    const int c = lane & 3;
    float corr[kH];
    uint32_t hi[2 * kH], lo[2 * kH];  // P's A fragment: [h + kH * n], token half n
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * h + i];
          const int tok = 8 * n + 2 * c + i;
          x = tok >= start && tok < valid ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, m[h]);  // finite: a tile has a live token
      corr[h] = exp2f(m[h] - mx);  // 0 on the first tile
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float p0 = exp2f(s[n][2 * h] - mx), p1 = exp2f(s[n][2 * h + 1] - mx);
        sum += p0 + p1;
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
        hi[h + kH * n] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[h + kH * n] = pack_bf16(p0 - __low2float(ph), p1 - __high2float(ph));
      }
      l[h] = l[h] * corr[h] + sum;
    }
    {
      const int t = r + 8 * (mat & 1);
#pragma unroll
      for (int n = 0; n < kTiles; n += 2) {
        uint32_t v[4];
        ldmatrix_x4_trans(v, base + Tl::offset(1, t, n + (mat >> 1)));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2 * kH; ++e) o[n + i][e] *= corr[e / 2];
          // P enters as a high and a low bf16 part.
          mma_rows<kH>(o[n + i], hi, v[2 * i], v[2 * i + 1]);
          mma_rows<kH>(o[n + i], lo, v[2 * i], v[2 * i + 1]);
        }
      }
    }
  }

  // The warp's unnormalized (acc [G, D], then (m, l) [G, 2]) to `area`.
  __device__ __forceinline__ void finish(float* area, int G, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = g + 8 * h;
      if (row < G) {
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          *reinterpret_cast<float2*>(area + row * D + n * 8 + 2 * c) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
        }
        if (c == 0) {
          area[G * D + 2 * row] = m[h];
          area[G * D + 2 * row + 1] = sum;
        }
      }
    }
  }
};

// The same state on CUDA cores, for float32 pools: lane i holds dims
// [i * D/32, (i + 1) * D/32) of each of the group's first G <=
// kSimtHeads<D> heads (the host cuts a larger group) and takes the
// tokens of a tile four at a time.
template <int D>
struct SimtEngine {
  using T = float;
  using Tl = Tile<T, D>;
  static constexpr int kDPL = D / 32;
  static constexpr int kHeads = kSimtHeads<D>;
  float qv[kHeads][kDPL], acc[kHeads][kDPL], m[kHeads], l[kHeads];

  __device__ __forceinline__ void init(const T* q, int G, int dv, int lane) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane * kDPL + i;
        qv[g][i] = g < G && d < dv ? q[g * dv + d] : 0.f;
        acc[g][i] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
  }

  // This lane's kDPL elements of row t of K (kv = 0) or V (kv = 1).
  __device__ __forceinline__ void row(const char* stage, int kv, int t, int lane,
                                      float (&x)[kDPL]) {
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane * kDPL + i;  // 4 floats a chunk
      x[i] = *reinterpret_cast<const T*>(stage + Tl::offset(kv, t, d >> 2) + (d & 3) * 4);
    }
  }

  __device__ __forceinline__ void block(char* stage, int start, int valid,
                                        float scale_log2, int lane) {
    // From the group of 4 that holds token start: every group then has a
    // live token, so the running max is finite.
    for (int t0 = start & ~3; t0 < valid; t0 += 4) {
      float s[kHeads][4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        float kr[kDPL];
        row(stage, 0, t0 + tt, lane, kr);
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) dot += qv[g][i] * kr[i];
          s[g][tt] = dot;
        }
      }
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float mx = m[g];
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s[g][tt] += __shfl_xor_sync(0xffffffffu, s[g][tt], off);
          }
          s[g][tt] = t0 + tt >= start && t0 + tt < valid ? s[g][tt] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[g][tt]);
        }
        const float corr = exp2f(m[g] - mx);  // 0 on the first tile
        m[g] = mx;
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[g][i] *= corr;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          s[g][tt] = exp2f(s[g][tt] - mx);
          l[g] += s[g][tt];
        }
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        float vr[kDPL];
        row(stage, 1, t0 + tt, lane, vr);
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
#pragma unroll
          for (int i = 0; i < kDPL; ++i) acc[g][i] += s[g][tt] * vr[i];
        }
      }
    }
  }

  __device__ __forceinline__ void finish(float* area, int G, int lane) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) area[g * D + lane * kDPL + i] = acc[g][i];
      if (lane == 0) {
        area[G * D + 2 * g] = m[g];
        area[G * D + 2 * g + 1] = l[g];
      }
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// exp2(m - mx), 0 for an empty state (m = -inf), whatever mx is.
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

struct Args {
  const void* q;
  const void* kv;
  const int* table;
  const int* context_len;
  float* part_acc;  // [ctas, 2, G, dv]
  float* part_ml;   // [ctas, 2, G, 2]
  int* counters;    // [B, lines], zero at launch
  void* out;
  int B, Hkv, num_blocks, max_blocks;
  int G;       // query heads a line: the group, or a float32 sub-group
  int nsub;    // lines a KV head (G * nsub = H / Hkv)
  int lines;   // Hkv * nsub
  int dv;      // the true head dim
  int dchunks;  // its 16-byte chunks a row
  int bs, lg_bs;  // pool block size and its log2
  int window;     // sliding window in positions; 0: none
  float scale_log2;
};

// Tokens of sequence b the kernel reads: its context, cut at the table.
__device__ __forceinline__ int context_of(const Args& a, int b) {
  return min(a.context_len[b], a.max_blocks * a.bs);
}

// The first position sequence b attends to: 0, or under a window the
// first of the window's.
__device__ __forceinline__ int window_start(const Args& a, int ctx) {
  return a.window > 0 ? max(ctx - a.window, 0) : 0;
}

// Tiles of sequence b the kernel reads: from the one that holds its
// window's start to the one that holds its last position.
__device__ __forceinline__ int live_tiles(const Args& a, int b) {
  const int ctx = context_of(a, b);
  return ctx <= 0 ? 0 : (ctx + kTok - 1) / kTok - window_start(a, ctx) / kTok;
}

// Tiles [j0, j1) of sequence b and line `line`, whose units are
// [seg_start, seg_start + nb) of the line; this CTA's run starts at
// unit run_start and every run is `per` units long.
template <typename Engine, int D, bool kHalves>
__device__ __forceinline__ void piece(const Args& a, char* smem, int b, int line, int j0,
                                      int j1, int nb, int seg_start, int run_start,
                                      int per) {
  using T = typename Engine::T;
  using Tl = Tile<T, D>;
  constexpr int kStages = Tl::stages, kWarps = Tl::warps, kThreads = Tl::threads;
  static_assert(Engine::kHeads * (D + 2) * 4 <= kStages * Tl::stage_bytes,
                "a warp's state fits its ring");
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.G, dv = a.dv;
  const int H = a.lines * G;
  const int kvh = a.nsub == 1 ? line : line / a.nsub;
  const int ctx = context_of(a, b);
  const int win_lo = window_start(a, ctx);  // positions below it are not attended
  const int tile0 = win_lo / kTok;          // the sequence's unit 0
  char* ring = smem + warp * kStages * Tl::stage_bytes;
  const uint32_t ring_addr = smem_u32(ring);
  if (a.dchunks < Tl::chunks) {
    zero_pad_chunks<T, D>(ring, kStages, a.dchunks, lane);
    __syncwarp();
  }

  Engine eng;
  eng.init(static_cast<const T*>(a.q) + (static_cast<long>(b) * H + line * G) * dv, G, dv,
           lane);

  // This warp takes tiles j0 + warp, j0 + warp + kWarps, ... (units of
  // the sequence, tile0 + j being tile j's position / 16).
  const int first = tile0 + j0 + warp, end = tile0 + j1;
  const int n = first < end ? (end - first + kWarps - 1) / kWarps : 0;
  const int* trow = a.table + static_cast<long>(b) * a.max_blocks;
  const long tok_bytes = static_cast<long>(a.Hkv) * dv * sizeof(T);
  const long v_off = a.bs * tok_bytes;  // a token's V row after its K row
  const long blk_bytes = 2 * v_off;
  const char* head = static_cast<const char*>(a.kv) + static_cast<long>(kvh) * dv * sizeof(T);
  // The table entries of tile i: one, or with blocks of 8 tokens
  // (kHalves) two, the second only if a token of it is live; read one
  // fetch ahead.
  auto ids = [&](int i, int& lo, int& hi) {
    const int p = (first + i * kWarps) * kTok;
    if constexpr (kHalves) {
      lo = p + 8 > win_lo ? trow[p >> a.lg_bs] : 0;
      hi = p + 8 < ctx ? trow[(p >> a.lg_bs) + 1] : 0;
    } else {
      lo = trow[p >> a.lg_bs];
    }
  };
  int next_lo = 0, next_hi = 0;
  if (n > 0) ids(0, next_lo, next_hi);
  auto fetch = [&](int i) {
    const int p = (first + i * kWarps) * kTok;
    const int lo = min(max(next_lo, 0), a.num_blocks - 1);
    const int hi = min(max(next_hi, 0), a.num_blocks - 1);
    const uint32_t stage = ring_addr + (i % kStages) * Tl::stage_bytes;
    if (i + 1 < n) ids(i + 1, next_lo, next_hi);
    if constexpr (kHalves) {
      load_tile<T, D, true>(stage, p + 8 <= win_lo ? nullptr : head + lo * blk_bytes,
                            p + 8 >= ctx ? nullptr : head + hi * blk_bytes, tok_bytes, v_off,
                            a.dchunks, lane);
    } else {
      // A tile inside one block: rows past the context are slots of it,
      // read and then masked (K) or zeroed (V).
      load_tile<T, D, false>(stage, head + lo * blk_bytes + (p & (a.bs - 1)) * tok_bytes,
                             nullptr, tok_bytes, v_off, a.dchunks, lane);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // One `s` for the loop's body: with i % kStages written out at each
    // use ptxas took 254 registers for 176 and spilled at G < 8.
    const int s = i % kStages;
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile i has landed; the stage of tile i - 1 is free
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    char* stage = ring + s * Tl::stage_bytes;
    const int p = (first + i * kWarps) * kTok;
    const int valid = min(kTok, ctx - p);
    const int lo = max(win_lo - p, 0);
    if (valid < kTok || lo > 0) {
      zero_stale_rows<T, D>(stage, lo, valid, lane);
      __syncwarp();
    }
    eng.block(stage, lo, valid, a.scale_log2, lane);
  }
  cp_async_wait<0>();
  __syncwarp();
  // The ring is drained: it carries the warp's state.
  eng.finish(reinterpret_cast<float*>(ring), G, lane);
  __syncthreads();

  const bool whole = j0 == 0 && j1 == nb;
  const int slot = seg_start >= run_start ? 1 : 0;
  const long mine = (static_cast<long>(blockIdx.x) * 2 + slot) * G;
  T* out = static_cast<T*>(a.out) + (static_cast<long>(b) * H + line * G) * dv;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    if (d >= dv) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* area = reinterpret_cast<const float*>(smem + w * kStages * Tl::stage_bytes);
      mx = fmaxf(mx, area[G * D + 2 * g]);
    }
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* area = reinterpret_cast<const float*>(smem + w * kStages * Tl::stage_bytes);
      const float wt = weight(area[G * D + 2 * g], mx);
      acc += area[g * D + d] * wt;
      sum += area[G * D + 2 * g + 1] * wt;
    }
    if (whole) {
      store(out + g * dv + d, sum > 0.f ? acc / sum : 0.f);
    } else {
      a.part_acc[(mine + g) * dv + d] = acc;
      if (d == 0) {
        a.part_ml[(mine + g) * 2] = mx;
        a.part_ml[(mine + g) * 2 + 1] = sum;
      }
    }
  }
  if (!whole) {
    // The pair's CTAs: those whose runs meet [seg_start, seg_start + nb).
    const int first_cta = seg_start / per, last_cta = (seg_start + nb - 1) / per;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int arrived = atomicAdd(a.counters + b * a.lines + line, 1);
      s_last = arrived == last_cta - first_cta;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      // The pair's partials: its first CTA's second slot (the pair
      // starts inside that CTA's run, so it is the run's last piece),
      // then the first slot of every later CTA of the pair.  Their
      // (m, l) go to shared memory first, all at once (the rings are
      // read by now), so that an element's pass reads one accumulator a
      // partial from device memory; a pair may span dozens of CTAs.
      // (parts <= gridDim.x, at most 132 x the CTAs an SM holds, which
      // shared memory bounds: the (m, l) take under half of it.)
      const int parts = last_cta - first_cta + 1;
      auto slot_of = [&](int i, int g) {
        return (static_cast<long>(first_cta + i) * 2 + (i == 0 ? 1 : 0)) * G + g;
      };
      float2* ml = reinterpret_cast<float2*>(smem);  // [parts, G]
      for (int j = threadIdx.x; j < parts * G; j += kThreads) {
        ml[j] = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + slot_of(j / G, j % G));
      }
      __syncthreads();
      for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int g = e / D, d = e % D;
        if (d >= dv) continue;
        float mx = -INFINITY;
        for (int i = 0; i < parts; ++i) mx = fmaxf(mx, ml[i * G + g].x);
        float acc = 0.f, sum = 0.f;
        for (int i = 0; i < parts; ++i) {
          const float wt = weight(ml[i * G + g].x, mx);
          acc += __ldcg(a.part_acc + slot_of(i, g) * dv + d) * wt;
          sum += ml[i * G + g].y * wt;
        }
        store(out + g * dv + d, sum > 0.f ? acc / sum : 0.f);
      }
    }
  }
  __syncthreads();  // the states are read: the rings may fill again
}

template <typename Engine, int D, bool kHalves>
__device__ __forceinline__ void decode_body(const Args& a) {
  extern __shared__ __align__(128) char smem[];
  using T = typename Engine::T;
  constexpr int kThreads = Tile<T, D>::threads;
  const int H = a.lines * a.G;
  int live = 0;  // live tiles of all sequences, for one line
  for (int b = 0; b < a.B; ++b) live += live_tiles(a, b);
  // An empty context gives 0.
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (live_tiles(a, b) == 0) {
      T* out = static_cast<T*>(a.out) + static_cast<long>(b) * H * a.dv;
      for (int e = threadIdx.x; e < H * a.dv; e += kThreads) store(out + e, 0.f);
    }
  }
  const int total = live * a.lines;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int run_start = blockIdx.x * per;
  const int run_end = min(run_start + per, total);
  int at = run_start;
  while (at < run_end) {
    const int line = at / live;
    int seg_start = line * live;  // the first unit of (line, sequence b)
    for (int b = 0; b < a.B && at < run_end; ++b) {
      const int nb = live_tiles(a, b);
      if (at < seg_start + nb) {
        const int stop = min(run_end, seg_start + nb);
        piece<Engine, D, kHalves>(a, smem, b, line, at - seg_start, stop - seg_start, nb, seg_start,
                         run_start, per);
        at = stop;
      }
      seg_start += nb;
    }
  }
}

// Rows: 8 for groups of up to 8 heads, 16 for 9 to 16.  kHalves: pool
// blocks of 8 tokens, a tile over two of them.
template <int D, int Rows, bool kHalves>
__global__ void __launch_bounds__(Tile<__nv_bfloat16, D>::threads)
    paged_decode_bf16_kernel(const Args a) {
  decode_body<MmaEngine<D, Rows>, D, kHalves>(a);
}

template <int D, bool kHalves>
__global__ void __launch_bounds__(Tile<float, D>::threads)
    paged_decode_f32_kernel(const Args a) {
  decode_body<SimtEngine<D>, D, kHalves>(a);
}

// Calls f(kernel, its Tile) for the variant that serves head dim dv, a
// line of G heads and pool blocks of bs tokens, or returns
// cudaErrorInvalidValue where there is none.
template <typename F>
int with_variant(int dtype, int dv, int G, int bs, F&& f) {
#define DECODE_VARIANT(DD, HALVES)                                                      \
  if (compiled_width(dv) == DD && (bs < kTok) == HALVES) {                              \
    if (dtype == 0) {                                                                   \
      if (G > kSimtHeads<DD>) return static_cast<int>(cudaErrorInvalidValue);           \
      return f(paged_decode_f32_kernel<DD, HALVES>, Tile<float, DD>{});                 \
    }                                                                                   \
    return G <= 8 ? f(paged_decode_bf16_kernel<DD, 8, HALVES>, Tile<__nv_bfloat16, DD>{}) \
                  : f(paged_decode_bf16_kernel<DD, 16, HALVES>,                         \
                      Tile<__nv_bfloat16, DD>{});                                       \
  }
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(dv) || G < 1 || G > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DECODE_VARIANT(64, false)
  DECODE_VARIANT(128, false)
  DECODE_VARIANT(192, false)
  DECODE_VARIANT(256, false)
  DECODE_VARIANT(64, true)
  DECODE_VARIANT(128, true)
  DECODE_VARIANT(192, true)
  DECODE_VARIANT(256, true)
#undef DECODE_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr long align16(long n) { return (n + 15) / 16 * 16; }

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// CTAs of the variant for head dim D, a line of G heads and pool blocks
// of block_size tokens that one SM holds at once (dtype 0 = float32,
// 1 = bfloat16), or minus the CUDA error.
int paged_decode_ctas_per_sm(int D, int G, int block_size, int dtype) {
  int resident = 0;
  const int rc = with_variant(dtype, D, G, block_size, [&](auto kernel, auto tile) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile.smem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        tile.threads, tile.smem);
    }
    return static_cast<int>(e);
  });
  return rc != 0 ? -rc : resident;
}

// Bytes of scratch a launch of `ctas` CTAs needs over `lines` lines of
// G heads: the counters, then the partials' (m, l), then their
// accumulators.
long paged_decode_scratch_bytes(int B, int lines, int G, int D, int ctas) {
  return align16(4L * B * lines) + align16(4L * ctas * 2 * G * 2) +
         4L * ctas * 2 * G * D;
}

// q: [B, H, D]; kv: [num_blocks, 2, block_size, Hkv, D]; table: int32
// [B, max_blocks]; context_len: int32 [B]; scratch:
// paged_decode_scratch_bytes(B, Hkv * nsub, H / Hkv / nsub, D, ctas),
// 16-byte aligned; out: [B, H, D]; all contiguous.  dtype 0 = float32,
// 1 = bfloat16; D a multiple of 16 from 32 to 256; H / Hkv from 1 to
// 16; block_size 8, 16, 32, 64 or 128.  `nsub` cuts each group into
// that many lines of equal size (1 for bfloat16; for float32 a line
// has at most kSimtHeads<compiled_width(D)> heads).  `ctas` is the
// grid: a whole number of waves of paged_decode_ctas_per_sm.  `window`
// > 0: each row attends to its last `window` positions alone; 0: all.
int paged_decode(const void* q, const void* kv, const void* table,
                 const void* context_len, void* scratch, void* out, int B,
                 int H, int Hkv, int D, int block_size, int num_blocks,
                 int max_blocks, int ctas, int nsub, int window, int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || ctas <= 0 || nsub <= 0 || (H / Hkv) % nsub != 0 ||
      window < 0 ||
      (dtype == 1 && nsub != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lg_bs = -1;
  for (int l = 3; l <= 7; ++l) {
    if (block_size == 1 << l) lg_bs = l;
  }
  if (lg_bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv / nsub;
  const int lines = Hkv * nsub;
  char* base = static_cast<char*>(scratch);
  Args a;
  a.q = q;
  a.kv = kv;
  a.table = static_cast<const int*>(table);
  a.context_len = static_cast<const int*>(context_len);
  a.counters = reinterpret_cast<int*>(base);
  a.part_ml = reinterpret_cast<float*>(base + align16(4L * B * lines));
  a.part_acc = reinterpret_cast<float*>(base + align16(4L * B * lines) +
                                        align16(4L * ctas * 2 * G * 2));
  a.out = out;
  a.B = B;
  a.Hkv = Hkv;
  a.num_blocks = num_blocks;
  a.max_blocks = max_blocks;
  a.G = G;
  a.nsub = nsub;
  a.lines = lines;
  a.dv = D;
  a.dchunks = D * (dtype == 1 ? 2 : 4) / 16;
  a.bs = block_size;
  a.lg_bs = lg_bs;
  a.window = window;
  a.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const int rc = with_variant(dtype, D, G, block_size, [&](auto kernel, auto tile) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaMemsetAsync(a.counters, 0, 4L * B * lines, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<ctas, tile.threads, tile.smem, st>>>(a);
    return 0;
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
