// The paged decode kernel with the design options that were measured
// and not taken, kept only so that hack/attention_kernel_ab.py can time
// them beside the kernel in
// llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu; the port does
// not build or call it.  Built with no option it is that kernel.  The
// options: -DDECODE_WARPS=n and -DDECODE_STAGES=n (warps a CTA and
// shared-memory stages a warp), -DDECODE_TMA (the rings filled by TMA
// over a 5-D map of the pool, a full `mbarrier` a stage, instead of
// `cp.async`), -DDECODE_BF16_SIMT (bf16 on the CUDA-core engine instead
// of the tensor cores).  It includes the port's attention_tiles.cuh, so
// it is built with -I on the port's csrc/.  The header of the kernel as
// it stood with these options follows.
//
// One decode step of attention read straight from the paged KV pool,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/paged_decode_pallas.py, reached
// through `paged_decode_attention_pallas`).  Same function: for each
// sequence b and query head h, softmax(q k^T * D^-0.5) v over the
// positions below context_len[b] of the blocks block_table[b] names in
// one layer's pool [num_blocks, 2, 16, Hkv, D], with the running max,
// sum and accumulator in float32.
//
// What bounds it on an H100: every K/V byte of the context is read once
// for about one multiply-add per element and query head of its group,
// so it is memory-bound (the contexts' K and V over 3.35 TB/s; the
// arithmetic is a fifth of that time even on float32 CUDA cores).  The
// design is therefore about bytes in flight and an even spread:
//
// * Work split on the device, from the lengths.  The unit of work is
//   one pool block of one KV head.  The units of all sequences, in
//   (KV head, sequence, block) order, form one line of
//   Hkv * sum_b ceil(context_len[b] / 16) units, which the grid's CTAs
//   cut into equal runs: CTA c takes units [c * per, (c + 1) * per).
//   (KV head outermost, so that the pieces of a short sequence, each a
//   pipeline fill of its own, fall into Hkv different runs.)
//   The grid is one wave (SMs x resident CTAs) whatever the lengths, so
//   ragged batches spread as evenly as uniform ones and the host plan
//   needs shapes only.  A run crosses (sequence, KV head) boundaries;
//   each stretch of it inside one pair is a *piece*.
//   `ops/paged_decode_cuda.py:work_items` mirrors this arithmetic.
// * Bytes in flight.  A warp owns a ring of shared-memory stages, each
//   one pool block's K and V for the KV head (8 KB at D 128 bf16),
//   filled by 16-byte `cp.async` of all its lanes; the warps of a CTA
//   take the blocks of a piece in turn.  V arrives with K, so nothing
//   waits for a softmax, and warps run free of each other: a stage is
//   guarded by `cp.async.wait_group` and `__syncwarp` alone.  One fat
//   CTA an SM, 8 warps of 2 stages (128 KB, 64 KB on their way while
//   the other 64 KB are multiplied), was the fastest split measured:
//   a block's chain of dependent `ldmatrix` and `mma` is long, so more
//   warps hide it better than deeper rings do (4 warps of 4 stages
//   took a sixth longer), and more, smaller CTAs an SM leave more
//   partials to merge (2 warps of 4 stages, 3 CTAs an SM: three
//   quarters longer).  `hack/attention_kernel_ab.py` times these.
//   TMA fills the same rings when built with -DDECODE_TMA (one lane
//   starts two 4 KB boxes a block over a 5-D map of the layer's pool,
//   encoded per launch; a full `mbarrier` a stage): it measured within
//   1.5% of `cp.async` at every shape, the lanes' own copies
//   not being what the kernel waits for, so `cp.async`, which float32
//   rows need anyway, stays the one path the port runs.
// * Dot products on the tensor cores (bf16), route (a) of the two that
//   fit: `mma.sync.m16n8k16` with the G query heads of the KV head as
//   the M rows (rows G..15 are zero and their results are dropped):
//   S[16 x 16 tokens] = Q K^T with K read by `ldmatrix` from a stage
//   swizzled by 16-byte chunk (chunk ^ row % 8, rows being 256 bytes
//   apart), scaled in float32; O[16 x D] += P V with V through
//   `ldmatrix.trans`.  P stays float32 in effect: it enters the product
//   as a high and a low bf16 part (two `mma`s), so the result is within
//   2^-16 of the float32 product and the port's limit for this kernel
//   stands.  A block costs a warp 2 shuffles (the row max over a quad)
//   where the lane-per-dim layout took 640.  `wgmma` wants M = 64: seven
//   eighths of it would multiply zeros, and its operand descriptors buy
//   nothing for a kernel that waits on memory.  float32 inputs keep
//   CUDA-core arithmetic (a lane per D/32 dims, 4 tokens at a time,
//   a butterfly per score) over the same ring; built for bf16 with
//   -DDECODE_BF16_SIMT it took a quarter longer than the tensor cores.
// * One kernel.  A CTA merges its warps' states in shared memory.  A
//   piece that is a whole (sequence, KV head) writes the output; else
//   the CTA writes an unnormalized partial (at most two a CTA: its
//   run's first and last piece), and the last CTA of the pair to arrive
//   (a counter after `__threadfence`) merges the pair's partials by
//   log-sum-exp.  The C entry zeroes the counters with a memset on the
//   same stream before the launch, so a replayed graph starts clean.
//
// The kernel reads the block table itself and never reads an entry at
// or past ceil(context_len / 16): the tail of the table may hold
// anything.  Block ids are clamped into the pool.  context_len 0 gives
// 0, as the TPU kernel does.
//
// C interface for ctypes; every entry returns cudaGetLastError().

#include "attention_tiles.cuh"  // mbarrier helpers, the tensor-map encoder

#ifndef DECODE_WARPS
#define DECODE_WARPS 8
#endif
#ifndef DECODE_STAGES
#define DECODE_STAGES 2
#endif

namespace {

constexpr int kBS = 16;  // tokens a pool block
constexpr int kRingBudget = 200 * 1024;  // shared memory for a CTA's rings
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Tile {
  static constexpr int row_bytes = D * static_cast<int>(sizeof(T));
  static constexpr int chunks = row_bytes / 16;  // 16-byte chunks a row
  static constexpr int half_bytes = kBS * row_bytes;  // a block's K (or V)
  static constexpr int stage_bytes = 2 * half_bytes;
  // DECODE_WARPS warps of DECODE_STAGES stages, or what fits: fewer
  // stages first (never under 2), then fewer warps.
  static constexpr int most = kRingBudget / (2 * stage_bytes);
  static constexpr int warps = DECODE_WARPS <= most ? DECODE_WARPS : most;
  static constexpr int fit = kRingBudget / (warps * stage_bytes);
  static constexpr int stages = DECODE_STAGES <= fit ? DECODE_STAGES : fit;
  static constexpr int threads = warps * 32;
#ifdef DECODE_TMA
  static constexpr bool tma = sizeof(T) == 2;  // bf16 stages filled by TMA
#else
  static constexpr bool tma = false;
#endif
  // A TMA box is 128 bytes of each of a block's 32 rows (the widest the
  // 128-byte swizzle takes), so a block is row_bytes / 128 boxes.
  static constexpr int box_bytes = 2 * kBS * 128;
  // 1024 bytes of slack to align the rings to the swizzle atom.
  static constexpr int smem = warps * stages * stage_bytes + (tma ? 1024 : 0);
  // Byte offset in a stage of 16-byte chunk c of row t of K (kv = 0) or
  // V (kv = 1), swizzled by t % 8 against bank conflicts: rows whole
  // and K before V under cp.async; under TMA box by box, each box K's
  // 16 then V's 16 rows of 128 bytes, which is the 128-byte swizzle.
  static __device__ __forceinline__ int offset(int kv, int t, int c) {
    if constexpr (tma) {
      return (c >> 3) * box_bytes + (kv * kBS + t) * 128 + (((c & 7) ^ (t & 7)) << 4);
    } else {
      return kv * half_bytes + t * row_bytes + ((c ^ (t & 7)) << 4);
    }
  }
  static_assert(chunks >= 8, "the swizzle permutes 8 chunks of a row");
  static_assert(DECODE_STAGES >= 2 && warps >= 1, "a ring needs two stages");
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

// One warp copies K and V of one pool block for one KV head into a
// stage.  `src` points at K's row 0 for that head; rows are
// `tok_bytes` apart and V's 16 rows follow K's.
template <typename T, int D>
__device__ __forceinline__ void load_block(uint32_t stage, const char* src,
                                           long tok_bytes, int lane) {
  using Tl = Tile<T, D>;
  constexpr int kTotal = 2 * kBS * Tl::chunks;
#pragma unroll
  for (int i = 0; i < kTotal / 32; ++i) {
    const int idx = i * 32 + lane;
    const int c = idx % Tl::chunks;
    const int row = idx / Tl::chunks;  // 0..31: K's rows, then V's
    cp_async16(stage + Tl::offset(row / kBS, row % kBS, c),
               src + row * tok_bytes + c * 16);
  }
}

// Zero V's rows from `valid` on: a slot past the context may hold
// anything, and 0 * NaN is no 0.
template <typename T, int D>
__device__ __forceinline__ void zero_stale_rows(char* stage, int valid, int lane) {
  using Tl = Tile<T, D>;
  for (int idx = valid * Tl::chunks + lane; idx < kBS * Tl::chunks; idx += 32) {
    *reinterpret_cast<uint4*>(stage + Tl::offset(1, idx / Tl::chunks, idx % Tl::chunks)) =
        make_uint4(0, 0, 0, 0);
  }
}

// One TMA box of the pool's 5-D map into shared memory; its bytes
// complete `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// A warp's state over the blocks it takes of one piece, bf16 on the
// tensor cores.  Lane 4 * g + c holds, for query head g of the group,
// the columns 8 * n + 2 * c + {0, 1} of O and a quarter of the row sum.
template <int D, int G>
struct MmaEngine {
  using T = __nv_bfloat16;
  using Tl = Tile<T, D>;
  static constexpr int kSteps = D / 16;
  static constexpr int kTiles = D / 8;
  uint32_t qa[kSteps][2];
  float o[kTiles][2];
  float m, l;

  __device__ __forceinline__ void init(const T* q, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const T* p = q + g * D + k * 16 + 2 * c;
      qa[k][0] = g < G ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      qa[k][1] = g < G ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
#pragma unroll
    for (int n = 0; n < kTiles; ++n) o[n][0] = o[n][1] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // One block of `valid` live tokens from a stage; scores are kept in
  // log2 units (scale_log2 = D^-0.5 * log2 e).
  __device__ __forceinline__ void block(char* stage, int valid,
                                        float scale_log2, int lane) {
    const uint32_t base = smem_u32(stage);
    const int mat = lane >> 3, r = lane & 7;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // tokens 2c+{0,1}, 8+2c+{0,1}
    {
      // Even and odd k steps add up apart: two chains of half the length.
      float odd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const int t = r + 8 * (mat >> 1);
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        uint32_t b[4];
        ldmatrix_x4(b, base + Tl::offset(0, t, 2 * k + (mat & 1)));
        float(&to)[2][2] = k % 2 ? odd : s;
        mma_top_rows(to[0][0], to[0][1], qa[k][0], qa[k][1], b[0], b[1]);
        mma_top_rows(to[1][0], to[1][1], qa[k][0], qa[k][1], b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] += odd[n][0];
        s[n][1] += odd[n][1];
      }
    }
    const int c = lane & 3;
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[n][i] = 8 * n + 2 * c + i < valid ? s[n][i] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[n][i]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, m);  // finite: a block has a live token
    const float corr = exp2f(m - mx);  // 0 on the first block
    m = mx;
    uint32_t hi[2], lo[2];
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = exp2f(s[n][0] - mx), p1 = exp2f(s[n][1] - mx);
      sum += p0 + p1;
      const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
      hi[n] = *reinterpret_cast<const uint32_t*>(&h);
      lo[n] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
    }
    l = l * corr + sum;
    {
      const int t = r + 8 * (mat & 1);
#pragma unroll
      for (int n = 0; n < kTiles; n += 2) {
        uint32_t v[4];
        ldmatrix_x4_trans(v, base + Tl::offset(1, t, n + (mat >> 1)));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[n + i][0] *= corr;
          o[n + i][1] *= corr;
          mma_top_rows(o[n + i][0], o[n + i][1], hi[0], hi[1], v[2 * i], v[2 * i + 1]);
          mma_top_rows(o[n + i][0], o[n + i][1], lo[0], lo[1], v[2 * i], v[2 * i + 1]);
        }
      }
    }
  }

  // The warp's unnormalized (acc [G, D], then (m, l) [G, 2]) to `area`.
  __device__ __forceinline__ void finish(float* area, int lane) {
    const int g = lane >> 2, c = lane & 3;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (g < G) {
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        *reinterpret_cast<float2*>(area + g * D + n * 8 + 2 * c) =
            make_float2(o[n][0], o[n][1]);
      }
      if (c == 0) {
        area[G * D + 2 * g] = m;
        area[G * D + 2 * g + 1] = l;
      }
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The same state on CUDA cores, for float32 pools: lane i holds dims
// [i * D/32, (i + 1) * D/32) of every head of the group and takes the
// tokens of a block four at a time.  (It takes bf16 too, which
// -DDECODE_BF16_SIMT builds for a comparison of the two routes.)
template <typename Elem, int D, int G>
struct SimtEngine {
  using T = Elem;
  using Tl = Tile<T, D>;
  static constexpr int kDPL = D / 32;
  float qv[G][kDPL], acc[G][kDPL], m[G], l[G];

  __device__ __forceinline__ void init(const T* q, int lane) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        qv[g][i] = to_float(q[g * D + lane * kDPL + i]);
        acc[g][i] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
  }

  // This lane's kDPL elements of row t of K (kv = 0) or V (kv = 1).
  __device__ __forceinline__ void row(const char* stage, int kv, int t, int lane,
                                      float (&x)[kDPL]) {
    const int byte = lane * kDPL * static_cast<int>(sizeof(T));
    const T* p = reinterpret_cast<const T*>(
        stage + Tl::offset(kv, t, byte >> 4) + (byte & 15));
#pragma unroll
    for (int i = 0; i < kDPL; ++i) x[i] = to_float(p[i]);
  }

  __device__ __forceinline__ void block(char* stage, int valid,
                                        float scale_log2, int lane) {
    for (int t0 = 0; t0 < valid; t0 += 4) {
      float s[G][4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        float kr[kDPL];
        row(stage, 0, t0 + tt, lane, kr);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) dot += qv[g][i] * kr[i];
          s[g][tt] = dot;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s[g][tt] += __shfl_xor_sync(0xffffffffu, s[g][tt], off);
          }
          s[g][tt] = t0 + tt < valid ? s[g][tt] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[g][tt]);
        }
        const float corr = exp2f(m[g] - mx);  // 0 on the first block
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
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int i = 0; i < kDPL; ++i) acc[g][i] += s[g][tt] * vr[i];
        }
      }
    }
  }

  __device__ __forceinline__ void finish(float* area, int lane) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
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
  float* part_acc;  // [ctas, 2, G, D]
  float* part_ml;   // [ctas, 2, G, 2]
  int* counters;    // [B, Hkv], zero at launch
  void* out;
  int B, Hkv, num_blocks, max_blocks;
  float scale_log2;
};

__device__ __forceinline__ int live_blocks(const Args& a, int b) {
  const int ctx = a.context_len[b];
  return ctx <= 0 ? 0 : min((ctx + kBS - 1) / kBS, a.max_blocks);
}

// Blocks [j0, j1) of sequence b and KV head kvh, whose units are
// [seg_start, seg_start + nb) of the line; this CTA's run starts at
// unit run_start and every run is `per` units long.
//
// Under TMA `bars` are the warp's full barriers, one a stage, and bit s
// of `phases` the parity that stage s's next load will complete.
template <typename Engine, int D, int G>
__device__ __forceinline__ void piece(const Args& a, const CUtensorMap* map, char* smem,
                                      uint32_t bars, uint32_t& phases, int b, int kvh,
                                      int j0, int j1, int nb, int seg_start,
                                      int run_start, int per) {
  using T = typename Engine::T;
  using Tl = Tile<T, D>;
  constexpr int kStages = Tl::stages, kWarps = Tl::warps, kThreads = Tl::threads;
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.Hkv * G;
  const int ctx = a.context_len[b];
  char* ring = smem + warp * kStages * Tl::stage_bytes;
  const uint32_t ring_addr = smem_u32(ring);

  Engine eng;
  eng.init(static_cast<const T*>(a.q) + (static_cast<long>(b) * H + kvh * G) * D, lane);

  // This warp takes blocks j0 + warp, j0 + warp + kWarps, ...
  const int first = j0 + warp;
  const int n = first < j1 ? (j1 - first + kWarps - 1) / kWarps : 0;
  const int* trow = a.table + static_cast<long>(b) * a.max_blocks;
  const long tok_bytes = static_cast<long>(a.Hkv) * Tl::row_bytes;
  const char* head = static_cast<const char*>(a.kv) + static_cast<long>(kvh) * Tl::row_bytes;
  int next_id = n > 0 ? trow[first] : 0;  // read one fetch ahead
  auto fetch = [&](int i) {
    const int blk = min(max(next_id, 0), a.num_blocks - 1);
    if (i + 1 < n) next_id = trow[first + (i + 1) * kWarps];
    const int s = i % kStages;
    if constexpr (Tl::tma) {
      if (lane == 0) {
        // The stage was last read, or written, through the generic proxy.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bars + 8 * s, Tl::stage_bytes);
#pragma unroll
        for (int x = 0; x < Tl::row_bytes / 128; ++x) {
          tma_load_5d(ring_addr + s * Tl::stage_bytes + x * Tl::box_bytes, map,
                      bars + 8 * s, x * 64, kvh, 0, 0, blk);
        }
      }
    } else {
      load_block<T, D>(ring_addr + s * Tl::stage_bytes,
                       head + blk * (2L * kBS * tok_bytes), tok_bytes, lane);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    if constexpr (Tl::tma) {
      mbar_wait(bars + 8 * s, (phases >> s) & 1);
      phases ^= 1u << s;
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncwarp();  // block i has landed; the stage of block i - 1 is free
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    char* stage = ring + s * Tl::stage_bytes;
    const int valid = min(kBS, ctx - (first + i * kWarps) * kBS);
    if (valid < kBS) {
      zero_stale_rows<T, D>(stage, valid, lane);
      __syncwarp();
    }
    eng.block(stage, valid, a.scale_log2, lane);
  }
  cp_async_wait<0>();
  __syncwarp();
  // The ring is drained: its first stage carries the warp's state.
  static_assert(G * (D + 2) * 4 <= Tl::stage_bytes, "a warp's state fits a stage");
  eng.finish(reinterpret_cast<float*>(ring), lane);
  __syncthreads();

  const bool whole = j0 == 0 && j1 == nb;
  const int slot = seg_start >= run_start ? 1 : 0;
  const long mine = (static_cast<long>(blockIdx.x) * 2 + slot) * G;
  T* out = static_cast<T*>(a.out) + (static_cast<long>(b) * H + kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
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
      acc += area[e] * wt;
      sum += area[G * D + 2 * g + 1] * wt;
    }
    if (whole) {
      store(out + e, sum > 0.f ? acc / sum : 0.f);
    } else {
      a.part_acc[(mine + g) * D + d] = acc;
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
      const int arrived = atomicAdd(a.counters + b * a.Hkv + kvh, 1);
      s_last = arrived == last_cta - first_cta;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int g = e / D, d = e % D;
        // Only the first CTA can hold the pair in its second slot.
        const long head_slot =
            (static_cast<long>(first_cta) * 2 + (seg_start >= first_cta * per ? 1 : 0)) * G + g;
        float mx = __ldcg(a.part_ml + head_slot * 2);
        for (int c = first_cta + 1; c <= last_cta; ++c) {
          mx = fmaxf(mx, __ldcg(a.part_ml + (static_cast<long>(c) * 2 * G + g) * 2));
        }
        float wt = weight(__ldcg(a.part_ml + head_slot * 2), mx);
        float acc = __ldcg(a.part_acc + head_slot * D + d) * wt;
        float sum = __ldcg(a.part_ml + head_slot * 2 + 1) * wt;
        for (int c = first_cta + 1; c <= last_cta; ++c) {
          const long at = static_cast<long>(c) * 2 * G + g;
          wt = weight(__ldcg(a.part_ml + at * 2), mx);
          acc += __ldcg(a.part_acc + at * D + d) * wt;
          sum += __ldcg(a.part_ml + at * 2 + 1) * wt;
        }
        store(out + e, sum > 0.f ? acc / sum : 0.f);
      }
    }
  }
  __syncthreads();  // the states are read: the rings may fill again
}

template <typename Engine, int D, int G>
__device__ __forceinline__ void decode_body(const Args& a, const CUtensorMap* map) {
  extern __shared__ __align__(128) char smem_raw[];
  using T = typename Engine::T;
  using Tl = Tile<T, D>;
  constexpr int kThreads = Tl::threads;
  char* smem = smem_raw;
  __shared__ __align__(8) uint64_t full_bars[Tl::warps * Tl::stages];
  const uint32_t bars = smem_u32(full_bars) + 8 * Tl::stages * (threadIdx.x >> 5);
  uint32_t phases = 0;
  if constexpr (Tl::tma) {
    smem += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
    if ((threadIdx.x & 31) == 0) {
      for (int s = 0; s < Tl::stages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
  }
  const int H = a.Hkv * G;
  int live = 0;  // live blocks of all sequences, for one KV head
  for (int b = 0; b < a.B; ++b) live += live_blocks(a, b);
  // An empty context gives 0.
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (live_blocks(a, b) == 0) {
      T* out = static_cast<T*>(a.out) + static_cast<long>(b) * H * D;
      for (int e = threadIdx.x; e < H * D; e += kThreads) store(out + e, 0.f);
    }
  }
  const int total = live * a.Hkv;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int run_start = blockIdx.x * per;
  const int run_end = min(run_start + per, total);
  int at = run_start;
  while (at < run_end) {
    const int kvh = at / live;
    int seg_start = kvh * live;  // the first unit of (kvh, sequence b)
    for (int b = 0; b < a.B && at < run_end; ++b) {
      const int nb = live_blocks(a, b);
      if (at < seg_start + nb) {
        const int stop = min(run_end, seg_start + nb);
        piece<Engine, D, G>(a, map, smem, bars, phases, b, kvh, at - seg_start,
                            stop - seg_start, nb, seg_start, run_start, per);
        at = stop;
      }
      seg_start += nb;
    }
  }
}

template <int D, int G>
__global__ void __launch_bounds__(Tile<__nv_bfloat16, D>::threads)
    paged_decode_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
#ifdef DECODE_BF16_SIMT
  decode_body<SimtEngine<__nv_bfloat16, D, G>, D, G>(a, &map);
#else
  decode_body<MmaEngine<D, G>, D, G>(a, &map);
#endif
}

template <int D, int G>
__global__ void __launch_bounds__(Tile<float, D>::threads)
    paged_decode_f32_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
  decode_body<SimtEngine<float, D, G>, D, G>(a, &map);
}

// Calls f(kernel, its Tile) for the variant, or returns
// cudaErrorInvalidValue where there is none.
template <typename F>
int with_variant(int dtype, int D, int G, F&& f) {
#define DECODE_VARIANT(DD, GG)                                                  \
  if (D == DD && G == GG) {                                                     \
    return dtype == 1                                                           \
               ? f(paged_decode_bf16_kernel<DD, GG>, Tile<__nv_bfloat16, DD>{}) \
               : f(paged_decode_f32_kernel<DD, GG>, Tile<float, DD>{});         \
  }
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  DECODE_VARIANT(128, 1)
  DECODE_VARIANT(128, 2)
  DECODE_VARIANT(128, 4)
  DECODE_VARIANT(128, 8)
  DECODE_VARIANT(64, 1)
  DECODE_VARIANT(64, 2)
  DECODE_VARIANT(64, 4)
  DECODE_VARIANT(64, 8)
#undef DECODE_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr long align16(long n) { return (n + 15) / 16 * 16; }

// A TMA map over one layer's bf16 pool [num_blocks, 2, 16, Hkv, D],
// innermost first, with a box of 64 columns x 1 head x 16 rows x K and
// V x 1 block and the 128-byte swizzle.  It is encoded anew for every
// launch and travels in the kernel's parameters, so none outlives the
// tensor it describes.  Returns 0 or a cudaError_t.
inline int make_pool_map(CUtensorMap* map, const void* kv, int num_blocks, int Hkv, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv), kBS,
                              2, static_cast<cuuint64_t>(num_blocks)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[4] = {row, row * Hkv, row * Hkv * kBS, row * Hkv * kBS * 2};
  const cuuint32_t box[5] = {64, 1, kBS, 2, 1};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult rc =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(kv), dims, strides, box,
         steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// CTAs of a variant that one SM holds at once (dtype 0 = float32, 1 =
// bfloat16), or minus the CUDA error.
// The checkout's interface: block_size is 16 here.
int paged_decode_ctas_per_sm(int D, int G, int block_size, int dtype) {
  if (block_size != kBS) return -static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int rc = with_variant(dtype, D, G, [&](auto kernel, auto tile) {
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

// Bytes of scratch a launch of `ctas` CTAs needs: the counters, then
// the partials' (m, l), then their accumulators.
long paged_decode_scratch_bytes(int B, int Hkv, int G, int D, int ctas) {
  return align16(4L * B * Hkv) + align16(4L * ctas * 2 * G * 2) +
         4L * ctas * 2 * G * D;
}

// q: [B, H, D]; kv: [num_blocks, 2, 16, Hkv, D]; table: int32
// [B, max_blocks]; context_len: int32 [B]; scratch:
// paged_decode_scratch_bytes, 16-byte aligned; out: [B, H, D]; all
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Block size 16 only.
// `ctas` is the grid: a whole number of waves of
// paged_decode_ctas_per_sm.  No sliding window: `window` must be 0.
int paged_decode(const void* q, const void* kv, const void* table,
                 const void* context_len, void* scratch, void* out, int B,
                 int H, int Hkv, int D, int block_size, int num_blocks,
                 int max_blocks, int ctas, int nsub, int window, int dtype, void* stream) {
  // The checkout's interface; this variant keeps each group whole.
  if (block_size != kBS || Hkv <= 0 || H % Hkv != 0 || ctas <= 0 || nsub != 1 ||
      window != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  char* base = static_cast<char*>(scratch);
  Args a;
  a.q = q;
  a.kv = kv;
  a.table = static_cast<const int*>(table);
  a.context_len = static_cast<const int*>(context_len);
  a.counters = reinterpret_cast<int*>(base);
  a.part_ml = reinterpret_cast<float*>(base + align16(4L * B * Hkv));
  a.part_acc = reinterpret_cast<float*>(base + align16(4L * B * Hkv) +
                                        align16(4L * ctas * 2 * G * 2));
  a.out = out;
  a.B = B;
  a.Hkv = Hkv;
  a.num_blocks = num_blocks;
  a.max_blocks = max_blocks;
  a.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const int rc = with_variant(dtype, D, G, [&](auto kernel, auto tile) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaMemsetAsync(a.counters, 0, 4L * B * Hkv, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    CUtensorMap map = {};
    if (tile.tma) {
      const int made = make_pool_map(&map, kv, num_blocks, Hkv, D);
      if (made != 0) return made;
    }
    kernel<<<ctas, tile.threads, tile.smem, st>>>(a, map);
    return 0;
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
