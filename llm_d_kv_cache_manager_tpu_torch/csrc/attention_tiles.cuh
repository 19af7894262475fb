// The online-softmax loops shared by the attention kernels
// (flash_prefill.cu, ring_partial.cu), and the warp-level tensor-core
// helpers under them: mma.sync m16n8k16 bf16 with f32 accumulate,
// ldmatrix fragment loads, cp.async copies, bf16 packing.
//
// Both kernels mask a key by one per-row limit: key position `kpos` is
// visible to a row iff kpos < end, its row's end.  Causal prefill gives
// end = min(q_offset + row + 1, Tk); a ring step end = clamp(row +
// offset + 1, 0, Tk), or Tk unmasked.  What differs between the kernels
// (the grid, the ends, the epilogue) stays in their sources.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and
// t = lane % 4, A holds rows g and g+8 at columns 2t, 2t+1 and 2t+8,
// 2t+9; B holds column g at rows 2t, 2t+1 and 2t+8, 2t+9; C holds rows
// g and g+8 at columns 2t, 2t+1.  An ldmatrix 8x8 tile gives lane l row
// l/4, columns 2(l%4) and 2(l%4)+1 (of the transpose with .trans), which
// is exactly a B register when the tile is B^T (K rows) or, transposed,
// B (V rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // query rows per CTA (4 warps x 16 rows)
constexpr int kBK = 64;    // keys per shared-memory K/V stage
constexpr int kPad = 8;    // bf16 row padding: conflict-free ldmatrix rows
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kRowsF32 = 8;  // float32 kernels: warps (= query rows) per CTA

template <int D>
constexpr int smem_bytes() {
  return 2 * kStages * kBK * (D + kPad) * 2;  // K and V, bf16
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte async copy; `valid == false` zero-fills the destination (no
// global read), so rows past Tk hold 0 rather than stale data.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats as a bf16 pair: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One thread's share of its warp's 16 query rows (rows g and g+8 of the
// warp, C-fragment layout): the unnormalized accumulator, the running
// max in log2 units (-inf while no key was visible) and the row sum,
// reduced over the quad by the end of attend_tiles.
template <int D>
struct TileRows {
  float o[D / 8][4];
  float m0, m1;
  float l0, l1;
};

// The bf16 online softmax of one 64-row q tile (a CTA of kThreads, warp
// w owning rows w*16 .. w*16+15 from `row0 - g`) over key tiles
// [kt_begin, kt_end): both products on the tensor cores, K/V through a
// two-stage cp.async ring of kBK keys in `smem` (smem_bytes<D>()
// bytes), Q fragments in registers for the whole loop.  `row0` and
// `row0 + 8` are this thread's rows, `end0` and `end1` their key ends.
// The probabilities are rounded to bf16 for the P.V product; the sums
// keep them in f32.
template <int D>
__device__ __forceinline__ void attend_tiles(
    const __nv_bfloat16* __restrict__ qb, long q_stride, int Tq, int row0,
    const __nv_bfloat16* __restrict__ kb, const __nv_bfloat16* __restrict__ vb,
    long kv_stride, int Tk, int kt_begin, int kt_end, int end0, int end1,
    float scale_log2, unsigned char* smem, TileRows<D>& st) {
  constexpr int kSteps = D / 16;  // k-steps over the head dim (q k^T)
  constexpr int kDTiles = D / 8;  // n-tiles over the head dim (p v)
  constexpr int kNT = kBK / 8;    // n-tiles over the keys of a stage
  constexpr int kLD = D + kPad;   // shared-memory row stride, elements
  constexpr int kStage = kBK * kLD;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kStages * kStage;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    __nv_bfloat16* kd = ks + stage * kStage;
    __nv_bfloat16* vd = vs + stage * kStage;
    for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int cc = (c % kChunks) * 8;
      const bool ok = k0 + r < Tk;
      const long off = ok ? static_cast<long>(k0 + r) * kv_stride + cc : 0;
      cp_async_16(kd + r * kLD + cc, kb + off, ok);
      cp_async_16(vd + r * kLD + cc, vb + off, ok);
    }
    cp_async_commit();
  };
  if (kt_begin < kt_end) load_stage(kt_begin, 0);

  const int row1 = row0 + 8;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int col = kk * 16 + 2 * t;
    const uint32_t* r0 =
        reinterpret_cast<const uint32_t*>(qb + row0 * q_stride + col);
    const uint32_t* r1 =
        reinterpret_cast<const uint32_t*>(qb + row1 * q_stride + col);
    qf[kk][0] = row0 < Tq ? r0[0] : 0u;
    qf[kk][1] = row1 < Tq ? r1[0] : 0u;
    qf[kk][2] = row0 < Tq ? r0[4] : 0u;  // +8 columns = +4 words
    qf[kk][3] = row1 < Tq ? r1[4] : 0u;
  }

#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % kStages;
    if (kt + 1 < kt_end) {
      load_stage(kt + 1, (stage + 1) % kStages);  // overlaps this stage
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * kStage;
    const __nv_bfloat16* vst = vs + stage * kStage;
    const int k0 = kt * kBK;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; kk += 2) {
        // Tiles (keys j*8.., dims kk*16 + 0/8/16/24): B of k-steps kk, kk+1.
        uint32_t r[4];
        ldmatrix_x4(r, kst + (j * 8 + (lane & 7)) * kLD + kk * 16 + (lane >> 3) * 8);
        mma_16816(s[j], qf[kk], r[0], r[1]);
        mma_16816(s[j], qf[kk + 1], r[2], r[3]);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + e;
        s[j][e] = kpos < end0 ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = kpos < end1 ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // A row with every key so far masked keeps max -inf; subtract 0
    // instead so exp2 gives 0, never NaN.
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float corr0 = exp2f(m0 - base0);
    const float corr1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      st.o[dt][0] *= corr0;
      st.o[dt][1] *= corr0;
      st.o[dt][2] *= corr1;
      st.o[dt][3] *= corr1;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = exp2f(s[j][0] - base0);
      s[j][1] = exp2f(s[j][1] - base0);
      s[j][2] = exp2f(s[j][2] - base1);
      s[j][3] = exp2f(s[j][3] - base1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // o += p v: the C fragments of key n-tiles 2kk and 2kk+1 are the A
    // fragment of key k-step kk.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_floats(s[2 * kk][0], s[2 * kk][1]),
          pack_floats(s[2 * kk][2], s[2 * kk][3]),
          pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < kDTiles; dp += 2) {
        // Tiles (keys kk*16 + 0/8, dims dp*8 + 0/8), transposed: B of
        // n-tiles dp and dp+1.
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, vst + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLD +
                   dp * 8 + (lane >> 4) * 8);
        mma_16816(st.o[dp], a, r[0], r[1]);
        mma_16816(st.o[dp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  st.m0 = m0;
  st.m1 = m1;
  st.l0 = l0;
  st.l1 = l1;
}

// The float32 online softmax of one query row over keys [0, end), one
// warp per row, lanes splitting the head dimension (kDPL = D / 32
// elements each): the unnormalized accumulator `o`, the row max `m`
// (natural-log units of the scaled score; -inf when end == 0) and the
// row sum `l`.
template <int D>
__device__ __forceinline__ void attend_row_f32(
    const float* __restrict__ qrow, const float* __restrict__ kb,
    const float* __restrict__ vb, long kv_stride, int end, float scale,
    float (&o)[D / 32], float& m, float& l) {
  constexpr int kDPL = D / 32;
  const int lane = threadIdx.x % 32;
  float qv[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qv[i] = qrow[lane + 32 * i] * scale;
    o[i] = 0.f;
  }
  m = -INFINITY;
  l = 0.f;
  for (int j = 0; j < end; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) dot += qv[i] * kb[j * kv_stride + lane + 32 * i];
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
      o[i] = o[i] * corr + p * vb[j * kv_stride + lane + 32 * i];
    }
    m = m_new;
  }
}

}  // namespace
