// Causal grouped-query prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/flash_pallas.py, reached through
// `flash_gqa_attention_pallas`).  Same function: softmax(q k^T * D^-0.5)
// v over keys at positions <= q_offset + row, with the running max, sum
// and accumulator in float32, rows whose sum is 0 written as 0.
//
// What bounds it on an H100: at the serving shapes (8448-token prefill,
// 256-token continuation over an 8192-token prefix) the work is the two
// matrix products, about 300 operations per byte of K/V read, so the
// tensor cores are the limit.  The bf16 kernel therefore runs both
// products on them (mma.sync m16n8k16, bf16 in, f32 accumulate): one
// CTA of 4 warps per (q-tile of 64 rows, head, batch, key split), each
// warp owning 16 query rows whose Q fragments stay in registers for the
// whole key loop.  K/V stream through a two-stage shared-memory ring, 64
// keys a stage, filled by cp.async while the previous stage computes,
// with no cap on the key length; ldmatrix (.trans for V) reads the
// fragments, so shared-memory loads stay well below the mma count.  The
// key loop ends at the tile's causal limit min(q_offset + (tile+1)*64,
// Tk), so a short suffix over a long prefix does only the work the mask
// allows, and the longest tiles start first.  The probabilities are
// rounded to bf16 for the second product, as in FlashAttention-2.
//
// A continuation suffix (256 rows) gives only 4 q-tiles a head, too few
// CTAs to fill 132 SMs; the wrapper then splits the keys across CTAs,
// each writing an unnormalized float32 partial (o, m, l), and a second
// kernel merges the splits by log-sum-exp.  Not yet used: wgmma and TMA.
//
// The float32 variant (test and small-shape use) is a plain CUDA-core
// kernel: one warp per query row, lanes splitting the head dimension.
//
// C interface for ctypes; every entry returns cudaGetLastError().

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

template <int D>
constexpr int smem_bytes() {
  return 2 * kStages * kBK * (D + kPad) * 2;  // K and V, bf16
}

// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and
// t = lane % 4, A holds rows g and g+8 at columns 2t, 2t+1 and 2t+8,
// 2t+9; B holds column g at rows 2t, 2t+1 and 2t+8, 2t+9; C holds rows
// g and g+8 at columns 2t, 2t+1.  An ldmatrix 8x8 tile gives lane l row
// l/4, columns 2(l%4) and 2(l%4)+1 (of the transpose with .trans), which
// is exactly a B register when the tile is B^T (K rows) or, transposed,
// B (V rows).
//
// Grid (n_qtiles * n_split, H, B).  `part_o` null: write the normalized
// bf16 output.  Otherwise write this split's unnormalized partial:
// part_o float32 [n_split, B, Tq, H, D], part_ml float32
// [n_split, B, Tq, H, 2] = (max in log2 units, sum).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int B, int Tq, int Tk, int H, int Hkv, int q_offset,
                      float scale_log2, int n_split, int tiles_per_split) {
  constexpr int kSteps = D / 16;  // k-steps over the head dim (q k^T)
  constexpr int kDTiles = D / 8;  // n-tiles over the head dim (p v)
  constexpr int kNT = kBK / 8;    // n-tiles over the keys of a stage
  constexpr int kLD = D + kPad;   // shared-memory row stride, elements
  constexpr int kStage = kBK * kLD;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kStages * kStage;

  const int n_qtiles = gridDim.x / n_split;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / n_split;
  const int split = static_cast<int>(blockIdx.x) % n_split;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<long>(b) * Tq * q_stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * Tk * kv_stride + kvh * D;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * Tk * kv_stride + kvh * D;

  const int kv_end = min(q_offset + (qt + 1) * kBQ, Tk);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int kt_begin = split * tiles_per_split;
  const int kt_end = min(n_tiles, kt_begin + tiles_per_split);

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

  const int row0 = qt * kBQ + warp * 16 + g;  // this thread's two rows
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

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;              // partial sums of own columns
  const int qpos0 = q_offset + row0;
  const int qpos1 = q_offset + row1;

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
        s[j][e] = (kpos <= qpos0 && kpos < Tk) ? s[j][e] * scale_log2
                                               : -INFINITY;
        s[j][2 + e] = (kpos <= qpos1 && kpos < Tk)
                          ? s[j][2 + e] * scale_log2
                          : -INFINITY;
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
      o[dt][0] *= corr0;
      o[dt][1] *= corr0;
      o[dt][2] *= corr1;
      o[dt][3] *= corr1;
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
        mma_16816(o[dp], a, r[0], r[1]);
        mma_16816(o[dp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  if (part_o != nullptr) {
    const long base = (static_cast<long>(split) * B + b) * Tq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr ? row1 : row0;
      if (row >= Tq) continue;
      const long cell = (base + row) * H + h;
      float* po = part_o + cell * D;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(po + dt * 8 + 2 * t) =
            make_float2(o[dt][2 * hr], o[dt][2 * hr + 1]);
      }
      if (t == 0) {
        *reinterpret_cast<float2*>(part_ml + cell * 2) =
            make_float2(hr ? m1 : m0, hr ? l1 : l0);
      }
    }
    return;
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // empty rows give 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = out + static_cast<long>(b) * Tq * q_stride + h * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Tq) {
      *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + col) =
          pack_floats(o[dt][0] * inv0, o[dt][1] * inv0);
    }
    if (row1 < Tq) {
      *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + col) =
          pack_floats(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

// One block of D threads per (batch, row, head): log-sum-exp merge of
// the key splits' partials.  Empty splits carry m = -inf, l = 0.
template <int D>
__global__ void __launch_bounds__(D)
    flash_merge_kernel(const float* __restrict__ part_o,
                       const float* __restrict__ part_ml,
                       __nv_bfloat16* __restrict__ out, long cells,
                       int n_split) {
  const long cell = blockIdx.x;  // ((b * Tq + row) * H + h)
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    mx = fmaxf(mx, part_ml[(s * cells + cell) * 2]);
  }
  float sum = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const long c = s * cells + cell;
      const float w = exp2f(part_ml[c * 2] - mx);
      sum += part_ml[c * 2 + 1] * w;
      acc += part_o[c * D + d] * w;
    }
  }
  out[cell * D + d] = __float2bfloat16_rn(sum > 0.f ? acc / sum : 0.f);
}

constexpr int kRowsF32 = 8;  // warps (= query rows) per CTA

template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Tq, int Tk, int H, int Hkv, int q_offset,
                     float scale) {
  constexpr int kDPL = D / 32;  // head-dim elements per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsF32 + warp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (row >= Tq) return;
  const int kvh = h / (H / Hkv);
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long q_index = (static_cast<long>(b) * Tq + row) * H * D + h * D;
  const float* kb = k + static_cast<long>(b) * Tk * kv_stride + kvh * D;
  const float* vb = v + static_cast<long>(b) * Tk * kv_stride + kvh * D;

  float qv[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qv[i] = q[q_index + lane + 32 * i] * scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int end = min(q_offset + row + 1, Tk);
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
      acc[i] = acc[i] * corr + p * vb[j * kv_stride + lane + 32 * i];
    }
    m = m_new;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) out[q_index + lane + 32 * i] = acc[i] * inv;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* part_o, float* part_ml, int B, int Tq, int Tk, int H,
                int Hkv, int q_offset, int n_split, int tiles_per_split,
                cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const dim3 grid(((Tq + kBQ - 1) / kBQ) * n_split, H, B);
  auto* op = static_cast<__nv_bfloat16*>(out);
  flash_bf16_kernel<D><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), op,
      n_split > 1 ? part_o : nullptr, part_ml, B, Tq, Tk, H, Hkv, q_offset,
      scale_log2, n_split, tiles_per_split);
  if (n_split > 1) {
    const long cells = static_cast<long>(B) * Tq * H;
    flash_merge_kernel<D><<<cells, D, 0, st>>>(part_o, part_ml, op, cells,
                                               n_split);
  }
  return 0;
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int Tk, int H, int Hkv, int q_offset,
                cudaStream_t st) {
  const dim3 grid((Tq + kRowsF32 - 1) / kRowsF32, H, B);
  flash_f32_kernel<D><<<grid, kRowsF32 * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, H, Hkv,
      q_offset, 1.f / sqrtf(static_cast<float>(D)));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// q: [B, Tq, H, D], k/v: [B, Tk, Hkv, D], out: [B, Tq, H, D], all
// contiguous; dtype 0 = float32, 1 = bfloat16.  bf16 only: with
// n_split > 1 the keys of each q-tile are split into n_split ranges of
// tiles_per_split 64-key tiles, through the float32 scratch part_o
// [n_split, B, Tq, H, D] and part_ml [n_split, B, Tq, H, 2].
int flash_prefill(const void* q, const void* k, const void* v, void* out,
                  void* part_o, void* part_ml, int B, int Tq, int Tk, int H,
                  int Hkv, int D, int q_offset, int n_split,
                  int tiles_per_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && (dtype != 1 || !part_o || !part_ml))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  int rc = 0;
  if (dtype == 1 && D == 128) {
    rc = launch_bf16<128>(q, k, v, out, po, pm, B, Tq, Tk, H, Hkv, q_offset,
                          n_split, tiles_per_split, st);
  } else if (dtype == 1 && D == 64) {
    rc = launch_bf16<64>(q, k, v, out, po, pm, B, Tq, Tk, H, Hkv, q_offset,
                         n_split, tiles_per_split, st);
  } else if (dtype == 0 && D == 128) {
    launch_f32<128>(q, k, v, out, B, Tq, Tk, H, Hkv, q_offset, st);
  } else if (dtype == 0 && D == 64) {
    launch_f32<64>(q, k, v, out, B, Tq, Tk, H, Hkv, q_offset, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
