// The paged decode kernel's first design, kept only so that
// hack/attention_kernel_ab.py can time it beside the one in
// llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu; the port does
// not build or call it.  The original header follows.
//
// One decode step of attention read straight from the paged KV pool,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/paged_decode_pallas.py, reached
// through `paged_decode_attention_pallas`).  Same function: for each
// sequence b and query head h, softmax(q k^T * D^-0.5) v over the
// positions below context_len[b] of the blocks block_table[b] names in
// one layer's pool [num_blocks, 2, block_size, Hkv, D], with the
// running max, sum and accumulator in float32.
//
// What bounds it on an H100: every K/V byte of the context is read once
// for about one multiply-add per element and query head of its group,
// so it is memory-bound (the whole context's K and V over 3.35 TB/s).
// The TPU kernel walks the context on a sequential grid axis carrying
// m, l and acc from step to step; blocks of a CUDA grid run in no
// order, so here the context is split across warps instead
// (flash-decoding): each warp owns one (sequence, KV head, chunk of
// blocks_per_chunk pool blocks) and serves the G query heads of that KV
// head, so K and V are read once for the whole group.  It writes an
// unnormalized partial (acc, m, l); a second kernel merges the partials
// of each (sequence, head) with the log-sum-exp combine of the
// reference's ring_flash_pallas.merge_partials.  The wrapper sizes the
// chunks so the grid has about 16 warps per SM even at batch 4.
//
// The kernel reads the block table itself (no scalar prefetch) and
// never reads an entry at or past ceil(context_len / block_size): the
// tail of the table may hold anything.  Block ids are clamped into the
// pool.  context_len 0 gives 0, as the TPU kernel does.
//
// C interface for ctypes; every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 x = *reinterpret_cast<const float2*>(p + i);
    r[i] = x.x;
    r[i + 1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    r[i] = x.x;
    r[i + 1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Grid (ceil(P / kWarps), Hkv, B); warp w of block x owns chunk
// x * kWarps + w, i.e. pool blocks [chunk * bpc, (chunk + 1) * bpc) of
// the sequence's table.  Lane i owns head-dim elements [i * D/32,
// (i + 1) * D/32).
template <typename T, int D, int BS, int G>
__global__ void __launch_bounds__(kWarps * 32)
    decode_partial_kernel(const T* __restrict__ q,
                          const T* __restrict__ kv,
                          const int* __restrict__ table,
                          const int* __restrict__ context_len,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int Hkv,
                          int num_blocks, int max_blocks, int bpc, int P,
                          float scale) {
  constexpr int kDPL = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = blockIdx.x * kWarps + warp;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  if (chunk >= P) return;
  const int H = Hkv * G;
  const int ctx = context_len[b];
  const int n_valid =
      ctx <= 0 ? 0 : min((ctx + BS - 1) / BS, max_blocks);
  const int first = chunk * bpc;
  const int last = min(first + bpc, n_valid);

  float qv[G][kDPL], acc[G][kDPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row(q + (static_cast<long>(b) * H + kvh * G + g) * D + lane * kDPL,
             qv[g]);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      qv[g][i] *= scale;
      acc[g][i] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const long tok_stride = static_cast<long>(Hkv) * D;
  const long blk_stride = 2L * BS * tok_stride;
  for (int j = first; j < last; ++j) {
    const int blk =
        min(max(table[static_cast<long>(b) * max_blocks + j], 0),
            num_blocks - 1);
    const T* kbase = kv + blk * blk_stride + kvh * D + lane * kDPL;
    const T* vbase = kbase + BS * tok_stride;
    const int valid = min(BS, ctx - j * BS);  // live tokens in the block

    float s[G][BS];
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      float kr[kDPL];
      load_row(kbase + t * tok_stride, kr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) dot += qv[g][i] * kr[i];
        s[g][t] = dot;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int t = 0; t < BS; ++t) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s[g][t] += __shfl_xor_sync(0xffffffffu, s[g][t], off);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        if (t < valid) mx = fmaxf(mx, s[g][t]);
      }
      const float corr = expf(m[g] - mx);  // 0 on the first block
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        s[g][t] = t < valid ? expf(s[g][t] - mx) : 0.f;
        l[g] += s[g][t];
      }
      m[g] = mx;
    }
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      if (t >= valid) break;  // stale slots: never multiply their V
      float vr[kDPL];
      load_row(vbase + t * tok_stride, vr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[g][i] += s[g][t] * vr[i];
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long slot =
        (static_cast<long>(b) * H + kvh * G + g) * P + chunk;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      part_acc[slot * D + lane * kDPL + i] = acc[g][i];
    }
    if (lane == 0) {
      part_ml[slot * 2] = m[g];
      part_ml[slot * 2 + 1] = l[g];
    }
  }
}

// One block of D threads per (sequence, head): log-sum-exp merge of its
// P partials.  Empty partials carry m = -inf, l = 0 and weigh 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, int P) {
  const long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * P * 2;
  float mx = -INFINITY;
  for (int p = 0; p < P; ++p) mx = fmaxf(mx, ml[2 * p]);
  float sum = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int p = 0; p < P; ++p) {
      const float w = expf(ml[2 * p] - mx);
      sum += ml[2 * p + 1] * w;
      acc += part_acc[(bh * P + p) * D + d] * w;
    }
  }
  store(out + bh * D + d, sum > 0.f ? acc / sum : 0.f);
}

template <typename T, int D, int BS, int G>
void launch(const void* q, const void* kv, const int* table, const int* ctx,
            float* part_acc, float* part_ml, void* out, int B, int Hkv,
            int num_blocks, int max_blocks, int bpc, int P,
            cudaStream_t st) {
  const dim3 grid((P + kWarps - 1) / kWarps, Hkv, B);
  decode_partial_kernel<T, D, BS, G><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), table, ctx,
      part_acc, part_ml, Hkv, num_blocks, max_blocks, bpc, P,
      1.f / sqrtf(static_cast<float>(D)));
  decode_merge_kernel<T, D><<<B * Hkv * G, D, 0, st>>>(
      part_acc, part_ml, static_cast<T*>(out), P);
}

template <typename T, int D, int BS>
int dispatch_groups(int G, const void* q, const void* kv, const int* table,
                    const int* ctx, float* part_acc, float* part_ml,
                    void* out, int B, int Hkv, int num_blocks,
                    int max_blocks, int bpc, int P, cudaStream_t st) {
  switch (G) {
    case 1:
      launch<T, D, BS, 1>(q, kv, table, ctx, part_acc, part_ml, out, B, Hkv,
                          num_blocks, max_blocks, bpc, P, st);
      return 0;
    case 2:
      launch<T, D, BS, 2>(q, kv, table, ctx, part_acc, part_ml, out, B, Hkv,
                          num_blocks, max_blocks, bpc, P, st);
      return 0;
    case 4:
      launch<T, D, BS, 4>(q, kv, table, ctx, part_acc, part_ml, out, B, Hkv,
                          num_blocks, max_blocks, bpc, P, st);
      return 0;
    case 8:
      launch<T, D, BS, 8>(q, kv, table, ctx, part_acc, part_ml, out, B, Hkv,
                          num_blocks, max_blocks, bpc, P, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int D, int G, const void* q, const void* kv, const int* table,
             const int* ctx, float* part_acc, float* part_ml, void* out,
             int B, int Hkv, int num_blocks, int max_blocks, int bpc, int P,
             cudaStream_t st) {
  if (D == 128) {
    return dispatch_groups<T, 128, 16>(G, q, kv, table, ctx, part_acc,
                                       part_ml, out, B, Hkv, num_blocks,
                                       max_blocks, bpc, P, st);
  }
  if (D == 64) {
    return dispatch_groups<T, 64, 16>(G, q, kv, table, ctx, part_acc,
                                      part_ml, out, B, Hkv, num_blocks,
                                      max_blocks, bpc, P, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// q: [B, H, D]; kv: [num_blocks, 2, 16, Hkv, D]; table: int32
// [B, max_blocks]; context_len: int32 [B]; part_acc: float32
// [B, H, P, D]; part_ml: float32 [B, H, P, 2]; out: [B, H, D]; all
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Block size 16 only.
int paged_decode(const void* q, const void* kv, const void* table,
                 const void* context_len, void* part_acc, void* part_ml,
                 void* out, int B, int H, int Hkv, int D, int block_size,
                 int num_blocks, int max_blocks, int bpc, int P, int dtype,
                 void* stream) {
  if (block_size != 16 || Hkv <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const auto* tp = static_cast<const int*>(table);
  const auto* cp = static_cast<const int*>(context_len);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  int rc;
  if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(D, G, q, kv, tp, cp, pa, pm, out, B, Hkv,
                                 num_blocks, max_blocks, bpc, P, st);
  } else if (dtype == 0) {
    rc = dispatch<float>(D, G, q, kv, tp, cp, pa, pm, out, B, Hkv,
                         num_blocks, max_blocks, bpc, P, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
