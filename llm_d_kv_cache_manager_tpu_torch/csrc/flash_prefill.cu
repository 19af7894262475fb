// Causal grouped-query prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/flash_pallas.py, reached through
// `flash_gqa_attention_pallas`).  Same function: softmax(q k^T * D^-0.5)
// v over keys at positions <= q_offset + row, with the running max, sum
// and accumulator in float32, rows whose sum is 0 written as 0.  A
// sliding window of W keys (`window` > 0, a runtime argument; 0 is none)
// also hides the keys at or below q_offset + row - W, as the windowed
// layers of a mixed model (Mellum's) need; the work list
// (ops/tile_plan.py) leaves the key tiles below every row's window out
// of each item, so they are never loaded, and masks the tiles that
// straddle a row's window begin.  The reference has no window.
//
// What bounds it on an H100: at the serving shapes (8448-token prefill,
// 256-token continuation over an 8192-token prefix) the work is the two
// matrix products, about 300 operations per byte of K/V read, so the
// tensor cores are the limit.  The bf16 kernel is therefore the Hopper
// tile loop of attention_tiles.cuh (shared with ring_partial.cu): a
// persistent CTA per SM, a producer warp that streams Q, K and V in by
// TMA, two consumer warpgroups that run both products on wgmma, and
// masks only on the tiles that straddle the causal diagonal.  What this
// kernel adds is its row end min(q_offset + row + 1, Tk) and its
// epilogue.  A q tile's key range ends at its last row's limit, so a
// short suffix over a long prefix does only the work the mask allows.
// The probabilities are rounded to bf16 for the second product, as in
// FlashAttention-2 and -3.
//
// The work list (ops/tile_plan.py) also splits the keys when the (q
// tile, head, batch) items are too few to fill the SMs, as a 256-row
// continuation's are: each split writes an unnormalized float32 partial
// (o, m, l), and a second kernel merges the splits by log-sum-exp.
//
// Head dims: every multiple of 16 from 32 to 256, each served by the
// kernel compiled for the next multiple of 64 (attention_tiles.cuh):
// the columns past the true head dim load as zeros and are not written.
//
// The float32 variant (test and small-shape use) is a plain CUDA-core
// kernel: one warp per query row, lanes splitting the head dimension.
//
// C interface for ctypes; every entry returns cudaGetLastError() or the
// error of a tensor map it could not encode.

#include "attention_tiles.cuh"

namespace {

// A persistent CTA walks `items` (ops/tile_plan.py).  `part_o` null:
// write the normalized bf16 output.  Otherwise write each item's
// split's unnormalized partial: part_o float32 [n_split, B, Tq, H, D],
// part_ml float32 [n_split, B, Tq, H, 2] = (max in log2 units, sum).
// D is the compiled width, dv <= D the true head dim: columns at or
// past dv are not written.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const int* __restrict__ items, int n_items,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int B, int Tq, int Tk, int H, int Hkv, int dv, int q_offset,
                      int window, float scale_log2) {
  constexpr int kDBlocks = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int t = threadIdx.x % 4;
  const long q_stride = static_cast<long>(H) * dv;

  attend_items_in<D>(
      &qmap, &kmap, &vmap, items, n_items, H / Hkv, scale_log2, smem_raw,
      [=](int row) { return min(q_offset + row + 1, Tk); },
      [=](int row) {
        return window > 0 ? max(min(q_offset + row + 1, Tk) - window, 0) : 0;
      },
      [&](int b, int h, int split, const TileRows<D>& st, int row0, int row1) {
        if (part_o != nullptr) {
          const long base = (static_cast<long>(split) * B + b) * Tq;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = hr ? row1 : row0;
            if (row >= Tq) continue;
            const long cell = (base + row) * H + h;
            float* po = part_o + cell * dv;
#pragma unroll
            for (int j = 0; j < kDBlocks; ++j) {
              if (j * 8 >= dv) break;
              *reinterpret_cast<float2*>(po + j * 8 + 2 * t) =
                  make_float2(st.o[4 * j + 2 * hr], st.o[4 * j + 2 * hr + 1]);
            }
            if (t == 0) {
              *reinterpret_cast<float2*>(part_ml + cell * 2) =
                  make_float2(hr ? st.m1 : st.m0, hr ? st.l1 : st.l0);
            }
          }
          return;
        }
        const float inv0 = st.l0 > 0.f ? 1.f / st.l0 : 0.f;  // empty rows give 0
        const float inv1 = st.l1 > 0.f ? 1.f / st.l1 : 0.f;
        __nv_bfloat16* ob = out + static_cast<long>(b) * Tq * q_stride + h * dv;
#pragma unroll
        for (int j = 0; j < kDBlocks; ++j) {
          if (j * 8 >= dv) break;
          const int col = j * 8 + 2 * t;
          if (row0 < Tq) {
            *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + col) =
                pack_floats(st.o[4 * j] * inv0, st.o[4 * j + 1] * inv0);
          }
          if (row1 < Tq) {
            *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + col) =
                pack_floats(st.o[4 * j + 2] * inv1, st.o[4 * j + 3] * inv1);
          }
        }
      });
}

// One block of D threads per (batch, row, head): log-sum-exp merge of
// the key splits' partials.  Empty splits carry m = -inf, l = 0.
__global__ void __launch_bounds__(256)
    flash_merge_kernel(const float* __restrict__ part_o,
                       const float* __restrict__ part_ml,
                       __nv_bfloat16* __restrict__ out, long cells,
                       int n_split, int D) {
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

// D: the compiled width; dv: the true head dim.
template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Tq, int Tk, int H, int Hkv, int dv, int q_offset,
                     int window, float scale) {
  constexpr int kDPL = D / 32;  // head-dim elements per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsF32 + warp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (row >= Tq) return;
  const int kvh = h / (H / Hkv);
  const long kv_stride = static_cast<long>(Hkv) * dv;
  const long q_index = (static_cast<long>(b) * Tq + row) * H * dv + h * dv;
  const float* kb = k + static_cast<long>(b) * Tk * kv_stride + kvh * dv;
  const float* vb = v + static_cast<long>(b) * Tk * kv_stride + kvh * dv;

  float acc[kDPL], m, l;
  const int end = min(q_offset + row + 1, Tk);
  attend_row_f32<D>(q + q_index, kb, vb, kv_stride, end, dv, scale, acc, m, l,
                    window > 0 ? max(end - window, 0) : 0);
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    if (lane + 32 * i < dv) out[q_index + lane + 32 * i] = acc[i] * inv;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* part_o, float* part_ml, const int* items, int n_items,
                int ctas, int B, int Tq, int Tk, int H, int Hkv, int dv, int q_offset,
                int window, int n_split, cudaStream_t st) {
  constexpr int kBK = TileBytes<D>::BK;
  CUtensorMap qmap, kmap, vmap;
  int rc = make_tile_map(&qmap, q, B, Tq, H, dv, kBQ);
  if (rc == 0) rc = make_tile_map(&kmap, k, B, Tk, Hkv, dv, kBK);
  if (rc == 0) rc = make_tile_map(&vmap, v, B, Tk, Hkv, dv, kBK);
  if (rc != 0) return rc;
  constexpr int kSmem = TileBytes<D>::smem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(dv));
  auto* op = static_cast<__nv_bfloat16*>(out);
  flash_bf16_kernel<D><<<n_items < ctas ? n_items : ctas, kThreads, kSmem, st>>>(
      qmap, kmap, vmap, items, n_items, op, n_split > 1 ? part_o : nullptr, part_ml,
      B, Tq, Tk, H, Hkv, dv, q_offset, window, scale_log2);
  if (n_split > 1) {
    const long cells = static_cast<long>(B) * Tq * H;
    flash_merge_kernel<<<cells, dv, 0, st>>>(part_o, part_ml, op, cells, n_split, dv);
  }
  return 0;
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int Tk, int H, int Hkv, int dv, int q_offset, int window,
                cudaStream_t st) {
  const dim3 grid((Tq + kRowsF32 - 1) / kRowsF32, H, B);
  flash_f32_kernel<D><<<grid, kRowsF32 * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, H, Hkv, dv,
      q_offset, window, 1.f / sqrtf(static_cast<float>(dv)));
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, float* po,
           float* pm, const int* it, int n_items, int ctas, int B, int Tq, int Tk, int H,
           int Hkv, int dv, int q_offset, int window, int n_split, cudaStream_t st) {
  if (dtype == 1) {
    return launch_bf16<D>(q, k, v, out, po, pm, it, n_items, ctas, B, Tq, Tk, H, Hkv, dv,
                          q_offset, window, n_split, st);
  }
  launch_f32<D>(q, k, v, out, B, Tq, Tk, H, Hkv, dv, q_offset, window, st);
  return 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// q: [B, Tq, H, D], k/v: [B, Tk, Hkv, D], out: [B, Tq, H, D], all
// contiguous; D a multiple of 16 from 32 to 256; dtype 0 = float32,
// 1 = bfloat16.  bf16 only: `items` is the device work list of
// `n_items` items (ops/tile_plan.py, with key tiles of
// key_tile<compiled_width(D)>() keys), walked by at most `ctas`
// persistent CTAs; with n_split > 1 its items are key splits, written
// through the float32 scratch part_o [n_split, B, Tq, H, D] and part_ml
// [n_split, B, Tq, H, 2] and merged.  `window` > 0: a sliding window of
// that many keys (the items built with the same window); 0: none.
int flash_prefill(const void* q, const void* k, const void* v, void* out,
                  void* part_o, void* part_ml, const void* items, int n_items,
                  int ctas, int B, int Tq, int Tk, int H, int Hkv, int D,
                  int q_offset, int window, int n_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || window < 0 || (n_split > 1 && (dtype != 1 || !part_o || !part_ml)) ||
      (dtype == 1 && (items == nullptr || n_items < 1 || ctas < 1)) ||
      (dtype != 0 && dtype != 1) || !head_dim_ok(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  const auto* it = static_cast<const int*>(items);
  int rc = 0;
  switch (compiled_width(D)) {
    case 64:
      rc = launch<64>(dtype, q, k, v, out, po, pm, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                      q_offset, window, n_split, st);
      break;
    case 128:
      rc = launch<128>(dtype, q, k, v, out, po, pm, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       q_offset, window, n_split, st);
      break;
    case 192:
      rc = launch<192>(dtype, q, k, v, out, po, pm, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       q_offset, window, n_split, st);
      break;
    default:
      rc = launch<256>(dtype, q, k, v, out, po, pm, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       q_offset, window, n_split, st);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
