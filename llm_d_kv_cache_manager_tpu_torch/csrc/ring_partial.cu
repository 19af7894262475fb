// One ring-attention step's unnormalized GQA attention partial, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_partial_kernel` of the JAX reference
// (llm_d_kv_cache_manager_tpu/ops/ring_flash_pallas.py, reached through
// `flash_partial`).  Same function: for query row a and key b, score
// s = q.k * D^-0.5 over the keys the step's mask keeps (b < Tk and,
// when `causal`, b <= a + offset); outputs float32
//   acc [B, Tq, H, D] = sum_b exp(s_b - m) v_b     (not divided by l)
//   m   [B, Tq, H]    = max_b s_b, natural-log units of the scaled score
//   l   [B, Tq, H]    = sum_b exp(s_b - m)
// and, for a row that sees no key, exactly (acc, m, l) = (0, -1e30, 0):
// the reference's finite NEG_INF, which merge_partials relies on.
//
// What bounds it on an H100: at the ring's serving shape (one rank's
// 2048-row chunk of an 8192-token prompt over sp=4, H 32, Hkv 8, D 128)
// a causal step does ~34 GFLOP and moves ~59 MB, over half of it the
// float32 acc it writes: ~580 operations a byte (~1160 unmasked), above
// the card's ~295, so the tensor cores are the limit.  The bf16 kernel
// is therefore the Hopper tile loop of attention_tiles.cuh, shared with
// flash_prefill.cu: a persistent CTA per SM walking a work list of
// (batch, head, 128-row q tile) items sorted longest first, a producer
// warp that streams Q, K and V in by TMA, two consumer warpgroups that
// run both products on wgmma, and masks only on the tiles that straddle
// a row's limit a + offset, so a causal step does only the visible
// half.  What this kernel adds is its row end (below) and its epilogue.
// The probabilities are rounded to bf16 for the P.V product (l sums
// them in f32).  The running max is kept in log2 units for exp2f and
// written as m * ln 2.  The ring shape gives 512 items for 132 SMs, so
// the keys are not split.
//
// Unlike the TPU kernel, which stages one KV head's whole chunk in VMEM,
// nothing here caps Tk, and the offset is a runtime argument (any int;
// `causal == 0` means no mask), so one build serves every ring step.
//
// Head dims: every multiple of 16 from 32 to 256, each served by the
// kernel compiled for the next multiple of 64 (attention_tiles.cuh).
//
// The float32 variant (test and small-shape use) is a plain CUDA-core
// kernel: one warp per query row, lanes splitting the head dimension.
//
// C interface for ctypes; the entry returns cudaGetLastError() or the
// error of a tensor map it could not encode.

#include "attention_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLn2 = 0.6931471805599453f;

// Keys [0, end) that local row `row` may see: min(row + offset + 1, Tk)
// clamped at 0 when causal, all Tk otherwise.  64-bit, so no offset the
// int interface can carry overflows.
__device__ __forceinline__ int visible_end(long long row, int causal,
                                           int offset, int Tk) {
  if (!causal) return Tk;
  const long long end = row + offset + 1;
  return static_cast<int>(end < 0 ? 0 : (end > Tk ? Tk : end));
}

// A persistent CTA walks `items` (ops/tile_plan.py).  Every row < Tq
// of an item is written, also when its causal limit leaves no key (the
// outputs come from torch.empty).  D is the compiled width, dv <= D the
// true head dim.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ring_partial_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const int* __restrict__ items, int n_items,
                             float* __restrict__ acc, float* __restrict__ m_out,
                             float* __restrict__ l_out, int Tq, int Tk, int H,
                             int Hkv, int dv, int causal, int offset, float scale_log2) {
  constexpr int kDBlocks = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int t = threadIdx.x % 4;

  attend_items<D>(
      &qmap, &kmap, &vmap, items, n_items, H / Hkv, scale_log2, smem_raw,
      [=](int row) { return visible_end(row, causal, offset, Tk); },
      [&](int b, int h, int, const TileRows<D>& st, int row0, int row1) {
        // A row that saw no key has o = 0 and l = 0 already (every p was
        // exp2(-inf) = 0); its max becomes the finite sentinel.
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = hr ? row1 : row0;
          if (row >= Tq) continue;
          const long cell = (static_cast<long>(b) * Tq + row) * H + h;
          float* po = acc + cell * dv;
#pragma unroll
          for (int j = 0; j < kDBlocks; ++j) {
            if (j * 8 >= dv) break;
            *reinterpret_cast<float2*>(po + j * 8 + 2 * t) =
                make_float2(st.o[4 * j + 2 * hr], st.o[4 * j + 2 * hr + 1]);
          }
          if (t == 0) {
            const float mr = hr ? st.m1 : st.m0;
            m_out[cell] = mr == -INFINITY ? kNegInf : mr * kLn2;
            l_out[cell] = hr ? st.l1 : st.l0;
          }
        }
      });
}

template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
    ring_partial_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ acc, float* __restrict__ m_out,
                            float* __restrict__ l_out, int Tq, int Tk, int H,
                            int Hkv, int dv, int causal, int offset, float scale) {
  constexpr int kDPL = D / 32;  // head-dim elements per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsF32 + warp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (row >= Tq) return;
  const int kvh = h / (H / Hkv);
  const long kv_stride = static_cast<long>(Hkv) * dv;
  const long cell = (static_cast<long>(b) * Tq + row) * H + h;
  const float* kb = k + static_cast<long>(b) * Tk * kv_stride + kvh * dv;
  const float* vb = v + static_cast<long>(b) * Tk * kv_stride + kvh * dv;

  float o[kDPL], m, l;
  attend_row_f32<D>(q + cell * dv, kb, vb, kv_stride,
                    visible_end(row, causal, offset, Tk), dv, scale, o, m, l);
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    if (lane + 32 * i < dv) acc[cell * dv + lane + 32 * i] = o[i];
  }
  if (lane == 0) {
    m_out[cell] = m == -INFINITY ? kNegInf : m;
    l_out[cell] = l;
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, float* acc, float* m,
           float* l, const int* items, int n_items, int ctas, int B, int Tq, int Tk, int H,
           int Hkv, int dv, int causal, int offset, cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((Tq + kRowsF32 - 1) / kRowsF32, H, B);
    ring_partial_f32_kernel<D><<<grid, kRowsF32 * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), acc, m, l, Tq, Tk, H, Hkv, dv, causal, offset,
        1.f / sqrtf(static_cast<float>(dv)));
    return 0;
  }
  constexpr int kBK = TileBytes<D>::BK;
  CUtensorMap qmap, kmap, vmap;
  int rc = make_tile_map(&qmap, q, B, Tq, H, dv, kBQ);
  if (rc == 0) rc = make_tile_map(&kmap, k, B, Tk, Hkv, dv, kBK);
  if (rc == 0) rc = make_tile_map(&vmap, v, B, Tk, Hkv, dv, kBK);
  if (rc != 0) return rc;
  constexpr int kSmem = TileBytes<D>::smem;
  const cudaError_t attr = cudaFuncSetAttribute(
      ring_partial_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(dv));
  ring_partial_bf16_kernel<D><<<n_items < ctas ? n_items : ctas, kThreads, kSmem, st>>>(
      qmap, kmap, vmap, items, n_items, acc, m, l, Tq, Tk, H, Hkv, dv, causal, offset,
      scale_log2);
  return 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// q: [B, Tq, H, D], k/v: [B, Tk, Hkv, D] in one dtype (0 = float32,
// 1 = bfloat16), D a multiple of 16 from 32 to 256; acc: float32
// [B, Tq, H, D]; m, l: float32 [B, Tq, H]; all contiguous.  `causal` 0:
// every key visible; 1: key <= row + offset.  bf16 only: `items` is the
// device work list of `n_items` items (ops/tile_plan.py, with key tiles
// of key_tile<compiled_width(D)>() keys), walked by at most `ctas`
// persistent CTAs.
int ring_partial(const void* q, const void* k, const void* v, void* acc,
                 void* m, void* l, const void* items, int n_items, int ctas, int B,
                 int Tq, int Tk, int H, int Hkv, int D, int causal, int offset,
                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype == 1 && (items == nullptr || n_items < 1 || ctas < 1)) ||
      (dtype != 0 && dtype != 1) || !head_dim_ok(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* pa = static_cast<float*>(acc);
  auto* pm = static_cast<float*>(m);
  auto* pl = static_cast<float*>(l);
  const auto* it = static_cast<const int*>(items);
  int rc = 0;
  switch (compiled_width(D)) {
    case 64:
      rc = launch<64>(dtype, q, k, v, pa, pm, pl, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                      causal, offset, st);
      break;
    case 128:
      rc = launch<128>(dtype, q, k, v, pa, pm, pl, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       causal, offset, st);
      break;
    case 192:
      rc = launch<192>(dtype, q, k, v, pa, pm, pl, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       causal, offset, st);
      break;
    default:
      rc = launch<256>(dtype, q, k, v, pa, pm, pl, it, n_items, ctas, B, Tq, Tk, H, Hkv, D,
                       causal, offset, st);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
