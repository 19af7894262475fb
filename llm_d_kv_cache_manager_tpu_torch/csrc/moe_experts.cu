// The routed-expert MLP of a mixture-of-experts layer for Hopper
// (sm_90a), dropless: every token's top-k experts are computed.
//
// Replaces no TPU kernel.  The JAX reference's MoE (models/moe.py) routes
// with a static expert capacity and a one-hot dispatch that XLA turns
// into dense products over every expert slot, dropping the tokens past
// capacity; serving needs every token's top-k computed, inside the
// captured decode step's CUDA graph, with no host sync.  Four C entries,
// five launches a layer:
//
// - moe_route: one CTA of 1024 threads a token (16 slices of the k-rows
//   for 64 experts, 8 loads in flight a thread).  The router's logits W_router h in
//   float32 (h and W_router in the working type, the products and sums
//   in float32), their softmax over all E experts, the top k (the larger
//   logit first, the lower index on a tie) and their weights, divided by
//   their sum where `norm` is set (Mixtral's and Mellum's norm_topk_prob).
// - moe_group: one CTA.  Counts each expert's routed rows, lays the rows
//   out expert by expert (offsets [E + 1] and, per position, the routed
//   row it holds; per routed row, its position), and adds to the device
//   counters: routed rows, experts with a row, rows left unplaced
//   (dropped: 0 by construction, counted to show it) and calls.  Which
//   row of an expert sits first is the order its atomics land in; each
//   row's numbers do not depend on it.
// - moe_experts, two launches of moe_rows_kernel (gate_up, then down):
//   one CTA an (expert, 64 output columns);
//   the CTAs of experts that no row chose return at once, so the grid is
//   fixed by shapes alone and the graph replays it whatever the routing.
//   gate_up computes silu(x W_gate) * (x W_up) of the expert's rows in
//   float32, rounded once to the working type; down computes that times
//   W_down, rounded once.
// - moe_combine: one CTA a token: out = x + sum over its k slots, in slot
//   order, of weight * y, in float32, rounded once (x is the residual).
//
// What bounds it on an H100: at decode (24 rows, top 8 of 64 experts:
// 192 routed rows, 1 to 10 an expert) each expert that a row chose has
// its three matrices read once, for a few multiply-adds per element, so
// the layer is memory-bound: the distinct experts' bytes over 3.35 TB/s
// (~0.23 ms a Mellum layer at ~62 experts).  The design is about bytes
// in flight and nothing else: a thread streams 4 columns of a k-row (8-byte
// loads of bf16, 16 threads covering the CTA's 64 columns), 4 k-rows a
// step (2 in gate_up, of two matrices), the next step's loads issued
// before this step's products, and
// multiplies them on CUDA cores into the rows' float32 sums,
// the rows' inputs held in shared memory as float32; 8 rows a pass (an
// expert with more takes another pass over its weights, from L2); two
// CTAs an SM at D 2304 (the 8 rows take 72 KB of shared memory).  On
// tensor cores most of an m16n8k16 tile would multiply padding.  At
// prefill (thousands of rows an expert) the work is the products, which
// these kernels do at a CUDA-core rate; ops/moe_experts.py gives those
// to per-expert matrix products over the grouped rows instead, between
// moe_route, moe_group and moe_combine.
//
// C interface for ctypes; every entry returns cudaGetLastError() after
// its launches, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRouteThreads = 1024;
constexpr int kMaxExperts = 256;
constexpr int kGroupThreads = 1024;
constexpr int kCols = 64;                       // output columns a CTA
constexpr int kVec = 4;                         // columns a thread
constexpr int kColLanes = kCols / kVec;         // 16 threads over a k-row
constexpr int kMmThreads = 256;
constexpr int kKRows = kMmThreads / kColLanes;  // 16 k-rows at a time
constexpr int kWarps = kMmThreads / 32;
constexpr int kRows = 8;                        // routed rows a pass
// k-rows a thread loads a step: 4, or 2 for gate_up, whose two matrices'
// loads and sums would spill at 4 (128 registers a thread, two CTAs an SM).
template <bool kGateUp>
constexpr int kAhead = kGateUp ? 2 : 4;
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// One token's router logits, softmax and top k.  Dynamic shared memory:
// the token's h row (D floats), then the slices' partial logits.
template <typename T>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const T* __restrict__ h, const T* __restrict__ w, int D, int E, int k,
                     int norm, int* __restrict__ ids, float* __restrict__ wts) {
  extern __shared__ float smem[];
  const long t = blockIdx.x;
  const T* hr = h + t * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) smem[i] = to_f(hr[i]);
  __syncthreads();
  // Thread (slice, e): the sum over k-rows slice, slice + slices, ... of
  // h[k] W[k, e]; a k-row of W is read by consecutive threads.
  const int slices = blockDim.x / E;
  const int e = threadIdx.x % E, sl = threadIdx.x / E;
  float* part = smem + D;
  if (sl < slices) {
    float acc = 0.f;
#pragma unroll 8
    for (int kk = sl; kk < D; kk += slices) {
      acc = fmaf(smem[kk], to_f(w[static_cast<long>(kk) * E + e]), acc);
    }
    part[sl * E + e] = acc;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  constexpr int kPer = kMaxExperts / 32;  // experts a lane: lane, lane + 32, ...
  float lg[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int ee = lane + 32 * j;
    float v = -INFINITY;
    if (ee < E) {
      v = 0.f;
      for (int s = 0; s < slices; ++s) v += part[s * E + ee];
    }
    lg[j] = v;
    mx = fmaxf(mx, v);
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (lane + 32 * j < E) sum += expf(lg[j] - mx);
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float picked = 0.f;
  for (int i = 0; i < k; ++i) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int ee = lane + 32 * j;
      if (ee < E && (lg[j] > bv || (lg[j] == bv && ee < bi))) {
        bv = lg[j];
        bi = ee;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lane + 32 * j == bi) lg[j] = -INFINITY;
    }
    const float p = expf(bv - mx) / sum;
    picked += p;
    if (lane == 0) {
      ids[t * k + i] = bi;
      wts[t * k + i] = p;
    }
  }
  if (norm && lane == 0) {
    for (int i = 0; i < k; ++i) wts[t * k + i] = wts[t * k + i] / picked;
  }
}

// The routed rows laid out expert by expert, and the counters.
__global__ void __launch_bounds__(kGroupThreads)
    moe_group_kernel(const int* __restrict__ ids, int P, int E, int* __restrict__ offsets,
                     int* __restrict__ perm, int* __restrict__ pos,
                     long long* __restrict__ counters) {
  __shared__ int cnt[kMaxExperts], start[kMaxExperts + 1], fill[kMaxExperts];
  __shared__ int placed;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    cnt[i] = 0;
    fill[i] = 0;
  }
  if (threadIdx.x == 0) placed = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < P; r += blockDim.x) {
    const int e = ids[r];
    if (e >= 0 && e < E) atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = s;
      s += cnt[e];
    }
    start[E] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= E; i += blockDim.x) offsets[i] = start[i];
  for (int r = threadIdx.x; r < P; r += blockDim.x) {
    const int e = ids[r];
    if (e >= 0 && e < E) {
      const int at = start[e] + atomicAdd(&fill[e], 1);
      perm[at] = r;
      pos[r] = at;
      atomicAdd(&placed, 1);
    } else {
      pos[r] = -1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && counters != nullptr) {
    int distinct = 0;
    for (int e = 0; e < E; ++e) distinct += cnt[e] > 0;
    counters[0] += P;
    counters[1] += distinct;
    counters[2] += P - placed;
    counters[3] += 1;
  }
}

// A thread's weights of one step: k-rows kk, kk + kKRows, ... (kAhead of
// them, those below K) of its 4 columns, of W0 and, for gate_up, W1.
template <typename T, bool kGateUp>
__device__ __forceinline__ void load_step(const T* p0, const T* p1, int N, int K, int kk,
                                          Pack<T> (&d0)[kAhead<kGateUp>],
                                          Pack<T> (&d1)[kAhead<kGateUp>]) {
#pragma unroll
  for (int u = 0; u < kAhead<kGateUp>; ++u) {
    const int kx = kk + u * kKRows;
    if (kx < K) {
      d0[u] = *reinterpret_cast<const Pack<T>*>(p0 + static_cast<long>(kx) * N);
      if constexpr (kGateUp) {
        d1[u] = *reinterpret_cast<const Pack<T>*>(p1 + static_cast<long>(kx) * N);
      }
    }
  }
}

// One CTA: expert blockIdx.y, output columns [64 blockIdx.x, + 64).
// kGateUp: out[pos, c] = silu(x[tok] W0[:, c]) * (x[tok] W1[:, c]), tok =
// perm[pos] / k, over the K = D rows of W0 = W_gate[e], W1 = W_up[e].
// Else: out[pos, c] = in[pos] W0[:, c], over the K = F rows of W_down[e].
// Dynamic shared memory: the pass's input rows, [kRows][K] floats, then
// the warps' partial sums, [kWarps][kRows][2][kCols] floats.
template <typename T, bool kGateUp>
__global__ void __launch_bounds__(kMmThreads, 2)
    moe_rows_kernel(const T* __restrict__ in, const T* __restrict__ w0,
                    const T* __restrict__ w1, const int* __restrict__ offsets,
                    const int* __restrict__ perm, int k, int K, int N,
                    T* __restrict__ out) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int begin = offsets[e], n = offsets[e + 1] - begin;
  if (n <= 0) return;
  float* xs = smem;                              // [kRows][K]
  float* red = smem + kRows * K;                 // [kWarps][kRows][2][kCols]
  const int lc = threadIdx.x % kColLanes, kr = threadIdx.x / kColLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kCols;
  const int col = c0 + lc * kVec;
  const bool live = col < N;
  const long mat = static_cast<long>(e) * K * N;
  const T* p0 = w0 + mat + col;
  const T* p1 = kGateUp ? w1 + mat + col : nullptr;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    __syncthreads();  // the last pass's inputs and sums are read
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
      const int r = i / K, d = i % K;
      const long src = kGateUp ? perm[begin + r0 + r] / k : begin + r0 + r;
      xs[r * K + d] = to_f(in[src * K + d]);
    }
    __syncthreads();
    float a0[kRows][kVec], a1[kRows][kVec];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) a0[r][j] = a1[r][j] = 0.f;
    }
    if (live) {
      // The next step's loads are issued before this step's products, so
      // that a thread always has weights in flight.
      constexpr int kA = kAhead<kGateUp>, kStep = kKRows * kA;
      Pack<T> v0[kA], v1[kA];
      load_step<T, kGateUp>(p0, p1, N, K, kr, v0, v1);
      for (int kk = kr; kk < K; kk += kStep) {
        Pack<T> n0[kA], n1[kA];
        if (kk + kStep < K) load_step<T, kGateUp>(p0, p1, N, K, kk + kStep, n0, n1);
#pragma unroll
        for (int u = 0; u < kA; ++u) {
          const int kx = kk + u * kKRows;
          if (kx >= K) break;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
              const float xv = xs[r * K + kx];
#pragma unroll
              for (int j = 0; j < kVec; ++j) {
                a0[r][j] = fmaf(xv, to_f(v0[u].v[j]), a0[r][j]);
                if constexpr (kGateUp) a1[r][j] = fmaf(xv, to_f(v1[u].v[j]), a1[r][j]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kA; ++u) {
          v0[u] = n0[u];
          if constexpr (kGateUp) v1[u] = n1[u];
        }
      }
    }
    // Lanes l and l + 16 of a warp hold the same columns of two k-rows.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        a0[r][j] += __shfl_xor_sync(0xffffffffu, a0[r][j], 16);
        if constexpr (kGateUp) a1[r][j] += __shfl_xor_sync(0xffffffffu, a1[r][j], 16);
      }
    }
    if (lane < kColLanes) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) break;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          red[((warp * kRows + r) * 2) * kCols + lc * kVec + j] = a0[r][j];
          if constexpr (kGateUp) {
            red[((warp * kRows + r) * 2 + 1) * kCols + lc * kVec + j] = a1[r][j];
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kCols; i += blockDim.x) {
      const int r = i / kCols, c = i % kCols;
      if (c0 + c >= N) continue;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        s0 += red[((wi * kRows + r) * 2) * kCols + c];
        if constexpr (kGateUp) s1 += red[((wi * kRows + r) * 2 + 1) * kCols + c];
      }
      float v = s0;
      if constexpr (kGateUp) v = s0 / (1.f + expf(-s0)) * s1;
      out[static_cast<long>(begin + r0 + r) * N + c0 + c] = from_f<T>(v);
    }
  }
}

// out[t] = x[t] + sum over slots s of wts[t, s] * y[pos[t, s]], in slot
// order, float32, rounded once.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const int* __restrict__ pos, const float* __restrict__ wts, int k, int D,
                       T* __restrict__ out) {
  const long t = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = to_f(x[t * D + d]);
    for (int s = 0; s < k; ++s) {
      const int p = pos[t * k + s];
      if (p >= 0) {
        acc = __fadd_rn(acc, __fmul_rn(wts[t * k + s], to_f(y[static_cast<long>(p) * D + d])));
      }
    }
    out[t * D + d] = from_f<T>(acc);
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int launch_route(const void* h, const void* w, int N, int D, int E, int k, int norm, int* ids,
                 float* wts, cudaStream_t st) {
  const int smem = (D + kRouteThreads) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(moe_route_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  moe_route_kernel<T><<<N, kRouteThreads, smem, st>>>(static_cast<const T*>(h),
                                                      static_cast<const T*>(w), D, E, k, norm,
                                                      ids, wts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kGateUp>
int launch_rows(const void* in, const void* w0, const void* w1, const int* offsets,
                const int* perm, int k, int E, int K, int N, void* out, cudaStream_t st) {
  const int smem = (kRows * K + kWarps * kRows * 2 * kCols) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(moe_rows_kernel<T, kGateUp>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kCols - 1) / kCols, E);
  moe_rows_kernel<T, kGateUp><<<grid, kMmThreads, smem, st>>>(
      static_cast<const T*>(in), static_cast<const T*>(w0), static_cast<const T*>(w1), offsets,
      perm, k, K, N, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// h: [N, D]; w: [D, E]; ids: int32 [N, k]; wts: float32 [N, k]; dtype 0 =
// float32, 1 = bfloat16; E <= 256, k <= E.
int moe_route(const void* h, const void* w, int N, int D, int E, int k, int norm, void* ids,
              void* wts, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 1 || E < 1 || E > kMaxExperts || k < 1 || k > E ||
      (D + kRouteThreads) * 4 > 200 * 1024) {
    return kInvalid;
  }
  auto* pi = static_cast<int*>(ids);
  auto* pw = static_cast<float*>(wts);
  if (dtype == 0) return launch_route<float>(h, w, N, D, E, k, norm, pi, pw, st);
  if (dtype == 1) return launch_route<__nv_bfloat16>(h, w, N, D, E, k, norm, pi, pw, st);
  return kInvalid;
}

// ids: int32 [P] (P = N k routed rows); offsets: int32 [E + 1]; perm, pos:
// int32 [P]; counters: null or int64 [4], added to.
int moe_group(const void* ids, int P, int E, void* offsets, void* perm, void* pos,
              void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || E < 1 || E > kMaxExperts) return kInvalid;
  moe_group_kernel<<<1, kGroupThreads, 0, st>>>(
      static_cast<const int*>(ids), P, E, static_cast<int*>(offsets), static_cast<int*>(perm),
      static_cast<int*>(pos), static_cast<long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// x: [N, D]; w_gate, w_up: [E, D, F]; w_down: [E, F, D]; hidden: [P, F];
// y: [P, D]; offsets, perm from moe_group.  D and F multiples of 4.
int moe_experts(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                const void* offsets, const void* perm, int k, int E, int D, int F,
                void* hidden, void* y, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || E < 1 || D < kVec || F < kVec || D % kVec || F % kVec ||
      (kRows * (D > F ? D : F) + kWarps * kRows * 2 * kCols) * 4 > 200 * 1024) {
    return kInvalid;
  }
  const auto* off = static_cast<const int*>(offsets);
  const auto* pm = static_cast<const int*>(perm);
  int rc = kInvalid;
  if (dtype == 0) {
    rc = launch_rows<float, true>(x, w_gate, w_up, off, pm, k, E, D, F, hidden, st);
    if (rc == 0) {
      rc = launch_rows<float, false>(hidden, w_down, nullptr, off, pm, k, E, F, D, y, st);
    }
  } else if (dtype == 1) {
    rc = launch_rows<__nv_bfloat16, true>(x, w_gate, w_up, off, pm, k, E, D, F, hidden, st);
    if (rc == 0) {
      rc = launch_rows<__nv_bfloat16, false>(hidden, w_down, nullptr, off, pm, k, E, F, D, y, st);
    }
  }
  return rc;
}

// x, out: [N, D]; y: [P, D]; pos: int32 [N, k]; wts: float32 [N, k].
int moe_combine(const void* x, const void* y, const void* pos, const void* wts, int N, int k,
                int D, void* out, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || k < 1 || D < 1) return kInvalid;
  const auto* pp = static_cast<const int*>(pos);
  const auto* pw = static_cast<const float*>(wts);
  if (dtype == 0) {
    moe_combine_kernel<float><<<N, kCombineThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), pp, pw, k, D,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    moe_combine_kernel<__nv_bfloat16><<<N, kCombineThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y), pp, pw, k,
        D, static_cast<__nv_bfloat16*>(out));
  } else {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
