// The elementwise stages of a transformer layer on the inference paths,
// one launch each, for Hopper (sm_90a): RMSNorm, RoPE of q and k with the
// K/V pool write, and SiLU(gate) * up.
//
// These replace no TPU kernel.  The JAX reference leaves the same chains
// (models/llama.py: `_rms_norm`, `_rope`, the pool scatter, the MLP's
// gate) to XLA, which fuses each into one pass over the activations.
// Run op by op in PyTorch they are 9 (RMSNorm), about 16 (RoPE, for q and
// again for k), about 3 (the pool write) and 4 (SiLU) launches, each a
// float32 round trip through device memory: about 70 launches a layer
// against 7 GEMMs and one attention call.
//
// What bounds them on an H100: bytes.  Each reads its inputs once and
// writes its outputs once with a few float operations an element, far
// below the card's ~295 operations a byte; at the serving shapes the
// work is a few MB, so a call is as short as its launch, and the cost
// they cut is the host's dispatch of the chains they replace (eager
// prefills) and the nodes and float32 intermediates of the captured
// decode graph.  The design is therefore one pass each, intermediates in
// registers:
//
// - rms_norm: one CTA a row; the sum of squares in float32 in registers,
//   a warp-shuffle and shared-memory reduction, then a second pass over
//   the row (from L1/L2) that writes x * rsqrt(mean + eps) * w, rounded
//   once.  16-byte loads where the row allows.
// - rope_kv: one CTA a (token, group of 8 heads) of the H query heads,
//   then the Hkv key heads, then the Hkv value heads; the token's
//   cos/sin table (head_dim / 2 angles) is computed once into shared
//   memory.  q is rotated into q_out; k is rotated and v copied into the
//   pool slot named by `slots` (block id * block size + offset), and,
//   where given, into k_out / v_out (the tail of a continuation's
//   contiguous K/V, for its attention).
// - silu_mul: a grid-stride pass, 16 bytes a thread where aligned.
//
// Numbers: the same as the plain PyTorch chains on the card.  RoPE's
// angle is float(position) * freq, freq being the float32 tensor the
// plain path computes, and accurate cosf/sinf (no fast math: at positions
// of 12k the __sinf intrinsic drifts), each multiplied by `scale` (YaRN's
// attention factor on a model's full-attention layers, as Hugging Face's
// rotary embedding multiplies cos and sin; 1 elsewhere, exact); each product and sum is rounded as
// the plain ops round it (__fmul_rn, __fadd_rn, __fsub_rn: no fused
// multiply-add), so a rotated element is bit-equal to `_rope`'s.  SiLU is
// g / (1 + expf(-g)) in float32, rounded to the working type, then
// multiplied by up in float32 and rounded, as `F.silu(gate.float()).to(
// dtype) * up` computes it.  RMSNorm sums in another order than
// torch.mean, so it may differ from `_rms_norm` by a rounding.
//
// C interface for ctypes; each entry returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNormThreads = 256;
constexpr int kRopeWarps = 4;
constexpr int kRopeHeadsPerWarp = 2;
constexpr int kRopeHeads = kRopeWarps * kRopeHeadsPerWarp;  // heads a CTA
constexpr int kMaxHalf = 128;                                // head_dim 256
constexpr int kSiluThreads = 256;

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

// VEC elements moved as one load or store (16 bytes when VEC * sizeof(T)
// is 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float block_sum(float v, float* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / 32) ? shared[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

// out[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, in float32, rounded once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int D, float eps) {
  __shared__ float shared[kNormThreads / 32];
  using P = Pack<T, VEC>;
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const P* xr = reinterpret_cast<const P*>(x + base);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + base);
  const int packs = D / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < packs; i += kNormThreads) {
    const P p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = to_f(p.v[e]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = block_sum(ss, shared);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), eps));
  for (int i = threadIdx.x; i < packs; i += kNormThreads) {
    const P p = xr[i];
    const P pw = wr[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      o.v[e] = from_f<T>(__fmul_rn(__fmul_rn(to_f(p.v[e]), r), to_f(pw.v[e])));
    }
    orow[i] = o;
  }
}

// One CTA: token blockIdx.x, heads [8 * blockIdx.y, 8 * blockIdx.y + 8)
// of the H + 2 Hkv (q heads, then k, then v).  Token tok = b * T + t.
template <typename T, typename PT>
__global__ void __launch_bounds__(kRopeWarps * 32)
    rope_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const long long* __restrict__ positions, const float* __restrict__ freqs,
                   const long long* __restrict__ slots, T* __restrict__ q_out,
                   PT* __restrict__ kv_layer, T* __restrict__ k_out, T* __restrict__ v_out,
                   int T_len, int H, int Hkv, int Dh, int block_size, long long out_bstride,
                   float scale) {
  __shared__ float cs[kMaxHalf];
  __shared__ float sn[kMaxHalf];
  const long long tok = blockIdx.x;
  const int half = Dh / 2;
  const float pos = static_cast<float>(positions[tok]);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const float a = __fmul_rn(pos, freqs[j]);
    cs[j] = __fmul_rn(cosf(a), scale);
    sn[j] = __fmul_rn(sinf(a), scale);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long slot = slots[tok];
  const long long blk = slot / block_size;
  const long long in_blk = slot % block_size;
  const long long row = static_cast<long long>(Hkv) * Dh;  // a token's K or V
  PT* const k_pool = kv_layer + ((blk * 2) * block_size + in_blk) * row;
  PT* const v_pool = kv_layer + ((blk * 2 + 1) * block_size + in_blk) * row;
  const long long b = tok / T_len, t = tok % T_len;
  const long long out_row = b * out_bstride + t * row;

  for (int i = 0; i < kRopeHeadsPerWarp; ++i) {
    const int head = blockIdx.y * kRopeHeads + i * kRopeWarps + warp;
    if (head < H) {
      const T* src = q + (tok * H + head) * Dh;
      T* dst = q_out + (tok * H + head) * Dh;
      for (int j = lane; j < half; j += 32) {
        const float x1 = to_f(src[j]), x2 = to_f(src[j + half]);
        dst[j] = from_f<T>(__fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j])));
        dst[j + half] = from_f<T>(__fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j])));
      }
    } else if (head < H + Hkv) {
      const int kh = head - H;
      const T* src = k + (tok * Hkv + kh) * Dh;
      PT* pool = k_pool + static_cast<long long>(kh) * Dh;
      T* dst = k_out == nullptr ? nullptr : k_out + out_row + static_cast<long long>(kh) * Dh;
      for (int j = lane; j < half; j += 32) {
        const float x1 = to_f(src[j]), x2 = to_f(src[j + half]);
        const T r1 = from_f<T>(__fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j])));
        const T r2 = from_f<T>(__fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j])));
        pool[j] = from_f<PT>(to_f(r1));
        pool[j + half] = from_f<PT>(to_f(r2));
        if (dst != nullptr) {
          dst[j] = r1;
          dst[j + half] = r2;
        }
      }
    } else if (head < H + 2 * Hkv) {
      const int vh = head - H - Hkv;
      const T* src = v + (tok * Hkv + vh) * Dh;
      PT* pool = v_pool + static_cast<long long>(vh) * Dh;
      T* dst = v_out == nullptr ? nullptr : v_out + out_row + static_cast<long long>(vh) * Dh;
      for (int j = lane; j < Dh; j += 32) {
        const T x = src[j];
        pool[j] = from_f<PT>(to_f(x));
        if (dst != nullptr) dst[j] = x;
      }
    }
  }
}

// out = round(round(silu(float(gate))) * float(up)).
template <typename T, int VEC>
__global__ void __launch_bounds__(kSiluThreads)
    silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ out,
                    long long packs) {
  using P = Pack<T, VEC>;
  const P* g = reinterpret_cast<const P*>(gate);
  const P* u = reinterpret_cast<const P*>(up);
  P* o = reinterpret_cast<P*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kSiluThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kSiluThreads + threadIdx.x; i < packs;
       i += stride) {
    const P pg = g[i];
    const P pu = u[i];
    P r;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = to_f(pg.v[e]);
      const T s = from_f<T>(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x))));
      r.v[e] = from_f<T>(__fmul_rn(to_f(s), to_f(pu.v[e])));
    }
    o[i] = r;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) % 16) == 0; }

template <typename T>
int launch_rms_norm(const void* x, const void* w, void* out, long long rows, int D, float eps,
                    cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const auto* px = static_cast<const T*>(x);
  const auto* pw = static_cast<const T*>(w);
  auto* po = static_cast<T*>(out);
  if (D % kVec == 0 && aligned16(x) && aligned16(w) && aligned16(out)) {
    rms_norm_kernel<T, kVec><<<static_cast<unsigned>(rows), kNormThreads, 0, st>>>(px, pw, po, D,
                                                                                     eps);
  } else {
    rms_norm_kernel<T, 1><<<static_cast<unsigned>(rows), kNormThreads, 0, st>>>(px, pw, po, D,
                                                                                 eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT>
int launch_rope_kv(const void* q, const void* k, const void* v, const void* positions,
                   const void* freqs, const void* slots, void* q_out, void* kv_layer,
                   void* k_out, void* v_out, long long tokens, int T_len, int H, int Hkv,
                   int Dh, int block_size, long long out_bstride, float scale,
                   cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(tokens),
                  static_cast<unsigned>((H + 2 * Hkv + kRopeHeads - 1) / kRopeHeads));
  rope_kv_kernel<T, PT><<<grid, kRopeWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const long long*>(positions), static_cast<const float*>(freqs),
      static_cast<const long long*>(slots), static_cast<T*>(q_out), static_cast<PT*>(kv_layer),
      static_cast<T*>(k_out), static_cast<T*>(v_out), T_len, H, Hkv, Dh, block_size,
      out_bstride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_silu_mul(const void* gate, const void* up, void* out, long long n, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = n % kVec == 0 && aligned16(gate) && aligned16(up) && aligned16(out);
  const long long packs = vec ? n / kVec : n;
  long long blocks = (packs + kSiluThreads - 1) / kSiluThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // a grid-stride loop past that
  const auto* pg = static_cast<const T*>(gate);
  const auto* pu = static_cast<const T*>(up);
  auto* po = static_cast<T*>(out);
  if (vec) {
    silu_mul_kernel<T, kVec><<<static_cast<unsigned>(blocks), kSiluThreads, 0, st>>>(pg, pu, po,
                                                                                   packs);
  } else {
    silu_mul_kernel<T, 1><<<static_cast<unsigned>(blocks), kSiluThreads, 0, st>>>(pg, pu, po,
                                                                                packs);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// x, out: [rows, D], w: [D], contiguous, one dtype (0 = float32,
// 1 = bfloat16).
int rms_norm(const void* x, const void* w, void* out, long long rows, int D, float eps,
             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 0x7fffffffLL || D < 1) return kInvalid;
  if (dtype == 0) return launch_rms_norm<float>(x, w, out, rows, D, eps, st);
  if (dtype == 1) return launch_rms_norm<__nv_bfloat16>(x, w, out, rows, D, eps, st);
  return kInvalid;
}

// q: [tokens, H, Dh], k, v: [tokens, Hkv, Dh], contiguous in `dtype`;
// positions, slots: int64 [tokens]; freqs: float32 [Dh / 2]; q_out like
// q; kv_layer: [num_blocks, 2, block_size, Hkv, Dh] in `pool_dtype`;
// k_out, v_out: null or [B, T_len, Hkv, Dh] with batch stride
// `out_bstride` elements, tokens = B * T_len.  Dh even, at most 256.
// cos and sin are multiplied by `scale`.
int rope_kv(const void* q, const void* k, const void* v, const void* positions,
            const void* freqs, const void* slots, void* q_out, void* kv_layer, void* k_out,
            void* v_out, long long tokens, int T_len, int H, int Hkv, int Dh, int block_size,
            long long out_bstride, float scale, int dtype, int pool_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tokens < 1 || tokens > 0x7fffffffLL || T_len < 1 || tokens % T_len || H < 1 ||
      Hkv < 1 || Dh < 2 || Dh % 2 || Dh / 2 > kMaxHalf || block_size < 1) {
    return kInvalid;
  }
#define KVTPU_ROPE(T, PT)                                                                    \
  return launch_rope_kv<T, PT>(q, k, v, positions, freqs, slots, q_out, kv_layer, k_out,    \
                               v_out, tokens, T_len, H, Hkv, Dh, block_size, out_bstride,    \
                               scale, st)
  if (dtype == 0 && pool_dtype == 0) KVTPU_ROPE(float, float);
  if (dtype == 0 && pool_dtype == 1) KVTPU_ROPE(float, __nv_bfloat16);
  if (dtype == 1 && pool_dtype == 0) KVTPU_ROPE(__nv_bfloat16, float);
  if (dtype == 1 && pool_dtype == 1) KVTPU_ROPE(__nv_bfloat16, __nv_bfloat16);
#undef KVTPU_ROPE
  return kInvalid;
}

// gate, up, out: n elements each, contiguous, one dtype.
int silu_mul(const void* gate, const void* up, void* out, long long n, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return kInvalid;
  if (dtype == 0) return launch_silu_mul<float>(gate, up, out, n, st);
  if (dtype == 1) return launch_silu_mul<__nv_bfloat16>(gate, up, out, n, st);
  return kInvalid;
}

}  // extern "C"
