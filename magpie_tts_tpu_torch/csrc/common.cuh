// Block-level reductions and device helpers shared by the port's kernels.
//
// Every reduction combines partial results in a fixed order (warp butterfly,
// then warp 0..n-1), so a kernel gives the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MAGPIE_FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(MAGPIE_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(MAGPIE_FULL_MASK, v, o));
  return v;
}

// Sum over the block; every thread receives the total. `red` holds 32 floats.
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

// Argmax with jnp.argmax's tie rule: the larger value wins, equal values go
// to the LOWER index. NaN never wins (comparisons are false).
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ int block_argmax(float v, int i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(MAGPIE_FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(MAGPIE_FULL_MASK, i, o);
    argmax_merge(v, i, ov, oi);
  }
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  float bv = redv[0];
  int bi = redi[0];
  for (int w = 1; w < nw; ++w) argmax_merge(bv, bi, redv[w], redi[w]);
  return bi;
}

__device__ __forceinline__ int block_min_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(MAGPIE_FULL_MASK, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int t = red[0];
  for (int i = 1; i < nw; ++i) t = min(t, red[i]);
  return t;
}

__device__ __forceinline__ int block_max_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(MAGPIE_FULL_MASK, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int t = red[0];
  for (int i = 1; i < nw; ++i) t = max(t, red[i]);
  return t;
}

// The compute dtypes: a kernel templated on T stores weights, caches and its
// rows in T (float or __nv_bfloat16) and computes in float32. ld widens a
// stored value (exact), st<T> narrows with round-to-nearest-even (torch's
// .to(torch.bfloat16)), and rnd<T>(v) is the value v takes in T: the
// JAX source's .astype(wdt), the identity for float.
__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T st(float v);
template <>
__device__ __forceinline__ float st<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <class T>
__device__ __forceinline__ float rnd(float v) { return ld(st<T>(v)); }

// LayerNorm without bias over x[0:N] (float32 statistics, the plain version's
// op order: mean = sum/N, var = sum(c*c)/N, (x - mean) / sqrt(var + eps) * w),
// rounded to T (the JAX source's .astype(wdt) after every norm) and stored
// as O (float workspace or a T row). Each thread reads only the x[n] it may
// have just written itself.
template <class T, class O>
__device__ __forceinline__ void block_layer_norm(const float* x, const T* w, O* out,
                                                 int N, float eps, float* red) {
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) s += x[n];
  const float mean = block_sum(s, red) / (float)N;
  float v = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float c = x[n] - mean;
    v += c * c;
  }
  const float var = block_sum(v, red) / (float)N;
  const float denom = sqrtf(var + eps);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    out[n] = st<O>(rnd<T>(((x[n] - mean) / denom) * ld(w[n])));
  }
}

constexpr float kNegBig = -1e30f;          // masked score / logit (jnp's _NEG)
constexpr int kSampleThreads = 1024;        // threads of an LT sampling block
constexpr int kMaxVocab = 4096;             // the largest vocabulary a sampler takes

// The JAX package's int32 hash constants (magpie_tts_tpu/ops/sampling.py).
constexpr uint32_t kMixA = 0x85EBCA6Bu;
constexpr uint32_t kMixB = 0xC2B2AE3Du;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kPhaseC = 0x2C9277B5u;

__device__ __forceinline__ float gelu_f(float x, int tanh_flavor) {
  if (tanh_flavor) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixA;
  x ^= x >> 13;
  x *= kMixB;
  x ^= x >> 16;
  return x;
}

// Monotone int key of a float: f1 < f2 <=> key(f1) < key(f2); +0 == -0.
__device__ __forceinline__ int order_key(float f) {
  const int bits = __float_as_int(f);
  return bits >= 0 ? bits : (int)(0x80000000u - (uint32_t)bits);
}

// Whether an LT logit is always forbidden (AUDIO_BOS, BOS+2..BOS+7) or is
// EOS while EOS is forbidden.
__device__ __forceinline__ bool lt_forbidden(int v, int bos_id, int eos_id, int forbid_eos) {
  return v == bos_id || (v >= bos_id + 2 && v <= bos_id + 7) || (forbid_eos && v == eos_id);
}

// The k-th largest order_key of lg[0:V] (1 <= k <= V), by an exact radix
// select: 4 passes of 8 bits from the top, each a 256-bin histogram in
// shared memory (hist, 256 ints) of the keys that share the prefix found so
// far, then a scan from the top bin by warp 0 for the bin that holds the
// k-th key (sel, 2 ints). Any block size that is a multiple of 32 works;
// every thread gets the key. The k-th largest key is one value, so the set
// key >= it equals that of a 32-pass bisection on the same keys
// (ops/sampling.exact_topk_mask), ties and all.
__device__ __forceinline__ int block_kth_key(const float* lg, int V, int k, int* hist,
                                             int* sel) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  uint32_t prefix = 0u, mask = 0u;
  int rest = k;  // rank still to find among the keys with the prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += bd) hist[i] = 0;
    __syncthreads();
    for (int v = tid; v < V; v += bd) {
      const uint32_t u = (uint32_t)order_key(lg[v]) ^ 0x80000000u;  // unsigned order
      if ((u & mask) == prefix) atomicAdd(hist + ((u >> shift) & 255u), 1);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 - 8l down to 248 - 8l; counts above it by a scan
      int c[8], own = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) own += (c[i] = hist[255 - 8 * lane - i]);
      int incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(MAGPIE_FULL_MASK, incl, o);
        if (lane >= o) incl += t;
      }
      int above = incl - own;
      if (above < rest && rest <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (above < rest && rest <= above + c[i]) {
            sel[0] = 255 - 8 * lane - i;
            sel[1] = above;
          }
          above += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)sel[0] << shift;
    mask |= 255u << shift;
    rest -= sel[1];
    __syncthreads();  // sel and hist are rewritten by the next pass
  }
  return (int)(prefix ^ 0x80000000u);
}

// One LT phase's draw by one block over the masked logits lg[0:V] (each
// thread touches only v = tid + j * blockDim.x, so lg needs no barrier):
// argmax with ties to the lowest index; at temperature >= 0.01 the exact
// top-k set, key >= the k-th largest order_key (block_kth_key), and a
// Gumbel-max draw with the noise of fmix32(base + v * kGolden). Every thread
// gets the code; `amax` receives the argmax. Any block size (a multiple of
// 32) gives the same code.
__device__ __forceinline__ int block_sample(const float* lg, int V, float temperature, int top_k,
                                            uint32_t base, float* redv, int* redi, int* hist,
                                            int& amax) {
  const int tid = threadIdx.x, bd = blockDim.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int v = tid; v < V; v += bd) argmax_merge(bv, bi, lg[v], v);
  amax = block_argmax(bv, bi, redv, redi);
  if (temperature < 0.01f) return amax;

  const int lo = block_kth_key(lg, V, min(top_k, V), hist, redi);
  const float t = fmaxf(temperature, 0.01f);
  float bz = -INFINITY;
  int bzi = INT_MAX;
  for (int v = tid; v < V; v += bd) {
    float z = kNegBig;
    if (order_key(lg[v]) >= lo) {
      const uint32_t hsh = fmix32(base + (uint32_t)v * kGolden);
      float u = (float)(hsh >> 8) * (1.0f / 16777216.0f);
      u = fminf(fmaxf(u, 1e-10f), 0.99999988f);
      const float g = -logf(-logf(u));
      z = lg[v] / t + g;
    }
    argmax_merge(bz, bzi, z, v);
  }
  return block_argmax(bz, bzi, redv, redi);
}

#define MAGPIE_CHECK_LAUNCH()                       \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)
