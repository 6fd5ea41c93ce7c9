// Block-level reductions and device helpers shared by the port's kernels.
//
// Every reduction combines partial results in a fixed order (warp butterfly,
// then warp 0..n-1), so a kernel gives the same bits on every run.

#pragma once

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

// LayerNorm without bias over x[0:N] (float32 statistics, the plain version's
// op order: mean = sum/N, var = sum(c*c)/N, (x - mean) / sqrt(var + eps) * w).
// Each thread reads only the x[n] it may have just written itself.
__device__ __forceinline__ void block_layer_norm(const float* x, const float* w, float* out,
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
  for (int n = threadIdx.x; n < N; n += blockDim.x) out[n] = ((x[n] - mean) / denom) * w[n];
}

constexpr float kNegBig = -1e30f;          // masked score / logit (jnp's _NEG)
constexpr int kSampleThreads = 1024;        // threads of an LT sampling block
constexpr int kMaxVocab = 4 * kSampleThreads;

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

// One LT phase's draw by a block of kSampleThreads over the masked logits
// lg[0:V] (each thread touches only v = tid + j * blockDim.x, so lg needs no
// barrier): argmax with ties to the lowest index; at temperature >= 0.01 the
// exact top-k set by 32-pass integer bisection on order_key and a Gumbel-max
// draw with the noise of fmix32(base + v * kGolden). Every thread gets the
// code; `amax` receives the argmax.
__device__ __forceinline__ int block_sample(const float* lg, int V, float temperature, int top_k,
                                            uint32_t base, float* redv, int* redi, int& amax) {
  const int tid = threadIdx.x, bd = blockDim.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int v = tid; v < V; v += bd) argmax_merge(bv, bi, lg[v], v);
  amax = block_argmax(bv, bi, redv, redi);
  if (temperature < 0.01f) return amax;

  const int k = min(top_k, V);
  int kmin = INT_MAX, kmax = INT_MIN;
  for (int v = tid; v < V; v += bd) {
    const int key = order_key(lg[v]);
    kmin = min(kmin, key);
    kmax = max(kmax, key);
  }
  long long lo = block_min_int(kmin, redi);
  long long hi = (long long)block_max_int(kmax, redi) + 1;
  for (int it = 0; it < 32; ++it) {
    const long long mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
    for (int j = 0; j < kMaxVocab / kSampleThreads; ++j) {
      const int v = tid + j * bd;
      cnt += __syncthreads_count(v < V && (long long)order_key(lg[v]) >= mid);
    }
    if (cnt >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float t = fmaxf(temperature, 0.01f);
  float bz = -INFINITY;
  int bzi = INT_MAX;
  for (int v = tid; v < V; v += bd) {
    float z = kNegBig;
    if ((long long)order_key(lg[v]) >= lo) {
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
