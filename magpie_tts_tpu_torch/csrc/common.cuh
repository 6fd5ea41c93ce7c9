// Block-level reductions shared by the port's kernels.
//
// Every reduction combines partial results in a fixed order (warp butterfly,
// then warp 0..n-1), so a kernel gives the same bits on every run.

#pragma once

#include <cuda_runtime.h>
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

#define MAGPIE_CHECK_LAUNCH()                       \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)
