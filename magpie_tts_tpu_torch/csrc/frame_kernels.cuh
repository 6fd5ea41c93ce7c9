// Per-slot kernels of a decode frame, launched by frame_sequence.cuh for
// frame_step.cu (one slot) and frame_step_batched.cu (B slots): the
// reduction of split-K partials into residual / LayerNorm, activation and QKV
// rows, single-query attention and one LT phase's sampling; and the weight
// loads every GEMV / GEMM shares, for the dense, int8-column and Q8_0-block
// weight streams. Every kernel
// takes the slot from its grid (gridDim = 1 slot for frame_step.cu) and reads
// partials laid out as part[(s * B + b) * N + n]; with B = 1 that is the
// single-slot [S, N] layout.
// Sums run in a fixed order with no atomics, so a frame gives the same bits
// on every run.
//
// Every kernel is templated on the compute dtype T (float or
// __nv_bfloat16): weights, caches and the hidden rows are T, the partials,
// the residual x and the workspace rows float32. A row that feeds a matrix
// product is rounded to T (rnd<T>) where the Pallas kernels write
// .astype(wdt) (magpie_tts_tpu/ops/pallas_kernels/frame_step.py): the LT
// projection, norms, q / k / v, probabilities, attention outputs and the
// activation; with T = float every rnd is the identity, so the float32
// kernels compute exactly what they did before the dtype was templated.

#pragma once

#include "common.cuh"

namespace {

constexpr int kRt = 256;  // threads of the reduce / attention kernels

// The weight modes of a matrix product: dense T W [K, N]; int8 q [K, N]
// with per-column scales s [N] (applied by the reducer, col_scale above); or
// int8 q [K, N] with Q8_0 block scales s [K / 32, N] (f16-valued, one per 32
// rows of a column), applied to each weight before its product.
enum StreamMode { kStreamDense = 0, kStreamInt8 = 1, kStreamQ8 = 2 };

// One matrix a GEMV / GEMM reads, in one of the three modes.
template <class T>
struct WeightRef {
  const T* w;            // kStreamDense
  const signed char* q;  // kStreamInt8 / kStreamQ8
  const float* s;
  int mode;
};

template <class T>
inline WeightRef<T> dense_ref(const T* w) {
  return WeightRef<T>{w, nullptr, nullptr, kStreamDense};
}

// Four consecutive dense weights as float4: one 16-byte load of float, one
// 8-byte load of bf16 (widening bf16 is a 16-bit shift).
__device__ __forceinline__ float4 load_dense4(const float* w, size_t i4) {
  return __ldg(reinterpret_cast<const float4*>(w) + i4);
}
__device__ __forceinline__ float4 load_dense4(const __nv_bfloat16* w, size_t i4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(w) + i4);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// One element of a row a product reads, widened to float.
__device__ __forceinline__ float load_x(const float* x) { return __ldg(x); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* x) { return __bfloat162float(*x); }

// Row k, columns 4 * c4 .. 4 * c4 + 3 of a matrix N = 4 * n4 wide, as float4:
// the dense values, the int8 values (exact in T), or the int8 values times
// their block scale, rounded to T (the Pallas stream_w). An f16-valued scale
// times an int8 value is exact in f32, so a Q8_0 weight equals its copy
// dequantized at load in T bit for bit.
template <int MODE, class T>
__device__ __forceinline__ float4 load_w4(const WeightRef<T>& W, size_t k, int n4, int c4) {
  if constexpr (MODE == kStreamDense) {
    return load_dense4(W.w, k * n4 + c4);
  } else {
    const char4 q = __ldg(reinterpret_cast<const char4*>(W.q) + k * n4 + c4);
    float4 w = make_float4((float)q.x, (float)q.y, (float)q.z, (float)q.w);
    if constexpr (MODE == kStreamQ8) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(W.s) + (k >> 5) * n4 + c4);
      w.x = rnd<T>(s.x * w.x);
      w.y = rnd<T>(s.y * w.y);
      w.z = rnd<T>(s.z * w.z);
      w.w = rnd<T>(s.w * w.w);
    }
    return w;
  }
}

// Sum over s of part[(s * B + b) * N + n], in order of s; the pointer steps
// over the B * N floats between partial rows (no index arithmetic per load).
__device__ __forceinline__ float sum_parts(const float* part, int S, int B, int N, int b, int n) {
  const size_t stride = (size_t)B * N;
  const float* p = part + (size_t)b * N + n;
  float v = 0.f;
  for (int s = 0; s < S; ++s, p += stride) v += *p;
  return v;
}

// The reducers below take an optional col_scale[N]: the per-column scale of
// an int8 weight stream, applied once to the fixed-order sum of the partials
// (the plain (x @ q) * s). Null for a dense or Q8_0 stream.

// One block per slot b. v = sum of the S partials of row b (* col_scale)
// (+ bias); then either x[b] += v (accumulate) or x[b] = rnd(v) + add (the
// LT's projection, rounded before its position row); then h[b] =
// rnd(LayerNorm(x[b]) * ln_w) when ln_w is given, stored as H (the float
// workspace, or the T hidden rows after the last layer).
template <class T, class H>
__global__ void combine_ln_kernel(const float* __restrict__ part, int S, int N,
                                  const float* __restrict__ col_scale,
                                  const T* __restrict__ bias, const T* __restrict__ add,
                                  float* x, int accumulate, const T* __restrict__ ln_w,
                                  float eps, H* h) {
  __shared__ float red[32];
  const int b = blockIdx.x, B = gridDim.x;
  float* xb = x + (size_t)b * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float v = sum_parts(part, S, B, N, b, n);
    if (col_scale) v *= col_scale[n];
    if (bias) v += ld(bias[n]);
    if (accumulate) {
      xb[n] = xb[n] + v;
    } else {
      xb[n] = add ? rnd<T>(v) + ld(add[n]) : v;
    }
  }
  if (ln_w) block_layer_norm<T>(xb, ln_w, h + (size_t)b * N, N, eps, red);
}

// The split paths' decoder input, one block per slot b: x[b] = x_in[b], or
// rnd(x_in[b] + add) with add (the JAX decode step's embedding + position
// row, a sum in T); h[b] = rnd(LayerNorm(x[b]) * ln_w).
template <class T>
__global__ void decoder_input_kernel(const T* __restrict__ x_in, const T* __restrict__ add,
                                     int N, float* x, const T* __restrict__ ln_w, float eps,
                                     float* h) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  float* xb = x + (size_t)b * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float v = 0.f + ld(x_in[(size_t)b * N + n]);
    xb[n] = add ? rnd<T>(v + ld(add[n])) : v;
  }
  block_layer_norm<T>(xb, ln_w, h + (size_t)b * N, N, eps, red);
}

// out[b, n] = rnd(act(sum of partials (* col_scale))); act 0 = none, 1 =
// GELU. The row feeds the next product, hence the round. Grid (., B).
template <class T>
__global__ void reduce_act_kernel(const float* __restrict__ part, int S, int N,
                                  const float* __restrict__ col_scale, int gelu, int gelu_tanh,
                                  float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, B = gridDim.y;
  if (n >= N) return;
  float v = sum_parts(part, S, B, N, b, n);
  if (col_scale) v *= col_scale[n];
  out[(size_t)b * N + n] = rnd<T>(gelu ? gelu_f(v, gelu_tanh) : v);
}

// Reduces the fused QKV partials [S, B, 3*D] (* col_scale), rounded to T:
// q -> q_out[b], and the new K / V rows into k_row / v_row + b * slot_stride
// (the cache row of every slot; the row is written before attending).
// Grid (., B).
template <class T>
__global__ void qkv_scatter_kernel(const float* __restrict__ part, int S, int D,
                                   const float* __restrict__ col_scale,
                                   float* __restrict__ q_out, T* __restrict__ k_row,
                                   T* __restrict__ v_row, size_t slot_stride) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, B = gridDim.y;
  if (n >= 3 * D) return;
  float v = sum_parts(part, S, B, 3 * D, b, n);
  if (col_scale) v *= col_scale[n];
  if (n < D) {
    q_out[(size_t)b * D + n] = rnd<T>(v);
  } else if (n < 2 * D) {
    k_row[b * slot_stride + n - D] = st<T>(v);
  } else {
    v_row[b * slot_stride + n - 2 * D] = st<T>(v);
  }
}

// Single-query attention, block (head, slot). q is the sum of Sq partials
// [Sq, B, Nq] (Sq = 1: a plain [B, Nq] row), rounded to T. K / V (T) of slot
// b start at b * slot_stride, rows `row_stride` elements apart; the head's
// columns start at head * d_head. Rows [0, rows) are attended; with rows_dev
// the slot's own count min(max(rows_dev[b], 1), rows) is used instead. With
// `valid`, row r of slot b counts when valid[b * valid_stride + r] (row
// write_row, when new_valid is given: when new_valid[b]); other rows score
// -1e30. Scores are scaled, softmaxed as exp(s - max) / sum, the
// probabilities rounded to T weight the V rows, and the output is rounded to
// T (it feeds the output projection).
// Dynamic shared memory: attention_smem(d_head, rows).
template <class T>
__global__ void attention_kernel(const float* __restrict__ qpart, int Sq, int Nq,
                                 const T* __restrict__ K, const T* __restrict__ V,
                                 size_t slot_stride, int row_stride, int rows,
                                 const int* __restrict__ rows_dev,
                                 const unsigned char* __restrict__ valid, int valid_stride,
                                 int write_row, const int* __restrict__ new_valid, int d_head,
                                 float scale, float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  const int b = blockIdx.y, B = gridDim.y;
  const int n_rows = rows_dev ? min(max(rows_dev[b], 1), rows) : rows;
  float* qs = sm;
  float* sc = sm + d_head;
  float* acc = sc + n_rows;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = bd >> 5;
  const int off = blockIdx.x * d_head;
  K += b * slot_stride;
  V += b * slot_stride;

  for (int d = tid; d < d_head; d += bd) qs[d] = rnd<T>(sum_parts(qpart, Sq, B, Nq, b, off + d));
  __syncthreads();
  for (int r = warp; r < n_rows; r += nw) {
    const T* kr = K + (size_t)r * row_stride + off;
    float dot = 0.f;
    for (int d = lane; d < d_head; d += 32) dot = fmaf(qs[d], ld(kr[d]), dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      bool ok = true;
      if (valid) {
        ok = new_valid && r == write_row ? new_valid[b] != 0
                                         : valid[(size_t)b * valid_stride + r] != 0;
      }
      sc[r] = ok ? dot * scale : kNegBig;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int r = tid; r < n_rows; r += bd) m = fmaxf(m, sc[r]);
  m = block_max(m, red);
  float s = 0.f;
  for (int r = tid; r < n_rows; r += bd) {
    const float e = expf(sc[r] - m);
    sc[r] = e;
    s += e;
  }
  s = block_sum(s, red);
  for (int r = tid; r < n_rows; r += bd) sc[r] = rnd<T>(sc[r] / s);
  __syncthreads();

  float* ob = out + (size_t)b * Nq + off;
  if (d_head <= bd) {
    const int G = bd / d_head;
    const int d = tid % d_head, gg = tid / d_head;
    float a = 0.f;
    if (gg < G) {
      for (int r = gg; r < n_rows; r += G) {
        a = fmaf(sc[r], ld(V[(size_t)r * row_stride + off + d]), a);
      }
    }
    acc[tid] = a;
    __syncthreads();
    if (tid < d_head) {
      float o = 0.f;
      for (int k = 0; k < G; ++k) o += acc[k * d_head + tid];
      ob[tid] = rnd<T>(o);
    }
  } else {
    for (int d = tid; d < d_head; d += bd) {
      float a = 0.f;
      for (int r = 0; r < n_rows; ++r) a = fmaf(sc[r], ld(V[(size_t)r * row_stride + off + d]), a);
      ob[d] = rnd<T>(a);
    }
  }
}

// attention_kernel's dynamic shared memory at kRt threads.
int attention_smem(int d_head, int rows) {
  return (d_head + rows + kRt) * (int)sizeof(float);
}

// One LT phase's sampling, one block of kSampleThreads per slot b: logits =
// partials + bias, forbidden specials -> -1e30, then block_sample with the
// slot's seed. The slot's flags are forbid_eos[b] and seeds[b]; a null array
// gives every slot forbid_eos1 / seed1. The sampled code's embedding row is
// kept for the next phase's input projection and added to the slot's
// embedding sum (float32). With x (the fused frame), the last phase seeds the
// decoder with the Pallas kernels' rounding points, x[b] = rnd(rnd(sum /
// n_cb) + posemb[b]), h[b] = rnd(LayerNorm(x[b])) with layer 0's norm;
// with new_valid it decides the new row's validity: may_continue[b] && no
// sampled or argmax code of the frame is EOS. The split path's LT sampler
// passes neither and stops at the codes.
template <class T>
__global__ void __launch_bounds__(kSampleThreads)
lt_sample_kernel(const float* __restrict__ part, int S, int V, const T* __restrict__ bias,
                 int cb, int ncb, const unsigned char* __restrict__ forbid_eos, int forbid_eos1,
                 int bos_id, int eos_id, const int* __restrict__ seeds, int seed1,
                 float temperature, int top_k, const T* __restrict__ emb_table, int D,
                 int* __restrict__ codes, int* __restrict__ amax_out, float* __restrict__ emb_row,
                 float* __restrict__ emb_acc, const T* __restrict__ posemb,
                 int posemb_stride, const unsigned char* __restrict__ may_continue,
                 int* __restrict__ new_valid, float* __restrict__ x,
                 const T* __restrict__ ln_w, float eps, float* __restrict__ h) {
  __shared__ float lg[kMaxVocab];
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int b = blockIdx.x, B = gridDim.x;
  const int forbid = forbid_eos ? forbid_eos[b] : forbid_eos1;
  const uint32_t seed = (uint32_t)(seeds ? seeds[b] : seed1);

  for (int v = tid; v < V; v += bd) {
    const float l = sum_parts(part, S, B, V, b, v) + ld(bias[v]);
    lg[v] = lt_forbidden(v, bos_id, eos_id, forbid) ? kNegBig : l;
  }
  int amax;
  const int code = block_sample(lg, V, temperature, top_k, seed + (uint32_t)cb * kPhaseC, redv,
                                redi, amax);

  const bool last = cb == ncb - 1;
  const bool to_decoder = last && x != nullptr;
  if (tid == 0) {
    codes[b * ncb + cb] = code;
    amax_out[b * ncb + cb] = amax;
    if (last && new_valid) {
      bool eos = false;
      for (int c = 0; c < ncb; ++c) {
        eos = eos || codes[b * ncb + c] == eos_id || amax_out[b * ncb + c] == eos_id;
      }
      new_valid[b] = may_continue[b] != 0 && !eos;
    }
  }
  const T* er = emb_table + (size_t)code * D;
  float* rb = emb_row + (size_t)b * D;
  float* ab = emb_acc + (size_t)b * D;
  for (int n = tid; n < D; n += bd) {
    const float e = ld(er[n]);
    rb[n] = e;
    const float s = cb == 0 ? e : ab[n] + e;
    ab[n] = s;
    if (to_decoder) {
      x[(size_t)b * D + n] =
          rnd<T>(rnd<T>(s / (float)ncb) + ld(posemb[(size_t)b * posemb_stride + n]));
    }
  }
  if (to_decoder) block_layer_norm<T>(x + (size_t)b * D, ln_w, h + (size_t)b * D, D, eps, redv);
}

}  // namespace
