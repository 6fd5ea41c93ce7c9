// Per-slot kernels of a decode frame, launched by frame_sequence.cuh for
// frame_step.cu (one slot) and frame_step_batched.cu (B slots): the
// reduction of split-K partials into residual / LayerNorm, activation and QKV
// rows, single-query attention and one LT phase's sampling. Every kernel
// takes the slot from its grid (gridDim = 1 slot for frame_step.cu) and reads
// partials laid out as part[(s * B + b) * N + n]; with B = 1 that is the
// single-slot [S, N] layout.
// Sums run in a fixed order with no atomics, so a frame gives the same bits
// on every run.

#pragma once

#include "common.cuh"

namespace {

constexpr int kRt = 256;  // threads of the reduce / attention kernels

// Sum over s of part[(s * B + b) * N + n], in order of s; the pointer steps
// over the B * N floats between partial rows (no index arithmetic per load).
__device__ __forceinline__ float sum_parts(const float* part, int S, int B, int N, int b, int n) {
  const size_t stride = (size_t)B * N;
  const float* p = part + (size_t)b * N + n;
  float v = 0.f;
  for (int s = 0; s < S; ++s, p += stride) v += *p;
  return v;
}

// One block per slot b. v = sum of the S partials of row b (+ bias); then
// either x[b] += v (accumulate) or x[b] = v (+ add, one row for all slots);
// then h[b] = LayerNorm(x[b]) * ln_w when ln_w is given.
__global__ void combine_ln_kernel(const float* __restrict__ part, int S, int N,
                                  const float* __restrict__ bias, const float* __restrict__ add,
                                  float* x, int accumulate, const float* __restrict__ ln_w,
                                  float eps, float* h) {
  __shared__ float red[32];
  const int b = blockIdx.x, B = gridDim.x;
  float* xb = x + (size_t)b * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float v = sum_parts(part, S, B, N, b, n);
    if (bias) v += bias[n];
    if (accumulate) {
      xb[n] = xb[n] + v;
    } else {
      xb[n] = add ? v + add[n] : v;
    }
  }
  if (ln_w) block_layer_norm(xb, ln_w, h + (size_t)b * N, N, eps, red);
}

// out[b, n] = act(sum of partials); act 0 = none, 1 = GELU. Grid (., B).
__global__ void reduce_act_kernel(const float* __restrict__ part, int S, int N, int gelu,
                                  int gelu_tanh, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, B = gridDim.y;
  if (n >= N) return;
  const float v = sum_parts(part, S, B, N, b, n);
  out[(size_t)b * N + n] = gelu ? gelu_f(v, gelu_tanh) : v;
}

// Reduces the fused QKV partials [S, B, 3*D]: q -> q_out[b], and the new K / V
// rows into k_row / v_row + b * slot_stride (the cache row of every slot; the
// row is written before attending). Grid (., B).
__global__ void qkv_scatter_kernel(const float* __restrict__ part, int S, int D,
                                   float* __restrict__ q_out, float* __restrict__ k_row,
                                   float* __restrict__ v_row, size_t slot_stride) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, B = gridDim.y;
  if (n >= 3 * D) return;
  const float v = sum_parts(part, S, B, 3 * D, b, n);
  if (n < D) {
    q_out[(size_t)b * D + n] = v;
  } else if (n < 2 * D) {
    k_row[b * slot_stride + n - D] = v;
  } else {
    v_row[b * slot_stride + n - 2 * D] = v;
  }
}

// Single-query attention, block (head, slot). q is the sum of Sq partials
// [Sq, B, Nq] (Sq = 1: a plain [B, Nq] row). K / V of slot b start at
// b * slot_stride, rows `row_stride` floats apart; the head's columns start at
// head * d_head. Rows [0, rows) are attended; with rows_dev the slot's own
// count min(max(rows_dev[b], 1), rows) is used instead. With `valid`, row r
// of slot b counts when valid[b * valid_stride + r] (row write_row, when
// new_valid is given: when new_valid[b]); other rows score -1e30. Scores are scaled, softmaxed as
// exp(s - max) / sum, and the probabilities weight the V rows.
// Dynamic shared memory: attention_smem(d_head, rows).
__global__ void attention_kernel(const float* __restrict__ qpart, int Sq, int Nq,
                                 const float* __restrict__ K, const float* __restrict__ V,
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

  for (int d = tid; d < d_head; d += bd) qs[d] = sum_parts(qpart, Sq, B, Nq, b, off + d);
  __syncthreads();
  for (int r = warp; r < n_rows; r += nw) {
    const float* kr = K + (size_t)r * row_stride + off;
    float dot = 0.f;
    for (int d = lane; d < d_head; d += 32) dot = fmaf(qs[d], kr[d], dot);
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
  for (int r = tid; r < n_rows; r += bd) sc[r] = sc[r] / s;
  __syncthreads();

  float* ob = out + (size_t)b * Nq + off;
  if (d_head <= bd) {
    const int G = bd / d_head;
    const int d = tid % d_head, gg = tid / d_head;
    float a = 0.f;
    if (gg < G) {
      for (int r = gg; r < n_rows; r += G) a = fmaf(sc[r], V[(size_t)r * row_stride + off + d], a);
    }
    acc[tid] = a;
    __syncthreads();
    if (tid < d_head) {
      float o = 0.f;
      for (int k = 0; k < G; ++k) o += acc[k * d_head + tid];
      ob[tid] = o;
    }
  } else {
    for (int d = tid; d < d_head; d += bd) {
      float a = 0.f;
      for (int r = 0; r < n_rows; ++r) a = fmaf(sc[r], V[(size_t)r * row_stride + off + d], a);
      ob[d] = a;
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
// embedding sum. With x (the fused frame), the last phase seeds the decoder,
// x[b] = sum / n_cb + posemb[b], h[b] = LayerNorm(x[b]) with layer 0's norm;
// with new_valid it decides the new row's validity: may_continue[b] && no
// sampled or argmax code of the frame is EOS. The split path's LT sampler
// passes neither and stops at the codes.
__global__ void __launch_bounds__(kSampleThreads)
lt_sample_kernel(const float* __restrict__ part, int S, int V, const float* __restrict__ bias,
                 int cb, int ncb, const unsigned char* __restrict__ forbid_eos, int forbid_eos1,
                 int bos_id, int eos_id, const int* __restrict__ seeds, int seed1,
                 float temperature, int top_k, const float* __restrict__ emb_table, int D,
                 int* __restrict__ codes, int* __restrict__ amax_out, float* __restrict__ emb_row,
                 float* __restrict__ emb_acc, const float* __restrict__ posemb,
                 int posemb_stride, const unsigned char* __restrict__ may_continue,
                 int* __restrict__ new_valid, float* __restrict__ x,
                 const float* __restrict__ ln_w, float eps, float* __restrict__ h) {
  __shared__ float lg[kMaxVocab];
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int b = blockIdx.x, B = gridDim.x;
  const int forbid = forbid_eos ? forbid_eos[b] : forbid_eos1;
  const uint32_t seed = (uint32_t)(seeds ? seeds[b] : seed1);

  for (int v = tid; v < V; v += bd) {
    const float l = sum_parts(part, S, B, V, b, v) + bias[v];
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
  const float* er = emb_table + (size_t)code * D;
  float* rb = emb_row + (size_t)b * D;
  float* ab = emb_acc + (size_t)b * D;
  for (int n = tid; n < D; n += bd) {
    const float e = er[n];
    rb[n] = e;
    const float s = cb == 0 ? e : ab[n] + e;
    ab[n] = s;
    if (to_decoder) {
      x[(size_t)b * D + n] = s / (float)ncb + posemb[(size_t)b * posemb_stride + n];
    }
  }
  if (to_decoder) block_layer_norm(x + (size_t)b * D, ln_w, h + (size_t)b * D, D, eps, redv);
}

}  // namespace
