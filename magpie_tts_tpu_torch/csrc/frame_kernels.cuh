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

constexpr int kRt = 256;  // threads of the reduce kernels

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

// Single-query attention over the rows of a cache, for B slots and `heads`
// heads (one attention is the two launches of attend() below). q is the sum
// of Sq partials [Sq, B, Nq] (Sq = 1: a plain [B, Nq] row), rounded to T.
// K / V (T) of slot b start at b * slot_stride, rows `row_stride` elements
// apart; the head's columns start at head * d_head. Rows [0, rows) are attended; with rows_dev the slot's own
// count min(max(rows_dev[b], 1), rows) is used instead. With `valid`, row r
// of slot b counts when valid[b * valid_stride + r] (row write_row, when
// new_valid is given: when new_valid[b]); other rows score -1e30. Scores are
// scaled, softmaxed as exp(s - max) / sum over all the slot's rows, the
// probabilities rounded to T weight the V rows (float32 sums), and the output
// is rounded to T (it feeds the output projection): the Pallas kernels'
// rounding points (decoder_step_batched.py:201-216, frame_step_batched.py:
// 495-503).
//
// What bounds it: the K and V rows, read once (a frame's self-attention at
// B = 8 and 300 rows reads 14.7 MB in float32), with two flops a byte: bytes.
// So the rows of a (slot, head) are split into chunks of `chunk` rows, a block
// each (grid: chunk, head, slot), which fills the card at B = 1 as at B = 64;
// a chunk's length is the launch plan's (ops/kernels/decode_attention.py
// plan_attention), a function of d_head alone, so a slot's result never
// depends on its neighbours, and a bound `rows` gives the bits of all
// max_seq rows (the masked rows past it add exact zeros in the same order).
// A lane reads 16 bytes of a row (a row is d_head * sizeof(T) / 16 lanes, at
// most a warp), a lane group keeps several rows in flight (RowLanes), and a
// row's dot product ends in a butterfly over its lanes. Because the
// probabilities are rounded to T only after they are normalised over the
// whole row, a one-pass (online) softmax cannot give them; the work is two
// launches:
// 1. attention_scores_kernel: q, then the scaled, masked scores of the
//    chunk's rows into the float32 workspace sc [B, heads, rows];
// 2. attention_pv_kernel: every block of a (slot, head) reduces the same
//    scores in the same order (so all get the same max and sum), writes the
//    chunk's probabilities rnd(exp(s - m) / sum) and its float32 partial of
//    p . V; the last block of the (slot, head) to finish (an integer ticket,
//    set to 0 by launch 1's chunk-0 block, so no reset is left for the host
//    and the launches capture in a CUDA graph) sums the partials in chunk
//    order and writes the output. No float atomics: every sum runs in a fixed
//    order, so a frame gives the same bits on every run.
constexpr int kAttnThreads = 128;   // threads of an attention block
constexpr int kAttnMaxChunk = 64;   // rows of a chunk, at most
constexpr int kAttnMaxDHead = 256;
static_assert(kAttnMaxChunk <= kAttnThreads, "a thread writes one probability");

template <class T>
struct AttnCall {
  const float* qpart;
  int Sq, Nq;
  const T* K;
  const T* V;
  size_t slot_stride;
  int row_stride, rows;
  const int* rows_dev;
  const unsigned char* valid;
  int valid_stride, write_row;
  const int* new_valid;
  int heads, d_head;
  float scale;
  float* out;  // [B, Nq]
};

// The float32 workspace of an attention: scores [B, heads, rows], partial
// outputs [B, heads, chunks, d_head] and one ticket per (slot, head).
struct AttnWork {
  float* sc;
  float* po;
  int* tk;
};

// 16 bytes of T (kept raw in registers until used: 4 registers, not 8
// floats, for bf16), widened to float.
__device__ __forceinline__ void widen(const uint4& u, float (&v)[4], float) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&v)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The lanes of a row: a row is vpr 16-byte vectors, read by lpr = min(32,
// vpr) lanes, `per` (at most kPer) vectors each; kAttnThreads / lpr rows are
// read at once, and a lane group has kUnroll rows in flight (8 vectors a
// lane: more cost float32 its occupancy, fewer cost bf16 its bandwidth).
template <class T>
struct RowLanes {
  static constexpr int kVE = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int kPer = kAttnMaxDHead / kVE / 32;  // float32: 2, bf16: 1
  static constexpr int kUnroll = 8 / kPer;
  int lpr, per, groups, g, l;
  __device__ explicit RowLanes(int d_head) {
    const int vpr = d_head / kVE;
    lpr = vpr < 32 ? vpr : 32;
    per = vpr / lpr;
    groups = kAttnThreads / lpr;
    g = threadIdx.x / lpr;
    l = threadIdx.x - g * lpr;
  }
  __device__ int col(int j) const { return (l + j * lpr) * kVE; }
};

// The 16-byte vectors of rows base + g + u * groups (u < kUnroll, rows < r1)
// a lane reads; zeros past r1.
template <class T, int U = RowLanes<T>::kUnroll, int P = RowLanes<T>::kPer>
__device__ __forceinline__ void load_rows(const T* m, int row_stride, int base, int r1,
                                          const RowLanes<T>& rl, uint4 (&v)[U][P]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = base + rl.g + u * rl.groups;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[u][j] = r < r1 && j < rl.per
                    ? __ldg(reinterpret_cast<const uint4*>(m + (size_t)r * row_stride +
                                                           rl.col(j)))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <class T>
__device__ __forceinline__ int attn_rows(const AttnCall<T>& a, int b) {
  return a.rows_dev ? min(max(a.rows_dev[b], 1), a.rows) : a.rows;
}

template <class T>
__global__ void __launch_bounds__(kAttnThreads)
attention_scores_kernel(const AttnCall<T> a, const AttnWork w, int chunk) {
  __shared__ __align__(16) float qs[kAttnMaxDHead];
  constexpr int VE = RowLanes<T>::kVE;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, B = gridDim.z;
  const int tid = threadIdx.x;
  if (c == 0 && tid == 0) w.tk[b * H + h] = 0;
  const int r0 = c * chunk, r1 = min(attn_rows(a, b), r0 + chunk);
  if (r0 >= r1) return;
  const int off = h * a.d_head;
  const RowLanes<T> rl(a.d_head);
  const T* kb = a.K + b * a.slot_stride + off;
  float* sc = w.sc + ((size_t)b * H + h) * a.rows;
  // The first rows' K loads go out before q is summed: they do not wait on it.
  constexpr int P = RowLanes<T>::kPer, U = RowLanes<T>::kUnroll;
  uint4 kv[U][P];
  load_rows<T>(kb, a.row_stride, r0, r1, rl, kv);
  for (int d = tid; d < a.d_head; d += kAttnThreads) {
    qs[d] = rnd<T>(sum_parts(a.qpart, a.Sq, B, a.Nq, b, off + d));
  }
  __syncthreads();
  for (int base = r0; base < r1; base += rl.groups * U) {
    if (base != r0) load_rows<T>(kb, a.row_stride, base, r1, rl, kv);
    float dot[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dot[u] = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j < rl.per) {
          float k[VE];
          widen(kv[u][j], k, T());
          const float* qv = qs + rl.col(j);
#pragma unroll
          for (int e = 0; e < VE; ++e) dot[u] = fmaf(qv[e], k[e], dot[u]);
        }
      }
      for (int o = rl.lpr >> 1; o > 0; o >>= 1) {
        dot[u] += __shfl_xor_sync(MAGPIE_FULL_MASK, dot[u], o);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + rl.g + u * rl.groups;
      if (rl.l == 0 && r < r1) {
        bool ok = true;
        if (a.valid) {
          ok = a.new_valid && r == a.write_row ? a.new_valid[b] != 0
                                               : a.valid[(size_t)b * a.valid_stride + r] != 0;
        }
        sc[r] = ok ? dot[u] * a.scale : kNegBig;
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kAttnThreads)
attention_pv_kernel(const AttnCall<T> a, const AttnWork w, int chunk, int nch) {
  __shared__ float red[32];
  __shared__ float pr[kAttnMaxChunk];
  __shared__ float grp[kAttnThreads * 8];  // [groups][d_head] group sums
  __shared__ int last;
  constexpr int VE = RowLanes<T>::kVE;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x;
  const int n_rows = attn_rows(a, b);
  const int nc = (n_rows + chunk - 1) / chunk;
  if (c >= nc) return;
  const int r0 = c * chunk, r1 = min(n_rows, r0 + chunk);
  const float* sc = w.sc + ((size_t)b * H + h) * a.rows;
  const int off = h * a.d_head;
  const RowLanes<T> rl(a.d_head);
  const T* vb = a.V + b * a.slot_stride + off;
  // The first rows' V loads and the first kScoreRegs * kAttnThreads scores
  // (thread t: rows t, t + kAttnThreads, ...) go out together; the max and
  // the sum then run on registers, in the same per-thread order as over
  // memory.
  constexpr int P = RowLanes<T>::kPer, U = RowLanes<T>::kUnroll;
  uint4 vv[U][P];
  load_rows<T>(vb, a.row_stride, r0, r1, rl, vv);
  constexpr int kScoreRegs = 8;
  float sv[kScoreRegs];
#pragma unroll
  for (int i = 0; i < kScoreRegs; ++i) {
    const int r = tid + i * kAttnThreads;
    sv[i] = r < n_rows ? sc[r] : -INFINITY;
  }
  const float mine = r0 + tid < r1 ? sc[r0 + tid] : 0.f;
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kScoreRegs; ++i) m = fmaxf(m, sv[i]);
  for (int r = tid + kScoreRegs * kAttnThreads; r < n_rows; r += kAttnThreads) {
    m = fmaxf(m, sc[r]);
  }
  m = block_max(m, red);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kScoreRegs; ++i) {
    if (tid + i * kAttnThreads < n_rows) s += expf(sv[i] - m);
  }
  for (int r = tid + kScoreRegs * kAttnThreads; r < n_rows; r += kAttnThreads) {
    s += expf(sc[r] - m);
  }
  s = block_sum(s, red);
  if (r0 + tid < r1) pr[tid] = rnd<T>(expf(mine - m) / s);
  __syncthreads();

  float acc[P][VE];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[j][e] = 0.f;
  for (int base = r0; base < r1; base += rl.groups * U) {
    if (base != r0) load_rows<T>(vb, a.row_stride, base, r1, rl, vv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + rl.g + u * rl.groups;
      if (r < r1) {
        const float p = pr[r - r0];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float v[VE];
          widen(vv[u][j], v, T());
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[j][e] = fmaf(p, v[e], acc[j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < rl.per) {
#pragma unroll
      for (int e = 0; e < VE; ++e) grp[rl.g * a.d_head + rl.col(j) + e] = acc[j][e];
    }
  }
  __syncthreads();
  float* ob = a.out + (size_t)b * a.Nq + off;
  float* po = w.po + ((size_t)b * H + h) * nch * a.d_head;
  for (int d = tid; d < a.d_head; d += kAttnThreads) {
    float o = 0.f;
    for (int gg = 0; gg < rl.groups; ++gg) o += grp[gg * a.d_head + d];
    if (nc == 1) {
      ob[d] = rnd<T>(o);
    } else {
      po[(size_t)c * a.d_head + d] = o;
    }
  }
  if (nc == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.tk + b * H + h, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int d = tid; d < a.d_head; d += kAttnThreads) {
    float o = 0.f;
    for (int cc = 0; cc < nc; ++cc) o += __ldcg(po + (size_t)cc * a.d_head + d);
    ob[d] = rnd<T>(o);
  }
}

// The two launches of one attention for B slots with chunks of `chunk` rows
// (16 to kAttnMaxChunk, a multiple of 16: the wrapper's plan); refuses a
// plan or a layout the kernels do not take.
template <class T>
int attend(const AttnCall<T>& a, int B, int chunk, const AttnWork& w, cudaStream_t st) {
  constexpr int VE = RowLanes<T>::kVE;
  const int vpr = a.d_head / VE;
  const bool ok = chunk >= 16 && chunk <= kAttnMaxChunk && chunk % 16 == 0 && a.rows >= 1 &&
                  a.d_head % VE == 0 && vpr >= 1 && vpr <= 32 * RowLanes<T>::kPer &&
                  (vpr & (vpr - 1)) == 0 &&
                  a.d_head <= kAttnMaxDHead && a.row_stride % VE == 0 &&
                  a.slot_stride % VE == 0 && reinterpret_cast<uintptr_t>(a.K) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.V) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int nch = (a.rows + chunk - 1) / chunk;
  const dim3 grid(nch, a.heads, B);
  attention_scores_kernel<T><<<grid, kAttnThreads, 0, st>>>(a, w, chunk);
  MAGPIE_CHECK_LAUNCH();
  attention_pv_kernel<T><<<grid, kAttnThreads, 0, st>>>(a, w, chunk, nch);
  MAGPIE_CHECK_LAUNCH();
  return 0;
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
