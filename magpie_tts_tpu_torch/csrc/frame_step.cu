// One decode frame of Magpie TTS on Hopper, float32: local-transformer (LT)
// sampling of the 8 codebook codes, the frame embedding, and the 12-layer
// cached decoder step.
//
// Replaces the TPU kernel magpie_tts_tpu/ops/pallas_kernels/frame_step.py
// (frame_step_pallas), dense float32 weight stream. The TPU kernel is one
// sequential grid that carries the LT buffer, the residual and the DMA double
// buffers in VMEM from step to step. Hopper blocks carry nothing between
// launches, so here the frame is a fixed sequence of small kernels on one
// stream and every carried value (LT rows, residual x, K/V rows, codes, the
// embedding sum) lives in a workspace in device memory that the wrapper
// allocates.
//
// What bounds it on the card: the frame reads every decoder and LT weight
// once (~400 MB in float32 at 357M width) plus the K/V cache rows <= pos, and
// does ~2 flops per weight read: far below the card's compute/byte ratio, so
// device memory bandwidth is the floor, and at this size the ~260 launches of
// a frame (launch latency) sit above it. The design answers the bandwidth
// side only: every matrix-vector product is a split-K GEMV whose grid covers
// all SMs with 16-byte loads on consecutive columns, and partial sums are
// reduced in a fixed order by the next kernel (no atomics, so the bits do not
// change from run to run). Fewer launches (CUDA graphs, fusion) are later work.
//
// Numerics follow the plain version (frame_step_reference): float32 residual
// carry, exact-erf GELU via erff, softmax as exp(s - max) / sum, the
// Gumbel noise via logf, argmax ties to the lowest index, and the exact top-k
// set by 32-pass integer bisection on the monotone key of the float bits.

#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kGemvThreads = 256;   // 8 warps; one float4 column per lane
constexpr int kTargetBlocks = 264;  // 2 blocks per SM on a 132-SM card
constexpr int kSampleThreads = 1024;
constexpr int kMaxVocab = 4 * kSampleThreads;
constexpr float kNegBig = -1e30f;

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

// part[s, n] = sum over k in split s of x[k] * W[k, n]. W is row-major
// [K, N] with N % 4 == 0; a lane owns 4 consecutive columns, the 8 warps of a
// block stride over the split's rows, and warp 0 adds the 8 warp sums in order.
__global__ void __launch_bounds__(kGemvThreads)
gemv_splitk_kernel(const float* __restrict__ x, const float* __restrict__ W,
                   float* __restrict__ part, int K, int N, int kchunk) {
  __shared__ float4 red[kGemvThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n4 = N >> 2;
  const int c = blockIdx.x * 32 + lane;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < n4) {
    const float4* W4 = reinterpret_cast<const float4*>(W);
#pragma unroll 4
    for (int k = k0 + warp; k < k1; k += kGemvThreads / 32) {
      const float xv = __ldg(x + k);
      const float4 w = __ldg(W4 + (size_t)k * n4 + c);
      acc.x = fmaf(xv, w.x, acc.x);
      acc.y = fmaf(xv, w.y, acc.y);
      acc.z = fmaf(xv, w.z, acc.z);
      acc.w = fmaf(xv, w.w, acc.w);
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < n4) {
    float4 s = red[0][lane];
    for (int w = 1; w < kGemvThreads / 32; ++w) {
      s.x += red[w][lane].x;
      s.y += red[w][lane].y;
      s.z += red[w][lane].z;
      s.w += red[w][lane].w;
    }
    reinterpret_cast<float4*>(part + (size_t)blockIdx.y * N)[c] = s;
  }
}

__device__ __forceinline__ float sum_parts(const float* part, int S, int N, int n) {
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[(size_t)s * N + n];
  return v;
}

// One block. v = sum of the S partials (+ bias); then either the residual
// update x += v (accumulate) or x = v (+ add); then h = LayerNorm(x) * ln_w
// when ln_w is given.
__global__ void combine_ln_kernel(const float* __restrict__ part, int S, int N,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ add, float* x, int accumulate,
                                  const float* __restrict__ ln_w, float eps, float* h) {
  __shared__ float red[32];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float v = sum_parts(part, S, N, n);
    if (bias) v += bias[n];
    if (accumulate) {
      x[n] = x[n] + v;
    } else {
      x[n] = add ? v + add[n] : v;
    }
  }
  if (ln_w) block_layer_norm(x, ln_w, h, N, eps, red);
}

// out[n] = act(sum of partials (+ bias)); act 0 = none, 1 = GELU.
__global__ void reduce_act_kernel(const float* __restrict__ part, int S, int N,
                                  const float* __restrict__ bias, int gelu, int gelu_tanh,
                                  float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float v = sum_parts(part, S, N, n);
  if (bias) v += bias[n];
  out[n] = gelu ? gelu_f(v, gelu_tanh) : v;
}

// Reduces the fused QKV partials [S, 3*D]: q -> q_out, and the new K / V
// rows straight into their cache rows (the row is written before attending).
__global__ void qkv_scatter_kernel(const float* __restrict__ part, int S, int D,
                                   float* __restrict__ q_out, float* __restrict__ k_row,
                                   float* __restrict__ v_row) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 3 * D) return;
  const float v = sum_parts(part, S, 3 * D, n);
  if (n < D) {
    q_out[n] = v;
  } else if (n < 2 * D) {
    k_row[n - D] = v;
  } else {
    v_row[n - 2 * D] = v;
  }
}

// Single-query attention, one block per head, over rows [0, rows) of K / V
// (row stride `row_stride` floats; the head's columns start at h*d_head).
// q is the sum of Sq partials of width Nq. Scores are scaled, softmaxed as
// exp(s - max) / sum, and the probabilities weight the V rows.
// Dynamic shared memory: (d_head + rows + blockDim.x) floats.
__global__ void attention_kernel(const float* __restrict__ qpart, int Sq, int Nq,
                                 const float* __restrict__ K, const float* __restrict__ V,
                                 int row_stride, int rows, int d_head, float scale,
                                 float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* qs = sm;
  float* sc = sm + d_head;
  float* acc = sc + rows;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = bd >> 5;
  const int off = blockIdx.x * d_head;

  for (int d = tid; d < d_head; d += bd) qs[d] = sum_parts(qpart, Sq, Nq, off + d);
  __syncthreads();
  for (int r = warp; r < rows; r += nw) {
    const float* kr = K + (size_t)r * row_stride + off;
    float dot = 0.f;
    for (int d = lane; d < d_head; d += 32) dot = fmaf(qs[d], kr[d], dot);
    dot = warp_sum(dot);
    if (lane == 0) sc[r] = dot * scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int r = tid; r < rows; r += bd) m = fmaxf(m, sc[r]);
  m = block_max(m, red);
  float s = 0.f;
  for (int r = tid; r < rows; r += bd) {
    const float e = expf(sc[r] - m);
    sc[r] = e;
    s += e;
  }
  s = block_sum(s, red);
  for (int r = tid; r < rows; r += bd) sc[r] = sc[r] / s;
  __syncthreads();

  if (d_head <= bd) {
    const int G = bd / d_head;
    const int d = tid % d_head, g = tid / d_head;
    float a = 0.f;
    if (g < G) {
      for (int r = g; r < rows; r += G) a = fmaf(sc[r], V[(size_t)r * row_stride + off + d], a);
    }
    acc[tid] = a;
    __syncthreads();
    if (tid < d_head) {
      float o = 0.f;
      for (int gg = 0; gg < G; ++gg) o += acc[gg * d_head + tid];
      out[off + tid] = o;
    }
  } else {
    for (int d = tid; d < d_head; d += bd) {
      float a = 0.f;
      for (int r = 0; r < rows; ++r) a = fmaf(sc[r], V[(size_t)r * row_stride + off + d], a);
      out[off + d] = a;
    }
  }
}

// One LT phase's sampling, one block of kSampleThreads: logits = partials +
// bias; forbidden specials -> -1e30; argmax; at temperature >= 0.01 the exact
// top-k set and Gumbel-max draw; then the sampled code's embedding row is
// fetched, kept for the next phase's input projection, and added to the
// frame's embedding sum. The last phase seeds the decoder:
// x = sum / n_cb + pos_emb[pos], h = LayerNorm(x) with layer 0's norm.
__global__ void __launch_bounds__(kSampleThreads)
lt_sample_kernel(const float* __restrict__ part, int S, int V, const float* __restrict__ bias,
                 int cb, int ncb, int forbid_eos, int bos_id, int eos_id, int seed,
                 float temperature, int top_k, const float* __restrict__ emb_table, int D,
                 int* __restrict__ codes, int* __restrict__ amax_out, float* __restrict__ emb_row,
                 float* __restrict__ emb_acc, const float* __restrict__ posemb,
                 float* __restrict__ x, const float* __restrict__ ln_w, float eps,
                 float* __restrict__ h) {
  __shared__ float lg[kMaxVocab];
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x, bd = blockDim.x;

  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int v = tid; v < V; v += bd) {
    float l = sum_parts(part, S, V, v) + bias[v];
    const bool forbidden = v == bos_id || (v >= bos_id + 2 && v <= bos_id + 7) ||
                           (forbid_eos && v == eos_id);
    if (forbidden) l = kNegBig;
    lg[v] = l;
    argmax_merge(bv, bi, l, v);
  }
  const int amax = block_argmax(bv, bi, redv, redi);
  int code = amax;

  if (!(temperature < 0.01f)) {
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
    const uint32_t base = (uint32_t)seed + (uint32_t)cb * kPhaseC;
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
    code = block_argmax(bz, bzi, redv, redi);
  }

  if (tid == 0) {
    codes[cb] = code;
    amax_out[cb] = amax;
  }
  const float* er = emb_table + (size_t)code * D;
  const bool last = cb == ncb - 1;
  for (int n = tid; n < D; n += bd) {
    const float e = er[n];
    emb_row[n] = e;
    const float s = cb == 0 ? e : emb_acc[n] + e;
    emb_acc[n] = s;
    if (last) x[n] = s / (float)ncb + posemb[n];
  }
  if (last) block_layer_norm(x, ln_w, h, D, eps, redv);
}

// Launches the split-K GEMV of x[K] @ W[K, N]; returns the split count S.
int launch_gemv(const float* x, const float* W, float* part, int K, int N, int part_cap,
                cudaStream_t st) {
  const int tiles = (N / 4 + 31) / 32;
  int S = (kTargetBlocks + tiles - 1) / tiles;
  S = min(S, part_cap);
  S = max(1, min(S, K / (kGemvThreads / 32)));
  const int kchunk = (K + S - 1) / S;
  S = (K + kchunk - 1) / kchunk;
  gemv_splitk_kernel<<<dim3(tiles, S), kGemvThreads, 0, st>>>(x, W, part, K, N, kchunk);
  return S;
}

int attention_smem(int d_head, int rows, int threads) {
  return (d_head + rows + threads) * (int)sizeof(float);
}

}  // namespace

// Field order and types mirror FrameStepArgs in ops/kernels/frame_step.py.
struct FrameStepArgs {
  // state
  const float* hidden;
  float* k_cache;
  float* v_cache;
  const float* xa_k;
  const float* xa_v;
  // local transformer
  const float* lt_in_w;
  const float* lt_in_b;
  const float* lt_pos;
  const float* lt_norm_self;
  const float* lt_qkv;
  const float* lt_sa_out;
  const float* lt_norm_ff;
  const float* lt_ff_proj;
  const float* lt_ff_out;
  const float* lt_out_w;
  const float* lt_out_b;
  const float* audio_emb;
  // decoder
  const float* pos_emb;
  const float* norm_self;
  const float* qkv;
  const float* sa_out;
  const float* norm_xa_q;
  const float* xa_q;
  const float* xa_out;
  const float* norm_ff;
  const float* ff_proj;
  const float* ff_out;
  const float* norm_out;
  // outputs
  int* sampled;
  int* argmax;
  float* hidden_out;
  // workspace
  float* part;
  float* x;
  float* h;
  float* q;
  float* attn;
  float* f;
  float* xa;
  float* lt_x;
  float* lt_h;
  float* lt_q;
  float* lt_k;
  float* lt_v;
  float* lt_attn;
  float* lt_f;
  float* emb_row;
  float* emb_acc;
  // dims and scalars
  int d_model, d_ffn, n_layers, max_seq, enc_rows, d_xa, n_heads, xa_heads;
  int lt_dim, lt_ffn, n_cb, vocab, part_cap;
  int pos, enc_len, seed, top_k, forbid_eos, audio_bos_id, audio_eos_id, gelu_tanh;
  float temperature, eps, sa_scale, xa_scale, lt_scale;
};

extern "C" int magpie_frame_step_f32(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = a->d_model, F = a->d_ffn, LT = a->lt_dim, LF = a->lt_ffn, V = a->vocab;
  const int cap = a->part_cap;
  const int rt = 256;  // threads of the reduce / attention kernels
  int S;

  for (int cb = 0; cb < a->n_cb; ++cb) {
    S = launch_gemv(cb == 0 ? a->hidden : a->emb_row, a->lt_in_w, a->part, D, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, LT, a->lt_in_b, a->lt_pos + (size_t)cb * LT,
                                        a->lt_x, 0, a->lt_norm_self, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_h, a->lt_qkv, a->part, LT, 3 * LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<(3 * LT + rt - 1) / rt, rt, 0, st>>>(
        a->part, S, LT, a->lt_q, a->lt_k + (size_t)cb * LT, a->lt_v + (size_t)cb * LT);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<1, rt, attention_smem(LT, cb + 1, rt), st>>>(
        a->lt_q, 1, LT, a->lt_k, a->lt_v, LT, cb + 1, LT, a->lt_scale, a->lt_attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_attn, a->lt_sa_out, a->part, LT, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1,
                                        a->lt_norm_ff, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_h, a->lt_ff_proj, a->part, LT, LF, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<(LF + rt - 1) / rt, rt, 0, st>>>(a->part, S, LF, nullptr, 1,
                                                         a->gelu_tanh, a->lt_f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_f, a->lt_ff_out, a->part, LF, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1, nullptr,
                                        a->eps, nullptr);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_x, a->lt_out_w + (size_t)cb * LT * V, a->part, LT, V, cap, st);
    MAGPIE_CHECK_LAUNCH();
    lt_sample_kernel<<<1, kSampleThreads, 0, st>>>(
        a->part, S, V, a->lt_out_b + (size_t)cb * V, cb, a->n_cb, a->forbid_eos,
        a->audio_bos_id, a->audio_eos_id, a->seed, a->temperature, a->top_k,
        a->audio_emb + (size_t)cb * V * D, D, a->sampled, a->argmax, a->emb_row, a->emb_acc,
        a->pos_emb + (size_t)a->pos * D, a->x, a->norm_self, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
  }

  const int dh = D / a->n_heads;
  const int dxh = a->d_xa / a->xa_heads;
  for (int l = 0; l < a->n_layers; ++l) {
    float* kc = a->k_cache + (size_t)l * a->max_seq * D;
    float* vc = a->v_cache + (size_t)l * a->max_seq * D;
    const float* xk = a->xa_k + (size_t)l * a->enc_rows * a->d_xa;
    const float* xv = a->xa_v + (size_t)l * a->enc_rows * a->d_xa;

    S = launch_gemv(a->h, a->qkv + (size_t)l * D * 3 * D, a->part, D, 3 * D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<(3 * D + rt - 1) / rt, rt, 0, st>>>(
        a->part, S, D, a->q, kc + (size_t)a->pos * D, vc + (size_t)a->pos * D);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<a->n_heads, rt, attention_smem(dh, a->pos + 1, rt), st>>>(
        a->q, 1, D, kc, vc, D, a->pos + 1, dh, a->sa_scale, a->attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->attn, a->sa_out + (size_t)l * D * D, a->part, D, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                        a->norm_xa_q + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->h, a->xa_q + (size_t)l * D * a->d_xa, a->part, D, a->d_xa, cap, st);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<a->xa_heads, rt, attention_smem(dxh, a->enc_len, rt), st>>>(
        a->part, S, a->d_xa, xk, xv, a->d_xa, a->enc_len, dxh, a->xa_scale, a->xa);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->xa, a->xa_out + (size_t)l * a->d_xa * D, a->part, a->d_xa, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                        a->norm_ff + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->h, a->ff_proj + (size_t)l * D * F, a->part, D, F, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<(F + rt - 1) / rt, rt, 0, st>>>(a->part, S, F, nullptr, 1,
                                                        a->gelu_tanh, a->f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->f, a->ff_out + (size_t)l * F * D, a->part, F, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    const bool last = l + 1 == a->n_layers;
    combine_ln_kernel<<<1, rt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                        last ? a->norm_out : a->norm_self + (size_t)(l + 1) * D,
                                        a->eps, last ? a->hidden_out : a->h);
    MAGPIE_CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
