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
// change from run to run). The per-slot kernels (reductions, attention, LT
// sampling) are frame_kernels.cuh's, launched for one slot; the GEMV is this
// file's own. Fewer launches (CUDA graphs, fusion) are later work.
//
// Numerics follow the plain version (frame_step_reference): float32 residual
// carry, exact-erf GELU via erff, softmax as exp(s - max) / sum, the
// Gumbel noise via logf, argmax ties to the lowest index, and the exact top-k
// set by 32-pass integer bisection on the monotone key of the float bits.

#include "frame_kernels.cuh"

namespace {

constexpr int kGemvThreads = 256;   // 8 warps; one float4 column per lane
constexpr int kTargetBlocks = 264;  // 2 blocks per SM on a 132-SM card

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
  int S;

  for (int cb = 0; cb < a->n_cb; ++cb) {
    S = launch_gemv(cb == 0 ? a->hidden : a->emb_row, a->lt_in_w, a->part, D, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, LT, a->lt_in_b, a->lt_pos + (size_t)cb * LT,
                                         a->lt_x, 0, a->lt_norm_self, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_h, a->lt_qkv, a->part, LT, 3 * LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<(3 * LT + kRt - 1) / kRt, kRt, 0, st>>>(
        a->part, S, LT, a->lt_q, a->lt_k + (size_t)cb * LT, a->lt_v + (size_t)cb * LT, 0);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<1, kRt, attention_smem(LT, cb + 1), st>>>(
        a->lt_q, 1, LT, a->lt_k, a->lt_v, 0, LT, cb + 1, nullptr, nullptr, 0, 0, nullptr, LT,
        a->lt_scale, a->lt_attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_attn, a->lt_sa_out, a->part, LT, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1,
                                         a->lt_norm_ff, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_h, a->lt_ff_proj, a->part, LT, LF, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<(LF + kRt - 1) / kRt, kRt, 0, st>>>(a->part, S, LF, 1, a->gelu_tanh,
                                                            a->lt_f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_f, a->lt_ff_out, a->part, LF, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1, nullptr,
                                         a->eps, nullptr);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->lt_x, a->lt_out_w + (size_t)cb * LT * V, a->part, LT, V, cap, st);
    MAGPIE_CHECK_LAUNCH();
    lt_sample_kernel<<<1, kSampleThreads, 0, st>>>(
        a->part, S, V, a->lt_out_b + (size_t)cb * V, cb, a->n_cb, nullptr, a->forbid_eos,
        a->audio_bos_id, a->audio_eos_id, nullptr, a->seed, a->temperature, a->top_k,
        a->audio_emb + (size_t)cb * V * D, D, a->sampled, a->argmax, a->emb_row, a->emb_acc,
        a->pos_emb + (size_t)a->pos * D, 0, nullptr, nullptr, a->x, a->norm_self, a->eps, a->h);
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
    qkv_scatter_kernel<<<(3 * D + kRt - 1) / kRt, kRt, 0, st>>>(
        a->part, S, D, a->q, kc + (size_t)a->pos * D, vc + (size_t)a->pos * D, 0);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<a->n_heads, kRt, attention_smem(dh, a->pos + 1), st>>>(
        a->q, 1, D, kc, vc, 0, D, a->pos + 1, nullptr, nullptr, 0, 0, nullptr, dh, a->sa_scale,
        a->attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->attn, a->sa_out + (size_t)l * D * D, a->part, D, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         a->norm_xa_q + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->h, a->xa_q + (size_t)l * D * a->d_xa, a->part, D, a->d_xa, cap, st);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<a->xa_heads, kRt, attention_smem(dxh, a->enc_len), st>>>(
        a->part, S, a->d_xa, xk, xv, 0, a->d_xa, a->enc_len, nullptr, nullptr, 0, 0, nullptr,
        dxh, a->xa_scale, a->xa);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->xa, a->xa_out + (size_t)l * a->d_xa * D, a->part, a->d_xa, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         a->norm_ff + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->h, a->ff_proj + (size_t)l * D * F, a->part, D, F, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<(F + kRt - 1) / kRt, kRt, 0, st>>>(a->part, S, F, 1, a->gelu_tanh,
                                                           a->f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemv(a->f, a->ff_out + (size_t)l * F * D, a->part, F, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    const bool last = l + 1 == a->n_layers;
    combine_ln_kernel<<<1, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         last ? a->norm_out : a->norm_self + (size_t)(l + 1) * D,
                                         a->eps, last ? a->hidden_out : a->h);
    MAGPIE_CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
