// One decode frame of Magpie TTS on Hopper for one stream, float32, and its
// two halves:
// - magpie_frame_step_f32 (kernel A): local-transformer (LT) sampling of the
//   8 codebook codes, the frame embedding, and the 12-layer cached decoder
//   step. Replaces magpie_tts_tpu/ops/pallas_kernels/frame_step.py
//   (frame_step_pallas), dense float32 weight stream.
// - magpie_lt_sample_f32 (kernel 4): the LT sampling alone. Replaces
//   magpie_tts_tpu/ops/pallas_kernels/lt_sampler.py (sample_frame_codes_pallas).
// - magpie_decode_step_f32 (kernel 5): the decoder step alone, from a frame
//   embedding to which it adds pos_emb[pos]. Replaces
//   magpie_tts_tpu/ops/pallas_kernels/decoder_step.py (decode_step_pallas),
//   dense float32 weight stream.
// The split path (--no-fused) runs kernel 4, the embedding in torch, then
// kernel 5; all three run frame_sequence.cuh's launch sequences.
//
// The TPU kernels are sequential grids that carry the LT buffer, the residual
// and the DMA double buffers in VMEM from step to step. Hopper blocks carry
// nothing between launches, so here a frame is a fixed sequence of small
// kernels on one stream and every carried value (LT rows, residual x, K/V
// rows, codes, the embedding sum) lives in a workspace in device memory that
// the wrapper allocates.
//
// What bounds them on the card: the decoder step reads every decoder weight
// once (~349 MB in float32 at 357M width) plus the K/V cache rows <= pos, the
// LT sampler ~20 MB of LT weights and heads; both do ~2 flops per weight read,
// far below the card's compute/byte ratio, so device memory bandwidth is the
// floor (~0.11 ms for the decoder step at pos 300, ~6 us for the sampler) and
// the launches (157 for the decoder step, 104 for the sampler, 260 for a
// fused frame) sit above it: the sampler is latency-bound. The design answers
// the bandwidth side only: every matrix-vector product is a split-K GEMV whose
// grid covers all SMs with 16-byte loads on consecutive columns, and partial
// sums are reduced in a fixed order by the next kernel (no atomics, so the
// bits do not change from run to run). The per-slot kernels (reductions,
// attention, LT sampling) are frame_kernels.cuh's, launched for one slot; the
// GEMV is this file's own. Fewer launches (CUDA graphs, fusion) are later
// work.
//
// Numerics follow the plain versions (frame_step_reference, the LT sampler's
// sample_frame_codes, decode_step): float32 residual carry, exact-erf GELU via
// erff, softmax as exp(s - max) / sum, the Gumbel noise via logf, argmax ties
// to the lowest index, and the exact top-k set by 32-pass integer bisection
// on the monotone key of the float bits.

#include "frame_sequence.cuh"

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

namespace {

// Kernel A's FrameStepArgs as the shared sequence's one-slot FrameSeq: the
// scalar flags, posemb row pos, self-attention over rows [0, pos] with no mask.
FrameSeq seq_of(const FrameStepArgs& a) {
  FrameSeq s{};
  s.B = 1;
  s.D = a.d_model, s.F = a.d_ffn, s.L = a.n_layers, s.NS = a.max_seq, s.E = a.enc_rows;
  s.X = a.d_xa, s.n_heads = a.n_heads, s.xa_heads = a.xa_heads, s.LT = a.lt_dim;
  s.LF = a.lt_ffn, s.ncb = a.n_cb, s.V = a.vocab, s.part_cap = a.part_cap;
  s.hidden = a.hidden;
  s.lt_in_w = a.lt_in_w, s.lt_in_b = a.lt_in_b, s.lt_pos = a.lt_pos;
  s.lt_norm_self = a.lt_norm_self, s.lt_qkv = a.lt_qkv, s.lt_sa_out = a.lt_sa_out;
  s.lt_norm_ff = a.lt_norm_ff, s.lt_ff_proj = a.lt_ff_proj, s.lt_ff_out = a.lt_ff_out;
  s.lt_out_w = a.lt_out_w, s.lt_out_b = a.lt_out_b, s.audio_emb = a.audio_emb;
  s.forbid_eos1 = a.forbid_eos, s.seed1 = a.seed, s.top_k = a.top_k;
  s.bos_id = a.audio_bos_id, s.eos_id = a.audio_eos_id, s.temperature = a.temperature;
  s.sampled = a.sampled, s.argmax = a.argmax;
  s.posemb = a.pos_emb ? a.pos_emb + (size_t)a.pos * a.d_model : nullptr;
  s.norm_self = a.norm_self, s.qkv = a.qkv, s.sa_out = a.sa_out, s.norm_xa_q = a.norm_xa_q;
  s.xa_q = a.xa_q, s.xa_out = a.xa_out, s.norm_ff = a.norm_ff, s.ff_proj = a.ff_proj;
  s.ff_out = a.ff_out, s.norm_out = a.norm_out;
  s.k_cache = a.k_cache, s.v_cache = a.v_cache, s.xa_k = a.xa_k, s.xa_v = a.xa_v;
  s.write_row = a.pos, s.rows = a.pos + 1, s.enc_len = a.enc_len;
  s.hidden_out = a.hidden_out;
  s.part = a.part, s.x = a.x, s.h = a.h, s.q = a.q, s.attn = a.attn, s.f = a.f, s.xa = a.xa;
  s.lt_x = a.lt_x, s.lt_h = a.lt_h, s.lt_q = a.lt_q, s.lt_k = a.lt_k, s.lt_v = a.lt_v;
  s.lt_attn = a.lt_attn, s.lt_f = a.lt_f, s.emb_row = a.emb_row, s.emb_acc = a.emb_acc;
  s.eps = a.eps, s.sa_scale = a.sa_scale, s.xa_scale = a.xa_scale, s.lt_scale = a.lt_scale;
  s.gelu_tanh = a.gelu_tanh;
  return s;
}

struct Gemv {
  int cap;
  int operator()(const float* x, const float* W, float* part, int K, int N,
                 cudaStream_t st) const {
    return launch_gemv(x, W, part, K, N, cap, st);
  }
};

}  // namespace

// Kernel A: one fused frame, LT sampling from `hidden` then the decoder at pos.
extern "C" int magpie_frame_step_f32(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FrameSeq s = seq_of(*a);
  const Gemv mm{a->part_cap};
  int err = lt_phases(s, mm, true, st);
  if (!err) err = decoder_layers(s, mm, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 4 (the split path's LT sampler): the codes of `hidden` only.
extern "C" int magpie_lt_sample_f32(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = lt_phases(seq_of(*a), Gemv{a->part_cap}, false, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 5 (the split path's decoder step): `hidden` holds the frame
// embedding; the decoder runs on hidden + pos_emb[pos] at row pos.
extern "C" int magpie_decode_step_f32(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FrameSeq s = seq_of(*a);
  int err = decoder_input(s, a->hidden, s.posemb, st);
  if (!err) err = decoder_layers(s, Gemv{a->part_cap}, st);
  return err ? err : (int)cudaGetLastError();
}
