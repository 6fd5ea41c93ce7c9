// The host launch sequences of a decode frame, shared by every frame entry
// point: lt_phases (the 8 local-transformer phases and their sampling) and
// decoder_layers (the cached decoder step). frame_step.cu runs them for one
// slot through its split-K GEMV, frame_step_batched.cu for B slots through its
// batched GEMM. A fused frame is lt_phases + decoder_layers; the split path's
// LT sampler runs lt_phases alone, its decoder step decoder_input +
// decoder_layers. Both entry points of a pair therefore launch the same
// kernels in the same order with the same arguments.

#pragma once

#include "frame_kernels.cuh"

namespace {

// Everything one frame's sequence reads and writes, for B slots. A per-slot
// array that is null stands for the scalar beside it (forbid_eos1, seed1,
// enc_len), as kernel A passes them.
struct FrameSeq {
  int B, D, F, L, NS, E, X, n_heads, xa_heads, LT, LF, ncb, V, part_cap;
  // local transformer: input rows hidden [B, D], outputs codes [B, ncb]
  const float* hidden;
  const float *lt_in_w, *lt_in_b, *lt_pos, *lt_norm_self, *lt_qkv, *lt_sa_out, *lt_norm_ff;
  const float *lt_ff_proj, *lt_ff_out, *lt_out_w, *lt_out_b, *audio_emb;
  const unsigned char* forbid_eos;
  int forbid_eos1;
  const int* seeds;
  int seed1, top_k, bos_id, eos_id;
  float temperature;
  int *sampled, *argmax;
  // the fused seam: the last LT phase's decoder input (posemb rows, stride
  // posemb_stride) and, with new_valid, the new row's validity
  const float* posemb;
  int posemb_stride;
  const unsigned char* may_continue;
  int* new_valid;
  // decoder: caches [B, L, NS, D], xa [B, L, E, X]; rows [0, rows) attended
  const float *norm_self, *qkv, *sa_out, *norm_xa_q, *xa_q, *xa_out, *norm_ff, *ff_proj;
  const float *ff_out, *norm_out;
  float *k_cache, *v_cache;
  const float *xa_k, *xa_v;
  int write_row, rows, valid_stride, enc_len;
  const unsigned char* valid;
  const int* enc_lengths;
  float* hidden_out;
  // workspace
  float *part, *x, *h, *q, *attn, *f, *xa, *lt_x, *lt_h, *lt_q, *lt_k, *lt_v, *lt_attn, *lt_f;
  float *emb_row, *emb_acc;
  float eps, sa_scale, xa_scale, lt_scale;
  int gelu_tanh;
};

// The 8 LT phases: codes into sampled / argmax. With seed_decoder the last
// phase also writes the decoder's input x = mean code embedding + posemb,
// h = LayerNorm_0(x) and, with new_valid, the new row's validity.
// mm(X, W, part, K, N) launches the [B, K] @ [K, N] split-K product and
// returns its split count.
template <class Matmul>
int lt_phases(const FrameSeq& s, const Matmul& mm, bool seed_decoder, cudaStream_t st) {
  const int B = s.B, LT = s.LT, LF = s.LF, V = s.V;
  const size_t lt_slot = (size_t)s.ncb * LT;
  int S;
  for (int cb = 0; cb < s.ncb; ++cb) {
    S = mm(cb == 0 ? s.hidden : s.emb_row, s.lt_in_w, s.part, s.D, LT, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, LT, s.lt_in_b, s.lt_pos + (size_t)cb * LT,
                                         s.lt_x, 0, s.lt_norm_self, s.eps, s.lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.lt_h, s.lt_qkv, s.part, LT, 3 * LT, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<dim3((3 * LT + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, LT, s.lt_q, s.lt_k + (size_t)cb * LT, s.lt_v + (size_t)cb * LT, lt_slot);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(1, B), kRt, attention_smem(LT, cb + 1), st>>>(
        s.lt_q, 1, LT, s.lt_k, s.lt_v, lt_slot, LT, cb + 1, nullptr, nullptr, 0, 0, nullptr, LT,
        s.lt_scale, s.lt_attn);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.lt_attn, s.lt_sa_out, s.part, LT, LT, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, LT, nullptr, nullptr, s.lt_x, 1,
                                         s.lt_norm_ff, s.eps, s.lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.lt_h, s.lt_ff_proj, s.part, LT, LF, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<dim3((LF + kRt - 1) / kRt, B), kRt, 0, st>>>(s.part, S, LF, 1,
                                                                   s.gelu_tanh, s.lt_f);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.lt_f, s.lt_ff_out, s.part, LF, LT, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, LT, nullptr, nullptr, s.lt_x, 1, nullptr,
                                         s.eps, nullptr);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.lt_x, s.lt_out_w + (size_t)cb * LT * V, s.part, LT, V, st);
    MAGPIE_CHECK_LAUNCH();
    lt_sample_kernel<<<B, kSampleThreads, 0, st>>>(
        s.part, S, V, s.lt_out_b + (size_t)cb * V, cb, s.ncb, s.forbid_eos, s.forbid_eos1,
        s.bos_id, s.eos_id, s.seeds, s.seed1, s.temperature, s.top_k,
        s.audio_emb + (size_t)cb * V * s.D, s.D, s.sampled, s.argmax, s.emb_row, s.emb_acc,
        s.posemb, s.posemb_stride, s.may_continue, seed_decoder ? s.new_valid : nullptr,
        seed_decoder ? s.x : nullptr, s.norm_self, s.eps, s.h);
    MAGPIE_CHECK_LAUNCH();
  }
  return 0;
}

// The split path's decoder input: x[b] = x_in[b] (+ add, one row for all
// slots), h[b] = LayerNorm_0(x[b]) (what the fused frame's last LT phase
// writes).
inline int decoder_input(const FrameSeq& s, const float* x_in, const float* add,
                         cudaStream_t st) {
  combine_ln_kernel<<<s.B, kRt, 0, st>>>(x_in, 1, s.D, nullptr, add, s.x, 0, s.norm_self, s.eps,
                                         s.h);
  MAGPIE_CHECK_LAUNCH();
  return 0;
}

// The decoder layers from h = LayerNorm_0(x): the new K/V row lands at
// write_row of every slot before attending; hidden_out = final norm of x.
template <class Matmul>
int decoder_layers(const FrameSeq& s, const Matmul& mm, cudaStream_t st) {
  const int B = s.B, D = s.D, F = s.F, X = s.X, E = s.E, NS = s.NS;
  const int dh = D / s.n_heads;
  const int dxh = X / s.xa_heads;
  const size_t cache_slot = (size_t)s.L * NS * D;
  const size_t xa_slot = (size_t)s.L * E * X;
  const int xa_rows = s.enc_lengths ? E : s.enc_len;
  int S;
  for (int l = 0; l < s.L; ++l) {
    float* kc = s.k_cache + (size_t)l * NS * D;
    float* vc = s.v_cache + (size_t)l * NS * D;
    const float* xk = s.xa_k + (size_t)l * E * X;
    const float* xv = s.xa_v + (size_t)l * E * X;

    S = mm(s.h, s.qkv + (size_t)l * D * 3 * D, s.part, D, 3 * D, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<dim3((3 * D + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, D, s.q, kc + (size_t)s.write_row * D, vc + (size_t)s.write_row * D,
        cache_slot);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(s.n_heads, B), kRt, attention_smem(dh, s.rows), st>>>(
        s.q, 1, D, kc, vc, cache_slot, D, s.rows, nullptr, s.valid, s.valid_stride, s.write_row,
        s.new_valid, dh, s.sa_scale, s.attn);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.attn, s.sa_out + (size_t)l * D * D, s.part, D, D, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, D, nullptr, nullptr, s.x, 1,
                                         s.norm_xa_q + (size_t)l * D, s.eps, s.h);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.h, s.xa_q + (size_t)l * D * X, s.part, D, X, st);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(s.xa_heads, B), kRt, attention_smem(dxh, xa_rows), st>>>(
        s.part, S, X, xk, xv, xa_slot, X, xa_rows, s.enc_lengths, nullptr, 0, 0, nullptr, dxh,
        s.xa_scale, s.xa);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.xa, s.xa_out + (size_t)l * X * D, s.part, X, D, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, D, nullptr, nullptr, s.x, 1,
                                         s.norm_ff + (size_t)l * D, s.eps, s.h);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.h, s.ff_proj + (size_t)l * D * F, s.part, D, F, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<dim3((F + kRt - 1) / kRt, B), kRt, 0, st>>>(s.part, S, F, 1,
                                                                  s.gelu_tanh, s.f);
    MAGPIE_CHECK_LAUNCH();
    S = mm(s.f, s.ff_out + (size_t)l * F * D, s.part, F, D, st);
    MAGPIE_CHECK_LAUNCH();
    const bool last = l + 1 == s.L;
    combine_ln_kernel<<<B, kRt, 0, st>>>(s.part, S, D, nullptr, nullptr, s.x, 1,
                                         last ? s.norm_out : s.norm_self + (size_t)(l + 1) * D,
                                         s.eps, last ? s.hidden_out : s.h);
    MAGPIE_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace
