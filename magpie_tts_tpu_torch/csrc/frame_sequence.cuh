// The host launch sequences of a decode frame, shared by every frame entry
// point: lt_phases (the 8 local-transformer phases and their sampling) and
// decoder_layers (the cached decoder step). frame_step_batched.cu runs them
// for B slots through its batched GEMM: a fused frame (kernel C) is
// lt_phases + decoder_layers, the split path's LT sampler (7) lt_phases
// alone, its decoder step (8) decoder_input + decoder_layers, so both entry
// points of the pair launch the same kernels in the same order with the
// same arguments. Kernels A, 4 and 5 (one slot) are frame_persistent.cuh's
// persistent launches. Everything is templated on the compute dtype T of
// the weights, caches and hidden rows (float or __nv_bfloat16); a frame's
// float32 workspace is the same in both.

#pragma once

#include "frame_kernels.cuh"

namespace {

// One of the four decoder matrices a frame streams (qkv, sa_out, ff_proj,
// ff_out), [L, K, N] in the frame's stream mode: dense w (T), or int8 q with
// float32 per-column scales s [L, N] (int8) or block scales s [L, K / 32, N]
// (Q8_0).
template <class T>
struct StreamW {
  const T* w;
  const signed char* q;
  const float* s;
  int mode;

  // Layer l's [K, N] matrix.
  __host__ __device__ WeightRef<T> layer(int l, int K, int N) const {
    const size_t kn = (size_t)K * N;
    if (mode == kStreamDense) return WeightRef<T>{w + l * kn, nullptr, nullptr, mode};
    const size_t sl = mode == kStreamInt8 ? (size_t)N : (size_t)(K / 32) * N;
    return WeightRef<T>{nullptr, q + l * kn, s + l * sl, mode};
  }
  // The reducer's column scale of layer l (int8 only).
  __host__ __device__ const float* col_scale(int l, int N) const {
    return mode == kStreamInt8 ? s + (size_t)l * N : nullptr;
  }
};

// Everything one frame's sequence reads and writes, for B slots. A per-slot
// array that is null stands for the scalar beside it (forbid_eos1, seed1,
// enc_len), as kernel A passes them. Weights, caches and hidden rows are T;
// the workspace is float32 but for the LT's K / V rows (T, as the caches).
template <class T>
struct FrameSeq {
  int B, D, F, L, NS, E, X, n_heads, xa_heads, LT, LF, ncb, V;
  // local transformer: input rows hidden [B, D], outputs codes [B, ncb]
  const T* hidden;
  const T *lt_in_w, *lt_in_b, *lt_pos, *lt_norm_self, *lt_qkv, *lt_sa_out, *lt_norm_ff;
  const T *lt_ff_proj, *lt_ff_out, *lt_out_w, *lt_out_b, *audio_emb;
  const unsigned char* forbid_eos;
  int forbid_eos1;
  const int* seeds;
  int seed1, top_k, bos_id, eos_id;
  float temperature;
  int *sampled, *argmax;
  // the fused seam: the last LT phase's decoder input (posemb rows, stride
  // posemb_stride) and, with new_valid, the new row's validity
  const T* posemb;
  int posemb_stride;
  const unsigned char* may_continue;
  int* new_valid;
  // decoder: caches [B, L, NS, D], xa [B, L, E, X]; rows [0, rows) attended
  const T *norm_self, *norm_xa_q, *xa_q, *xa_out, *norm_ff, *norm_out;
  StreamW<T> qkv, sa_out, ff_proj, ff_out;
  T *k_cache, *v_cache;
  const T *xa_k, *xa_v;
  int write_row, rows, valid_stride, enc_len;
  const unsigned char* valid;
  const int* enc_lengths;
  T* hidden_out;
  // workspace
  float *part, *x, *h, *q, *attn, *f, *xa, *lt_x, *lt_h, *lt_q, *lt_attn, *lt_f;
  T *lt_k, *lt_v;
  float *emb_row, *emb_acc;
  // the attentions' workspace and their chunks (rows a block attends; the
  // wrapper's plan for self-, cross- and LT attention)
  AttnWork att;
  int sa_chunk, xa_chunk, lt_chunk;
  float eps, sa_scale, xa_scale, lt_scale;
  int gelu_tanh;
};

// S = mm(...) of a sequence: a matrix product's split count, or (<= 0) the
// CUDA error of a plan it refused.
#define MAGPIE_MM(S, call)                                    \
  do {                                                        \
    S = (call);                                               \
    if (S <= 0) return S < 0 ? -S : (int)cudaErrorInvalidValue; \
    MAGPIE_CHECK_LAUNCH();                                    \
  } while (0)

// The 8 LT phases: codes into sampled / argmax. With seed_decoder the last
// phase also writes the decoder's input x = mean code embedding + posemb,
// h = LayerNorm_0(x) and, with new_valid, the new row's validity.
// mm(X, W, part, K, N) launches the [B, K] @ [K, N] split-K product of a
// WeightRef<T> W, X rounded to T as it is read (X is a T row, or a float row
// the JAX source rounds before its product), and returns its split count
// (-error if it refused the product).
template <class T, class Matmul>
int lt_phases(const FrameSeq<T>& s, const Matmul& mm, bool seed_decoder, cudaStream_t st) {
  const int B = s.B, LT = s.LT, LF = s.LF, V = s.V;
  const size_t lt_slot = (size_t)s.ncb * LT;
  int S;
  for (int cb = 0; cb < s.ncb; ++cb) {
    MAGPIE_MM(S, cb == 0 ? mm(s.hidden, dense_ref(s.lt_in_w), s.part, s.D, LT, st)
                         : mm(s.emb_row, dense_ref(s.lt_in_w), s.part, s.D, LT, st));
    combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, LT, nullptr, s.lt_in_b,
                                                   s.lt_pos + (size_t)cb * LT, s.lt_x, 0,
                                                   s.lt_norm_self, s.eps, s.lt_h);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.lt_h, dense_ref(s.lt_qkv), s.part, LT, 3 * LT, st));
    qkv_scatter_kernel<T><<<dim3((3 * LT + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, LT, nullptr, s.lt_q, s.lt_k + (size_t)cb * LT, s.lt_v + (size_t)cb * LT,
        lt_slot);
    MAGPIE_CHECK_LAUNCH();
    const AttnCall<T> lt_att{s.lt_q,   1,       LT,      s.lt_k, s.lt_v,  lt_slot,
                             LT,       cb + 1,  nullptr, nullptr, 0,      0,
                             nullptr,  1,       LT,      s.lt_scale, s.lt_attn};
    if (const int err = attend(lt_att, B, s.lt_chunk, s.att, st)) return err;
    MAGPIE_MM(S, mm(s.lt_attn, dense_ref(s.lt_sa_out), s.part, LT, LT, st));
    combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, LT, nullptr, nullptr, nullptr,
                                                   s.lt_x, 1, s.lt_norm_ff, s.eps, s.lt_h);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.lt_h, dense_ref(s.lt_ff_proj), s.part, LT, LF, st));
    reduce_act_kernel<T><<<dim3((LF + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, LF, nullptr, 1, s.gelu_tanh, s.lt_f);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.lt_f, dense_ref(s.lt_ff_out), s.part, LF, LT, st));
    combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, LT, nullptr, nullptr, nullptr,
                                                   s.lt_x, 1, nullptr, s.eps, nullptr);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.lt_x, dense_ref(s.lt_out_w + (size_t)cb * LT * V), s.part, LT, V, st));
    lt_sample_kernel<T><<<B, kSampleThreads, 0, st>>>(
        s.part, S, V, s.lt_out_b + (size_t)cb * V, cb, s.ncb, s.forbid_eos, s.forbid_eos1,
        s.bos_id, s.eos_id, s.seeds, s.seed1, s.temperature, s.top_k,
        s.audio_emb + (size_t)cb * V * s.D, s.D, s.sampled, s.argmax, s.emb_row, s.emb_acc,
        s.posemb, s.posemb_stride, s.may_continue, seed_decoder ? s.new_valid : nullptr,
        seed_decoder ? s.x : nullptr, s.norm_self, s.eps, s.h);
    MAGPIE_CHECK_LAUNCH();
  }
  return 0;
}

// The batched split path's decoder input: x[b] = x_in[b], h[b] =
// LayerNorm_0(x[b]) (what the fused frame's last LT phase writes).
template <class T>
int decoder_input(const FrameSeq<T>& s, const T* x_in, cudaStream_t st) {
  decoder_input_kernel<T><<<s.B, kRt, 0, st>>>(x_in, s.D, s.x, s.norm_self, s.eps, s.h);
  MAGPIE_CHECK_LAUNCH();
  return 0;
}

// The decoder layers from h = LayerNorm_0(x): the new K/V row lands at
// write_row of every slot before attending; hidden_out = final norm of x.
// qkv / sa_out / ff_proj / ff_out come in the frame's stream mode (their
// int8 column scales go to the reducers); xa_q / xa_out are always dense.
template <class T, class Matmul>
int decoder_layers(const FrameSeq<T>& s, const Matmul& mm, cudaStream_t st) {
  const int B = s.B, D = s.D, F = s.F, X = s.X, E = s.E, NS = s.NS;
  const int dh = D / s.n_heads;
  const int dxh = X / s.xa_heads;
  const size_t cache_slot = (size_t)s.L * NS * D;
  const size_t xa_slot = (size_t)s.L * E * X;
  const int xa_rows = s.enc_lengths ? E : s.enc_len;
  int S;
  for (int l = 0; l < s.L; ++l) {
    T* kc = s.k_cache + (size_t)l * NS * D;
    T* vc = s.v_cache + (size_t)l * NS * D;
    const T* xk = s.xa_k + (size_t)l * E * X;
    const T* xv = s.xa_v + (size_t)l * E * X;

    MAGPIE_MM(S, mm(s.h, s.qkv.layer(l, D, 3 * D), s.part, D, 3 * D, st));
    qkv_scatter_kernel<T><<<dim3((3 * D + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, D, s.qkv.col_scale(l, 3 * D), s.q, kc + (size_t)s.write_row * D,
        vc + (size_t)s.write_row * D, cache_slot);
    MAGPIE_CHECK_LAUNCH();
    const AttnCall<T> sa{s.q,         1,       D,          kc,          vc,
                         cache_slot,  D,       s.rows,     nullptr,     s.valid,
                         s.valid_stride, s.write_row, s.new_valid, s.n_heads, dh,
                         s.sa_scale,  s.attn};
    if (const int err = attend(sa, B, s.sa_chunk, s.att, st)) return err;
    MAGPIE_MM(S, mm(s.attn, s.sa_out.layer(l, D, D), s.part, D, D, st));
    combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, D, s.sa_out.col_scale(l, D),
                                                   nullptr, nullptr, s.x, 1,
                                                   s.norm_xa_q + (size_t)l * D, s.eps, s.h);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.h, dense_ref(s.xa_q + (size_t)l * D * X), s.part, D, X, st));
    const AttnCall<T> xa{s.part,  S,       X,          xk,      xv,      xa_slot,
                         X,       xa_rows, s.enc_lengths, nullptr, 0,    0,
                         nullptr, s.xa_heads, dxh,     s.xa_scale, s.xa};
    if (const int err = attend(xa, B, s.xa_chunk, s.att, st)) return err;
    MAGPIE_MM(S, mm(s.xa, dense_ref(s.xa_out + (size_t)l * X * D), s.part, X, D, st));
    combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, D, nullptr, nullptr, nullptr,
                                                   s.x, 1, s.norm_ff + (size_t)l * D, s.eps,
                                                   s.h);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.h, s.ff_proj.layer(l, D, F), s.part, D, F, st));
    reduce_act_kernel<T><<<dim3((F + kRt - 1) / kRt, B), kRt, 0, st>>>(
        s.part, S, F, s.ff_proj.col_scale(l, F), 1, s.gelu_tanh, s.f);
    MAGPIE_CHECK_LAUNCH();
    MAGPIE_MM(S, mm(s.f, s.ff_out.layer(l, F, D), s.part, F, D, st));
    if (l + 1 == s.L) {
      combine_ln_kernel<T, T><<<B, kRt, 0, st>>>(s.part, S, D, s.ff_out.col_scale(l, D),
                                                 nullptr, nullptr, s.x, 1, s.norm_out, s.eps,
                                                 s.hidden_out);
    } else {
      combine_ln_kernel<T, float><<<B, kRt, 0, st>>>(s.part, S, D, s.ff_out.col_scale(l, D),
                                                     nullptr, nullptr, s.x, 1,
                                                     s.norm_self + (size_t)(l + 1) * D, s.eps,
                                                     s.h);
    }
    MAGPIE_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace
