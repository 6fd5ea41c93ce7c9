// One decode frame for B slots of Magpie TTS on Hopper, float32: per-slot
// local-transformer (LT) sampling of 8 codebook codes, the frame embedding
// plus each slot's position-embedding row, the new cache row's validity, and
// the 12-layer decoder step over per-slot validity masks with one shared
// cache write row.
//
// Replaces the TPU kernel magpie_tts_tpu/ops/pallas_kernels/
// frame_step_batched.py (frame_step_batched_pallas), dense float32 weight
// stream. The TPU kernel is one sequential grid (8 LT phases + 12 layers)
// that keeps the slots' LT rows, residuals and cache groups in VMEM and
// contracts every weight tile with all B rows on the MXU. Hopper blocks carry
// nothing between launches, so, as in frame_step.cu, the frame is a fixed
// sequence of kernels on one stream with every carried value in a workspace
// the wrapper allocates.
//
// What bounds it on the card: a frame reads ~360 MB of decoder and LT weights
// plus the attended cache rows of B slots (at B=8, ~300 rows: ~177 MB), at
// ~2*B flops per weight byte / 4: still far below the compute/byte ratio, so
// device memory bandwidth is the floor (~0.16 ms at 3.35 TB/s for the
// weights) and the ~260 launches of a frame sit above it. The design's one
// batched property: every weight byte is read from device memory once per
// frame for all B slots. Each GEMM block stages a [32 x 64] weight tile in
// shared memory and multiplies it into the B input rows, also staged there,
// with B accumulators spread over its threads; the split-K partials are
// reduced in a fixed order by the next kernel (no atomics). Per-slot work
// (attention per slot and head, sampling, LayerNorm) runs the kernels of
// frame_kernels.cuh, shared with frame_step.cu, with a slot dimension in the
// grid. wgmma, TMA, fewer launches and CUDA graphs are later work.
//
// Semantics the callers rely on:
// - valid[b, r] (bool, row stride valid_stride, 0 to broadcast one row)
//   marks the existing rows slot b attends to; row write_row is decided here:
//   new_valid[b] = may_continue[b] && no sampled or argmax code is EOS.
// - Self-attention covers rows [0, rows) only: the caller promises that no
//   valid row lies at or past `rows` (lockstep passes pos + 1, the ring cache
//   a bound its host tracks). Masked scores are -1e30, so a slot with no
//   valid row attends uniformly over [0, rows).
// - The new K/V row is written at write_row for every slot, dead ones too.
// - Numerics follow frame_step_batched_reference: float32 residual carry,
//   erff GELU, softmax as exp(s - max) / sum, argmax ties to the lowest
//   index, the exact top-k bisection and the Gumbel draw of frame_step.cu.

#include "frame_kernels.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kTileN = 64;                         // GEMM columns per block
constexpr int kTileK = 32;                         // weight rows per smem stage
constexpr int kGemmThreads = 256;
constexpr int kSlotGroups = kGemmThreads / kTileN;  // threads sharing a column
constexpr int kTargetBlocks = 264;                 // 2 blocks per SM on 132 SMs

// part[(s * B + b) * N + n] = sum over k in split s of X[b, k] * W[k, n].
// W is row-major [K, N] with N % 4 == 0, X is [B, K]. Thread (n, g) owns
// column n of the block's tile and the slots b = g + kSlotGroups * j.
template <int BPT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_splitk_kernel(const float* __restrict__ X, int B, const float* __restrict__ W,
                   float* __restrict__ part, int K, int N, int kchunk) {
  __shared__ __align__(16) float ws[kTileK][kTileN];
  __shared__ float xs[kMaxSlots][kTileK];
  const int tid = threadIdx.x;
  const int nl = tid % kTileN, g = tid / kTileN;
  const int n = blockIdx.x * kTileN + nl;
  const int n4 = N >> 2;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  float acc[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) acc[j] = 0.f;

  for (int kt = k0; kt < k1; kt += kTileK) {
    for (int i = tid; i < kTileK * (kTileN / 4); i += kGemmThreads) {
      const int r = i / (kTileN / 4), c4 = i % (kTileN / 4);
      const int k = kt + r, col4 = blockIdx.x * (kTileN / 4) + c4;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < k1 && col4 < n4) w = __ldg(reinterpret_cast<const float4*>(W) + (size_t)k * n4 + col4);
      reinterpret_cast<float4*>(&ws[r][0])[c4] = w;
    }
    for (int i = tid; i < B * kTileK; i += kGemmThreads) {
      const int b = i / kTileK, r = i % kTileK;
      const int k = kt + r;
      xs[b][r] = k < k1 ? X[(size_t)b * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTileK; ++r) {
      const float w = ws[r][nl];
#pragma unroll
      for (int j = 0; j < BPT; ++j) {
        const int b = g + j * kSlotGroups;
        if (b < B) acc[j] = fmaf(xs[b][r], w, acc[j]);
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = g + j * kSlotGroups;
      if (b < B) part[((size_t)blockIdx.y * B + b) * N + n] = acc[j];
    }
  }
}

// Launches the split-K GEMM of X[B, K] @ W[K, N]; returns the split count S.
int launch_gemm(const float* X, int B, const float* W, float* part, int K, int N, int part_cap,
                cudaStream_t st) {
  const int tiles = (N + kTileN - 1) / kTileN;
  int S = (kTargetBlocks + tiles - 1) / tiles;
  S = max(1, min(S, min(part_cap, (K + kTileK - 1) / kTileK)));
  int kchunk = (K + S - 1) / S;
  kchunk = (kchunk + kTileK - 1) / kTileK * kTileK;
  S = (K + kchunk - 1) / kchunk;
  const dim3 grid(tiles, S);
  const int bpt = (B + kSlotGroups - 1) / kSlotGroups;
  if (bpt <= 1) {
    gemm_splitk_kernel<1><<<grid, kGemmThreads, 0, st>>>(X, B, W, part, K, N, kchunk);
  } else if (bpt <= 2) {
    gemm_splitk_kernel<2><<<grid, kGemmThreads, 0, st>>>(X, B, W, part, K, N, kchunk);
  } else if (bpt <= 4) {
    gemm_splitk_kernel<4><<<grid, kGemmThreads, 0, st>>>(X, B, W, part, K, N, kchunk);
  } else if (bpt <= 8) {
    gemm_splitk_kernel<8><<<grid, kGemmThreads, 0, st>>>(X, B, W, part, K, N, kchunk);
  } else {
    gemm_splitk_kernel<16><<<grid, kGemmThreads, 0, st>>>(X, B, W, part, K, N, kchunk);
  }
  return S;
}

}  // namespace

// Field order and types mirror FrameStepBatchedArgs in
// ops/kernels/frame_step_batched.py.
struct FrameStepBatchedArgs {
  // per-slot state
  const float* hidden;
  const unsigned char* valid;
  const unsigned char* may_continue;
  const float* posemb;
  const unsigned char* forbid_eos;
  const int* seeds;
  const int* enc_lengths;
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
  int* new_valid;
  // dims and scalars
  int batch, d_model, d_ffn, n_layers, max_seq, enc_rows, d_xa, n_heads, xa_heads;
  int lt_dim, lt_ffn, n_cb, vocab, part_cap;
  int write_row, rows, valid_stride, posemb_stride, top_k, audio_bos_id, audio_eos_id;
  int gelu_tanh;
  float temperature, eps, sa_scale, xa_scale, lt_scale;
};

extern "C" int magpie_frame_step_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int B = a->batch;
  const int D = a->d_model, F = a->d_ffn, LT = a->lt_dim, LF = a->lt_ffn, V = a->vocab;
  const int X = a->d_xa, E = a->enc_rows, L = a->n_layers, NS = a->max_seq;
  const int ncb = a->n_cb, cap = a->part_cap;
  const size_t lt_slot = (size_t)ncb * LT;
  int S;

  for (int cb = 0; cb < ncb; ++cb) {
    S = launch_gemm(cb == 0 ? a->hidden : a->emb_row, B, a->lt_in_w, a->part, D, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, LT, a->lt_in_b, a->lt_pos + (size_t)cb * LT,
                                         a->lt_x, 0, a->lt_norm_self, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->lt_h, B, a->lt_qkv, a->part, LT, 3 * LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<dim3((3 * LT + kRt - 1) / kRt, B), kRt, 0, st>>>(
        a->part, S, LT, a->lt_q, a->lt_k + (size_t)cb * LT, a->lt_v + (size_t)cb * LT, lt_slot);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(1, B), kRt, attention_smem(LT, cb + 1), st>>>(
        a->lt_q, 1, LT, a->lt_k, a->lt_v, lt_slot, LT, cb + 1, nullptr, nullptr, 0, 0, nullptr,
        LT, a->lt_scale, a->lt_attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->lt_attn, B, a->lt_sa_out, a->part, LT, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1,
                                         a->lt_norm_ff, a->eps, a->lt_h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->lt_h, B, a->lt_ff_proj, a->part, LT, LF, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<dim3((LF + kRt - 1) / kRt, B), kRt, 0, st>>>(a->part, S, LF, 1,
                                                                   a->gelu_tanh, a->lt_f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->lt_f, B, a->lt_ff_out, a->part, LF, LT, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, LT, nullptr, nullptr, a->lt_x, 1, nullptr,
                                         a->eps, nullptr);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->lt_x, B, a->lt_out_w + (size_t)cb * LT * V, a->part, LT, V, cap, st);
    MAGPIE_CHECK_LAUNCH();
    lt_sample_kernel<<<B, kSampleThreads, 0, st>>>(
        a->part, S, V, a->lt_out_b + (size_t)cb * V, cb, ncb, a->forbid_eos, 0, a->audio_bos_id,
        a->audio_eos_id, a->seeds, 0, a->temperature, a->top_k, a->audio_emb + (size_t)cb * V * D,
        D, a->sampled, a->argmax, a->emb_row, a->emb_acc, a->posemb, a->posemb_stride,
        a->may_continue, a->new_valid, a->x, a->norm_self, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
  }

  const int dh = D / a->n_heads;
  const int dxh = X / a->xa_heads;
  const size_t cache_slot = (size_t)L * NS * D;
  const size_t xa_slot = (size_t)L * E * X;
  for (int l = 0; l < L; ++l) {
    float* kc = a->k_cache + (size_t)l * NS * D;
    float* vc = a->v_cache + (size_t)l * NS * D;
    const float* xk = a->xa_k + (size_t)l * E * X;
    const float* xv = a->xa_v + (size_t)l * E * X;

    S = launch_gemm(a->h, B, a->qkv + (size_t)l * D * 3 * D, a->part, D, 3 * D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    qkv_scatter_kernel<<<dim3((3 * D + kRt - 1) / kRt, B), kRt, 0, st>>>(
        a->part, S, D, a->q, kc + (size_t)a->write_row * D, vc + (size_t)a->write_row * D,
        cache_slot);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(a->n_heads, B), kRt, attention_smem(dh, a->rows), st>>>(
        a->q, 1, D, kc, vc, cache_slot, D, a->rows, nullptr, a->valid, a->valid_stride,
        a->write_row, a->new_valid, dh, a->sa_scale, a->attn);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->attn, B, a->sa_out + (size_t)l * D * D, a->part, D, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         a->norm_xa_q + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->h, B, a->xa_q + (size_t)l * D * X, a->part, D, X, cap, st);
    MAGPIE_CHECK_LAUNCH();
    attention_kernel<<<dim3(a->xa_heads, B), kRt, attention_smem(dxh, E), st>>>(
        a->part, S, X, xk, xv, xa_slot, X, E, a->enc_lengths, nullptr, 0, 0, nullptr, dxh,
        a->xa_scale, a->xa);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->xa, B, a->xa_out + (size_t)l * X * D, a->part, X, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         a->norm_ff + (size_t)l * D, a->eps, a->h);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->h, B, a->ff_proj + (size_t)l * D * F, a->part, D, F, cap, st);
    MAGPIE_CHECK_LAUNCH();
    reduce_act_kernel<<<dim3((F + kRt - 1) / kRt, B), kRt, 0, st>>>(a->part, S, F, 1,
                                                                  a->gelu_tanh, a->f);
    MAGPIE_CHECK_LAUNCH();
    S = launch_gemm(a->f, B, a->ff_out + (size_t)l * F * D, a->part, F, D, cap, st);
    MAGPIE_CHECK_LAUNCH();
    const bool last = l + 1 == L;
    combine_ln_kernel<<<B, kRt, 0, st>>>(a->part, S, D, nullptr, nullptr, a->x, 1,
                                         last ? a->norm_out : a->norm_self + (size_t)(l + 1) * D,
                                         a->eps, last ? a->hidden_out : a->h);
    MAGPIE_CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
