// One decode frame for B slots of Magpie TTS on Hopper, float32, and its two
// halves:
// - magpie_frame_step_batched_f32 (kernel C): per-slot local-transformer (LT)
//   sampling of 8 codebook codes, the frame embedding plus each slot's
//   position-embedding row, the new cache row's validity, and the 12-layer
//   decoder step over per-slot validity masks with one shared cache write
//   row. Replaces magpie_tts_tpu/ops/pallas_kernels/frame_step_batched.py
//   (frame_step_batched_pallas), dense float32 weight stream.
// - magpie_lt_sample_batched_f32 (kernel 7): the per-slot LT sampling alone.
//   Replaces magpie_tts_tpu/ops/pallas_kernels/lt_sampler_batched.py
//   (sample_frame_codes_batched_pallas).
// - magpie_decode_step_batched_f32 (kernel 8): the decoder step alone, from
//   x_pe (embedding + position embedding) and a mask that already holds the
//   write row. Replaces magpie_tts_tpu/ops/pallas_kernels/
//   decoder_step_batched.py (decode_step_batched_pallas), dense float32.
// All three run frame_sequence.cuh's launch sequences.
//
// The TPU kernels are sequential grids (8 LT phases, 12 layers) that keep
// the slots' LT rows, residuals and cache groups in VMEM and contract every
// weight tile with all B rows on the MXU; the batched LT sampler pre-projects
// the whole audio-embedding table through in_proj once per call. Hopper
// blocks carry nothing between launches, so, as in frame_step.cu, a frame is a
// fixed sequence of kernels on one stream with every carried value in a
// workspace the wrapper allocates, and the LT projects only the B sampled
// rows per phase (the plain version's rounding; the weight is still read
// once for all slots).
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
//   marks the existing rows slot b attends to. Kernel C decides row
//   write_row itself: new_valid[b] = may_continue[b] && no sampled or argmax
//   code is EOS. Kernel 8 reads it from valid like any other row.
// - Self-attention covers rows [0, rows) only: the caller promises that no
//   valid row lies at or past `rows` (lockstep passes pos + 1, the ring cache
//   a bound its host tracks). Masked scores are -1e30, so a slot with no
//   valid row attends uniformly over [0, rows).
// - The new K/V row is written at write_row for every slot, dead ones too.
// - Numerics follow frame_step_batched_reference: float32 residual carry,
//   erff GELU, softmax as exp(s - max) / sum, argmax ties to the lowest
//   index, the exact top-k bisection and the Gumbel draw of frame_step.cu.

#include "frame_sequence.cuh"

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

namespace {

FrameSeq seq_of(const FrameStepBatchedArgs& a) {
  FrameSeq s{};
  s.B = a.batch;
  s.D = a.d_model, s.F = a.d_ffn, s.L = a.n_layers, s.NS = a.max_seq, s.E = a.enc_rows;
  s.X = a.d_xa, s.n_heads = a.n_heads, s.xa_heads = a.xa_heads, s.LT = a.lt_dim;
  s.LF = a.lt_ffn, s.ncb = a.n_cb, s.V = a.vocab, s.part_cap = a.part_cap;
  s.hidden = a.hidden;
  s.lt_in_w = a.lt_in_w, s.lt_in_b = a.lt_in_b, s.lt_pos = a.lt_pos;
  s.lt_norm_self = a.lt_norm_self, s.lt_qkv = a.lt_qkv, s.lt_sa_out = a.lt_sa_out;
  s.lt_norm_ff = a.lt_norm_ff, s.lt_ff_proj = a.lt_ff_proj, s.lt_ff_out = a.lt_ff_out;
  s.lt_out_w = a.lt_out_w, s.lt_out_b = a.lt_out_b, s.audio_emb = a.audio_emb;
  s.forbid_eos = a.forbid_eos, s.seeds = a.seeds, s.top_k = a.top_k;
  s.bos_id = a.audio_bos_id, s.eos_id = a.audio_eos_id, s.temperature = a.temperature;
  s.sampled = a.sampled, s.argmax = a.argmax;
  s.posemb = a.posemb, s.posemb_stride = a.posemb_stride, s.may_continue = a.may_continue;
  s.new_valid = a.new_valid;
  s.norm_self = a.norm_self, s.qkv = a.qkv, s.sa_out = a.sa_out, s.norm_xa_q = a.norm_xa_q;
  s.xa_q = a.xa_q, s.xa_out = a.xa_out, s.norm_ff = a.norm_ff, s.ff_proj = a.ff_proj;
  s.ff_out = a.ff_out, s.norm_out = a.norm_out;
  s.k_cache = a.k_cache, s.v_cache = a.v_cache, s.xa_k = a.xa_k, s.xa_v = a.xa_v;
  s.write_row = a.write_row, s.rows = a.rows, s.valid = a.valid;
  s.valid_stride = a.valid_stride, s.enc_lengths = a.enc_lengths;
  s.hidden_out = a.hidden_out;
  s.part = a.part, s.x = a.x, s.h = a.h, s.q = a.q, s.attn = a.attn, s.f = a.f, s.xa = a.xa;
  s.lt_x = a.lt_x, s.lt_h = a.lt_h, s.lt_q = a.lt_q, s.lt_k = a.lt_k, s.lt_v = a.lt_v;
  s.lt_attn = a.lt_attn, s.lt_f = a.lt_f, s.emb_row = a.emb_row, s.emb_acc = a.emb_acc;
  s.eps = a.eps, s.sa_scale = a.sa_scale, s.xa_scale = a.xa_scale, s.lt_scale = a.lt_scale;
  s.gelu_tanh = a.gelu_tanh;
  return s;
}

struct Gemm {
  int B, cap;
  int operator()(const float* X, const float* W, float* part, int K, int N,
                 cudaStream_t st) const {
    return launch_gemm(X, B, W, part, K, N, cap, st);
  }
};

}  // namespace

// Kernel C: one fused frame for B slots.
extern "C" int magpie_frame_step_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FrameSeq s = seq_of(*a);
  const Gemm mm{a->batch, a->part_cap};
  int err = lt_phases(s, mm, true, st);
  if (!err) err = decoder_layers(s, mm, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 7 (the split path's batched LT sampler): the codes of B slots.
extern "C" int magpie_lt_sample_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = lt_phases(seq_of(*a), Gemm{a->batch, a->part_cap}, false, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 8 (the split path's batched decoder step): `hidden` holds x_pe, the
// frame embeddings with their position embeddings; `valid` already holds
// every slot's write row (new_valid is null).
extern "C" int magpie_decode_step_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FrameSeq s = seq_of(*a);
  s.new_valid = nullptr;  // attention reads row write_row from valid like any row
  int err = decoder_input(s, a->hidden, nullptr, st);
  if (!err) err = decoder_layers(s, Gemm{a->batch, a->part_cap}, st);
  return err ? err : (int)cudaGetLastError();
}
