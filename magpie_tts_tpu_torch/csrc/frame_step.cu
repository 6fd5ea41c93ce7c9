// One decode frame of Magpie TTS on Hopper for one stream, and its two
// halves, each in float32 (_f32) and bfloat16 (_bf16):
// - magpie_frame_step_f32 (kernel A): local-transformer (LT) sampling of the
//   8 codebook codes, the frame embedding, and the 12-layer cached decoder
//   step. Replaces magpie_tts_tpu/ops/pallas_kernels/frame_step.py
//   (frame_step_pallas) with its dense float32, int8-column and Q8_0 weight
//   streams (stream_mode 0 / 1 / 2).
// - magpie_lt_sample_f32 (kernel 4): the LT sampling alone. Replaces
//   magpie_tts_tpu/ops/pallas_kernels/lt_sampler.py (sample_frame_codes_pallas).
// - magpie_decode_step_f32 (kernel 5): the decoder step alone, from a frame
//   embedding to which it adds pos_emb[pos]. Replaces
//   magpie_tts_tpu/ops/pallas_kernels/decoder_step.py (decode_step_pallas),
//   with the same three weight streams.
// The split path (--no-fused) runs kernel 4, the embedding in torch, then
// kernel 5.
//
// Kernels A and 5 are one persistent, cooperative launch a frame
// (frame_persistent.cuh: the design and what bounds it). Kernel 4 is still
// frame_sequence.cuh's launch sequence (lt_phases) through this file's
// split-K GEMV: every matrix-vector product a GEMV whose grid covers all SMs
// with 16-byte loads on consecutive columns, its partial sums reduced in a
// fixed order by the next kernel (no atomics, so the bits do not change from
// run to run); the LT sampler reads ~20 MB of LT weights and heads (~6 us at
// 3.35 TB/s) and its 104 launches sit far above that: it is latency-bound.
//
// Numerics follow the plain versions (frame_step_reference, the LT sampler's
// sample_frame_codes, decode_step): float32 residual carry, exact-erf GELU via
// erff, softmax as exp(s - max) / sum, the Gumbel noise via logf, argmax ties
// to the lowest index, and the exact top-k set by a radix select on the
// monotone key of the float bits. The bfloat16 entry points keep
// weights, caches and hidden rows in bf16 (half the weight bytes) and round
// to bf16 exactly where the Pallas kernels do (frame_kernels.cuh); products
// of bf16 values are exact in float32, so a bf16 frame differs from its
// plain version only by the order of its float32 sums.

#include <algorithm>
#include <mutex>

#include "frame_persistent.cuh"

namespace {

constexpr int kGemvThreads = 256;   // 8 warps; one float4 column per lane
constexpr int kTargetBlocks = 264;  // 2 blocks per SM on a 132-SM card

// part[s, n] = sum over k in split s of rnd<T>(x[k]) * W[k, n]. W is
// row-major [K, N] with N % 4 == 0 in mode MODE (load_w4: four dense T
// weights, or a char4 of int8 values, times their float4 of Q8_0 block
// scales); a lane owns 4 consecutive columns, the 8 warps of a block stride
// over the split's rows, and warp 0 adds the 8 warp sums in order. The split
// count and the fmaf chain do not depend on the mode, so a Q8_0 stream gives
// the same bits as its copy dequantized in T; an int8 stream's column scale
// is applied by the reducer.
template <int MODE, class X, class T>
__global__ void __launch_bounds__(kGemvThreads)
gemv_splitk_kernel(const X* __restrict__ x, const WeightRef<T> W, float* __restrict__ part,
                   int K, int N, int kchunk) {
  __shared__ float4 red[kGemvThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n4 = N >> 2;
  const int c = blockIdx.x * 32 + lane;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < n4) {
#pragma unroll 4
    for (int k = k0 + warp; k < k1; k += kGemvThreads / 32) {
      const float xv = rnd<T>(load_x(x + k));
      const float4 w = load_w4<MODE>(W, (size_t)k, n4, c);
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

// Launches the split-K GEMV of x[K] @ W[K, N]; returns the split count S,
// which depends on K, N and part_cap only (not on W's mode).
template <class X, class T>
int launch_gemv(const X* x, const WeightRef<T>& W, float* part, int K, int N, int part_cap,
                cudaStream_t st) {
  const int tiles = (N / 4 + 31) / 32;
  int S = (kTargetBlocks + tiles - 1) / tiles;
  S = min(S, part_cap);
  S = max(1, min(S, K / (kGemvThreads / 32)));
  const int kchunk = (K + S - 1) / S;
  S = (K + kchunk - 1) / kchunk;
  const dim3 grid(tiles, S);
  if (W.mode == kStreamInt8) {
    gemv_splitk_kernel<kStreamInt8, X, T><<<grid, kGemvThreads, 0, st>>>(x, W, part, K, N,
                                                                        kchunk);
  } else if (W.mode == kStreamQ8) {
    gemv_splitk_kernel<kStreamQ8, X, T><<<grid, kGemvThreads, 0, st>>>(x, W, part, K, N, kchunk);
  } else {
    gemv_splitk_kernel<kStreamDense, X, T><<<grid, kGemvThreads, 0, st>>>(x, W, part, K, N,
                                                                         kchunk);
  }
  return S;
}

}  // namespace

// Field order and types mirror FrameStepArgs in ops/kernels/frame_step.py.
// The void pointers hold the entry point's compute dtype (float for _f32,
// __nv_bfloat16 for _bf16).
struct FrameStepArgs {
  // state
  const void* hidden;
  void* k_cache;
  void* v_cache;
  const void* xa_k;
  const void* xa_v;
  // local transformer
  const void* lt_in_w;
  const void* lt_in_b;
  const void* lt_pos;
  const void* lt_norm_self;
  const void* lt_qkv;
  const void* lt_sa_out;
  const void* lt_norm_ff;
  const void* lt_ff_proj;
  const void* lt_ff_out;
  const void* lt_out_w;
  const void* lt_out_b;
  const void* audio_emb;
  // decoder
  const void* pos_emb;
  const void* norm_self;
  const void* qkv;
  const void* sa_out;
  const void* norm_xa_q;
  const void* xa_q;
  const void* xa_out;
  const void* norm_ff;
  const void* ff_proj;
  const void* ff_out;
  const void* norm_out;
  // quantized stream of qkv / sa_out / ff_proj / ff_out (stream_mode 1:
  // int8 with column scales [L, N]; 2: Q8_0 blocks, scales [L, K / 32, N])
  const signed char* qkv_q;
  const float* qkv_s;
  const signed char* sa_out_q;
  const float* sa_out_s;
  const signed char* ff_proj_q;
  const float* ff_proj_s;
  const signed char* ff_out_q;
  const float* ff_out_s;
  // outputs
  int* sampled;
  int* argmax;
  void* hidden_out;
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
  float* att_sc;
  float* att_po;
  int* att_tk;
  // the persistent kernels (A, 5): the second partial buffer, the grid
  // barrier's arrival count (zeroed by the wrapper) and the optional phase
  // stamps (null: none)
  float* part2;
  unsigned* bar;
  unsigned long long* stamps;
  // dims and scalars
  int d_model, d_ffn, n_layers, max_seq, enc_rows, d_xa, n_heads, xa_heads;
  int lt_dim, lt_ffn, n_cb, vocab, part_cap;
  int pos, enc_len, seed, top_k, forbid_eos, audio_bos_id, audio_eos_id, gelu_tanh;
  int stream_mode, sa_chunk, xa_chunk, lt_chunk;
  // the persistent kernels' plan (ops/kernels/frame_step.py plan_frame):
  // the grid (0: the co-resident maximum), the stamp buffer's phases, the K
  // splits of the narrow products and the tile width
  int grid, stamp_cap, split_lt_in, split_lt_sa, split_lt_ff, split_xa_q, tile_cols;
  float temperature, eps, sa_scale, xa_scale, lt_scale;
};

namespace {

// Kernel A's FrameStepArgs as the shared sequence's one-slot FrameSeq: the
// scalar flags, posemb row pos, self-attention over rows [0, pos] with no mask.
template <class T>
FrameSeq<T> seq_of(const FrameStepArgs& a) {
  const auto c = [](const void* p) { return static_cast<const T*>(p); };
  FrameSeq<T> s{};
  s.B = 1;
  s.D = a.d_model, s.F = a.d_ffn, s.L = a.n_layers, s.NS = a.max_seq, s.E = a.enc_rows;
  s.X = a.d_xa, s.n_heads = a.n_heads, s.xa_heads = a.xa_heads, s.LT = a.lt_dim;
  s.LF = a.lt_ffn, s.ncb = a.n_cb, s.V = a.vocab;
  s.hidden = c(a.hidden);
  s.lt_in_w = c(a.lt_in_w), s.lt_in_b = c(a.lt_in_b), s.lt_pos = c(a.lt_pos);
  s.lt_norm_self = c(a.lt_norm_self), s.lt_qkv = c(a.lt_qkv), s.lt_sa_out = c(a.lt_sa_out);
  s.lt_norm_ff = c(a.lt_norm_ff), s.lt_ff_proj = c(a.lt_ff_proj);
  s.lt_ff_out = c(a.lt_ff_out), s.lt_out_w = c(a.lt_out_w), s.lt_out_b = c(a.lt_out_b);
  s.audio_emb = c(a.audio_emb);
  s.forbid_eos1 = a.forbid_eos, s.seed1 = a.seed, s.top_k = a.top_k;
  s.bos_id = a.audio_bos_id, s.eos_id = a.audio_eos_id, s.temperature = a.temperature;
  s.sampled = a.sampled, s.argmax = a.argmax;
  s.posemb = a.pos_emb ? c(a.pos_emb) + (size_t)a.pos * a.d_model : nullptr;
  s.norm_self = c(a.norm_self), s.norm_xa_q = c(a.norm_xa_q), s.xa_q = c(a.xa_q);
  s.xa_out = c(a.xa_out), s.norm_ff = c(a.norm_ff), s.norm_out = c(a.norm_out);
  s.qkv = StreamW<T>{c(a.qkv), a.qkv_q, a.qkv_s, a.stream_mode};
  s.sa_out = StreamW<T>{c(a.sa_out), a.sa_out_q, a.sa_out_s, a.stream_mode};
  s.ff_proj = StreamW<T>{c(a.ff_proj), a.ff_proj_q, a.ff_proj_s, a.stream_mode};
  s.ff_out = StreamW<T>{c(a.ff_out), a.ff_out_q, a.ff_out_s, a.stream_mode};
  s.k_cache = static_cast<T*>(a.k_cache), s.v_cache = static_cast<T*>(a.v_cache);
  s.xa_k = c(a.xa_k), s.xa_v = c(a.xa_v);
  s.write_row = a.pos, s.rows = a.pos + 1, s.enc_len = a.enc_len;
  s.hidden_out = static_cast<T*>(a.hidden_out);
  s.part = a.part, s.x = a.x, s.h = a.h, s.q = a.q, s.attn = a.attn, s.f = a.f, s.xa = a.xa;
  s.lt_x = a.lt_x, s.lt_h = a.lt_h, s.lt_q = a.lt_q;
  s.lt_k = reinterpret_cast<T*>(a.lt_k), s.lt_v = reinterpret_cast<T*>(a.lt_v);
  s.lt_attn = a.lt_attn, s.lt_f = a.lt_f, s.emb_row = a.emb_row, s.emb_acc = a.emb_acc;
  s.att = AttnWork{a.att_sc, a.att_po, a.att_tk};
  s.sa_chunk = a.sa_chunk, s.xa_chunk = a.xa_chunk, s.lt_chunk = a.lt_chunk;
  s.eps = a.eps, s.sa_scale = a.sa_scale, s.xa_scale = a.xa_scale, s.lt_scale = a.lt_scale;
  s.gelu_tanh = a.gelu_tanh;
  return s;
}

template <class T>
struct Gemv {
  int cap;
  template <class X>
  int operator()(const X* x, const WeightRef<T>& W, float* part, int K, int N,
                 cudaStream_t st) const {
    return launch_gemv(x, W, part, K, N, cap, st);
  }
};

// Blocks of a persistent kernel an SM on the current device, at its shared
// memory (cached per kernel, device and size: the occupancy query runs once).
int blocks_per_sm(const void* kernel, int smem, int* n_sm) {
  struct Entry {
    const void* kernel;
    int device, smem, blocks, sms;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == kernel && cache[i].device == dev && cache[i].smem == smem) {
      *n_sm = cache[i].sms;
      return cache[i].blocks;
    }
  }
  int blocks = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPThreads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  if (used < 64) cache[used++] = Entry{kernel, dev, smem, blocks, sms};
  *n_sm = sms;
  return blocks;
}

// Whether an attention of the frame fits the items (attend's conditions).
template <class T>
bool attn_fits(int d_head, int row_stride, int chunk) {
  constexpr int VE = RowLanes<T>::kVE;
  const int vpr = d_head / VE;
  return chunk >= 16 && chunk <= kAttnMaxChunk && chunk % 16 == 0 && d_head % VE == 0 &&
         vpr >= 1 && vpr <= 32 * RowLanes<T>::kPer && (vpr & (vpr - 1)) == 0 &&
         d_head <= kAttnMaxDHead && row_stride % VE == 0;
}

// Kernels A (kLT) and 5: one cooperative launch of the persistent kernel.
// Refuses a plan it does not take (cudaErrorInvalidValue); a grid that cannot
// be co-resident is refused by the launch itself
// (cudaErrorCooperativeLaunchTooLarge). There is no other path.
template <class T, int MODE, bool kLT>
int launch_persistent(const FrameStepArgs& a, cudaStream_t st) {
  const FrameSeq<T> s = seq_of<T>(a);
  const int kmax = std::max(std::max(std::max(s.D, s.F), std::max(s.LT, s.LF)), s.X);
  const int smem = psmem_layout(kmax, s.D, s.LT, s.V).words * 4;
  const int splits[] = {a.split_lt_in, a.split_lt_sa, a.split_lt_ff, a.split_xa_q};
  bool ok = a.tile_cols == kTileCols && a.bar != nullptr && a.part2 != nullptr &&
            smem <= 227 * 1024 && s.V <= kMaxVocab && std::max(s.D, std::max(s.F, s.LF)) <= 4096 &&
            s.ncb <= s.lt_chunk &&
            s.lt_chunk <= kOneChunkRows && s.xa_chunk <= kOneChunkRows && a.grid >= 0 &&
            attn_fits<T>(s.D / s.n_heads, s.D, s.sa_chunk) &&
            attn_fits<T>(s.X / s.xa_heads, s.X, s.xa_chunk) &&
            attn_fits<T>(s.LT, s.LT, s.lt_chunk) && (a.stamps == nullptr || a.stamp_cap > 0);
  for (const int sp : splits) ok = ok && sp >= 1 && sp <= kMaxSplit;
  if (!ok) return (int)cudaErrorInvalidValue;
  Persist<T> p{s, a.part2, a.bar, a.stamps, a.stamp_cap,
               a.split_lt_in, a.split_lt_sa, a.split_lt_ff, a.split_xa_q};
  const void* kernel = reinterpret_cast<const void*>(&frame_persistent_kernel<T, MODE, kLT>);
  int n_sm = 0;
  const int per_sm = blocks_per_sm(kernel, smem, &n_sm);
  if (per_sm < 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : (int)cudaErrorUnknown;
  }
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.grid > 0 ? a.grid : std::min(per_sm, kBlocksPerSm) * n_sm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kPThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, frame_persistent_kernel<T, MODE, kLT>, p);
  // Reading the last error clears it: a refused launch must not fail the next one.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)last;
}

template <class T, bool kLT>
int persistent(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->stream_mode) {
    case kStreamDense:
      return launch_persistent<T, kStreamDense, kLT>(*a, st);
    case kStreamInt8:
      return launch_persistent<T, kStreamInt8, kLT>(*a, st);
    case kStreamQ8:
      return launch_persistent<T, kStreamQ8, kLT>(*a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 4 (the split path's LT sampler): the codes of `hidden` only.
template <class T>
int lt_sample(const FrameStepArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = lt_phases(seq_of<T>(*a), Gemv<T>{a->part_cap}, false, st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// The barrier probe (barrier_probe_kernel): n grid barriers in one
// cooperative launch of `grid` blocks (0: two an SM) on bar (a zeroed count).
extern "C" int magpie_barrier_probe(unsigned* bar, int n, int grid, void* stream) {
  int n_sm = 0;
  const void* kernel = reinterpret_cast<const void*>(&barrier_probe_kernel);
  if (blocks_per_sm(kernel, 0, &n_sm) < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid > 0 ? grid : 2 * n_sm);
  cfg.blockDim = dim3(kPThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, barrier_probe_kernel, bar, n);
  const cudaError_t last = cudaGetLastError();  // cleared, as in launch_persistent
  return err != cudaSuccess ? (int)err : (int)last;
}

extern "C" int magpie_frame_step_f32(const FrameStepArgs* a, void* stream) {
  return persistent<float, true>(a, stream);
}
extern "C" int magpie_frame_step_bf16(const FrameStepArgs* a, void* stream) {
  return persistent<__nv_bfloat16, true>(a, stream);
}
extern "C" int magpie_lt_sample_f32(const FrameStepArgs* a, void* stream) {
  return lt_sample<float>(a, stream);
}
extern "C" int magpie_lt_sample_bf16(const FrameStepArgs* a, void* stream) {
  return lt_sample<__nv_bfloat16>(a, stream);
}
extern "C" int magpie_decode_step_f32(const FrameStepArgs* a, void* stream) {
  return persistent<float, false>(a, stream);
}
extern "C" int magpie_decode_step_bf16(const FrameStepArgs* a, void* stream) {
  return persistent<__nv_bfloat16, false>(a, stream);
}
