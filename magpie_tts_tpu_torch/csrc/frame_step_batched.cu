// One decode frame for B slots of Magpie TTS on Hopper, and its two halves,
// each in float32 (_f32) and bfloat16 (_bf16):
// - magpie_frame_step_batched_f32 (kernel C): per-slot local-transformer (LT)
//   sampling of 8 codebook codes, the frame embedding plus each slot's
//   position-embedding row, the new cache row's validity, and the 12-layer
//   decoder step over per-slot validity masks with one shared cache write
//   row. Replaces magpie_tts_tpu/ops/pallas_kernels/frame_step_batched.py
//   (frame_step_batched_pallas) with its dense float32, int8-column and Q8_0
//   weight streams (stream_mode 0 / 1 / 2).
// - magpie_lt_sample_batched_f32 (kernel 7): the per-slot LT sampling alone.
//   Replaces magpie_tts_tpu/ops/pallas_kernels/lt_sampler_batched.py
//   (sample_frame_codes_batched_pallas).
// - magpie_decode_step_batched_f32 (kernel 8): the decoder step alone, from
//   x_pe (embedding + position embedding) and a mask that already holds the
//   write row. Replaces magpie_tts_tpu/ops/pallas_kernels/
//   decoder_step_batched.py (decode_step_batched_pallas), with the same
//   three weight streams.
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
// in float32 (half in bf16, a quarter for the int8 / Q8_0 streams) plus the
// attended cache rows of B slots (at B=8, ~300 rows: ~177 MB in float32):
// device memory bandwidth is the floor (~0.16 ms for the weights at 3.35
// TB/s) and the ~300 launches of a frame sit above it. The design's batched
// property: every weight byte is read from device memory once per frame for
// all B slots. A weight of b bytes does 2 * B / b flops a byte, which crosses
// SIMT float32's ridge (67 TFLOP/s over 3.35 TB/s: 20 flops a byte) at
// B >= 10 for int8, 20 for bf16 and 40 for float32 weights; serving runs B =
// 8 to 64. So the products run on the tensor cores (gemm_mma_kernel below):
// - weights are mma's B operand: [32 x 64] stages of a block's split of K
//   reach shared memory through a cp.async ring of kGemmStages (conv_mma.cuh's
//   fill_async), and stay in T; an int8 or Q8_0 stage is copied raw and
//   dequantized in shared memory exactly as load_w4 does, so a Q8_0 stream
//   gives the bits of its copy dequantized at load;
// - X rows (rounded to T) are the A operand, m16 tiles of slots (B <= 64:
//   at most 4), loaded once per block;
// - bf16: mma.sync.m16n8k16 with float32 sums; float32: split TF32, three
//   products on m16n8k8 (conv_mma.cuh); each mma sums from zero and a float
//   add carries it into the total, so no truncating accumulator is chained
//   through K (chained, the codec's kernel 9 lost 2.4 points of
//   within-1-ulp against its plain version on an H100);
// - mma.sync, not wgmma: at M <= 64 slots the product is bound by bytes, and
//   a 64-row wgmma tile would be mostly padding at serving's B = 8;
// - split-K: the split count and each split's rows (the wrapper's plan,
//   ops/kernels/batched_gemm.py plan_gemm, a function of K, N and the
//   partial cap alone) and the K order of the mma steps do not depend on B or
//   on the weight mode, and an mma row depends on its own slot's row alone, so
//   a slot's result does not depend on the others; the partials
//   part[(s * B + b) * N + n] are reduced in a fixed order by the next kernel
//   (no atomics).
// Per-slot work (attention per slot and head in row chunks, sampling,
// LayerNorm) runs the kernels of frame_kernels.cuh, shared with
// frame_step.cu, with a slot dimension in the grid. TMA, fewer launches and
// CUDA graphs are later work.
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
//   index, the exact top-k bisection and the Gumbel draw of frame_step.cu;
//   the bf16 entry points round where the Pallas kernels do
//   (frame_kernels.cuh); float32 products carry split TF32's ~21 bits of
//   each operand (the dropped lo * lo term is 2^-22 of a product).

#include <type_traits>

#include "conv_mma.cuh"
#include "frame_sequence.cuh"

namespace {

using conv_mma::cp_async_commit;
using conv_mma::cp_async_wait;
using conv_mma::fill_async;
using conv_mma::ldsm_x2_trans;
using conv_mma::ldsm_x4;
using conv_mma::mma_bf16_zero;
using conv_mma::mma_tf32;
using conv_mma::ring_stride;
using conv_mma::split_tf32;
using conv_mma::window_stride;

constexpr int kMaxSlots = 64;
constexpr int kGemmThreads = conv_mma::kThreads;  // 8 warps (fill_async's stride)
constexpr int kTileN = 64;                         // columns a block: a warp's n8 tile each
constexpr int kKt = 32;                            // weight rows a ring stage (a Q8_0 block)
constexpr int kGemmStages = 4;                     // ring stages
constexpr int kMaxKChunk = 256;                    // rows of K a block, at most
constexpr int kSw = ring_stride(kTileN);           // a T stage's row stride (72)
static_assert(kGemmThreads == 8 * 32 && kTileN == 8 * 8, "one n8 tile per warp");

// One product's plan: K, N and the rows of K a block takes (a multiple of
// kKt, at most kMaxKChunk); the split count is ceil(K / kchunk).
struct GemmPlan {
  int K, N, kchunk;
};
constexpr int kMaxGemmPlans = 16;

// Shared memory of gemm_mma_kernel: the X tile [16 * mt][window_stride(kchunk)]
// in T, then the dense ring [kGemmStages][kKt][kSw] in T, or the raw int8 ring
// [kGemmStages][kKt][kTileN], its Q8_0 scale rows [kGemmStages][kTileN]
// (float) and one dequantized stage [kKt][kSw] in T. Mirrored by
// ops/kernels/batched_gemm.py gemm_smem.
template <class T>
__host__ __device__ constexpr size_t gemm_x_bytes(int mt, int kchunk) {
  return (size_t)16 * mt * window_stride<T>(kchunk) * sizeof(T);
}
template <class T>
__host__ __device__ constexpr size_t gemm_smem(int mode, int mt, int kchunk) {
  return gemm_x_bytes<T>(mt, kchunk) +
         (mode == kStreamDense
              ? (size_t)kGemmStages * kKt * kSw * sizeof(T)
              : (size_t)kGemmStages * kKt * kTileN + (size_t)kGemmStages * kTileN * 4 +
                    (size_t)kKt * kSw * sizeof(T));
}

// part[(s * B + b) * N + n] = sum over k in split s of rnd<T>(X[b, k]) *
// W[k, n]: block (n tile, split s), warp w the columns n0 + 8w .. + 7 of all
// MT m16 tiles of slots. X is [B, K] float rows, or T rows (x_t); W is [K, N]
// in mode MODE, N a multiple of 16 bytes' elements (the wrapper checks).
template <class T, int MODE, int MT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_mma_kernel(const void* __restrict__ X, int x_t, int B, const WeightRef<T> W,
                float* __restrict__ part, int K, int N, int kchunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool kDense = MODE == kStreamDense;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sx = window_stride<T>(kchunk);
  T* xs = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring_raw = smem_raw + gemm_x_bytes<T>(MT, kchunk);
  T* ring = reinterpret_cast<T*>(ring_raw);                      // dense stages
  signed char* qring = reinterpret_cast<signed char*>(ring_raw);  // raw int8 stages
  float* sring = reinterpret_cast<float*>(ring_raw + kGemmStages * kKt * kTileN);
  T* wt = reinterpret_cast<T*>(ring_raw + kGemmStages * kKt * kTileN + kGemmStages * kTileN * 4);
  const int n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const int steps = (k1 - k0 + kKt - 1) / kKt;
  const int cols_ok = N - n0;

  // Stage i of the block's rows: kKt rows from k0 + i * kKt (zeros past k1 and N).
  const auto load_stage = [&](int i) {
    const int slot = i % kGemmStages;
    const int kr = k0 + i * kKt;
    const int rows_ok = min(kKt, k1 - kr);
    if constexpr (kDense) {
      fill_async<T, 16>(ring + slot * kKt * kSw, W.w + (size_t)kr * N + n0, kKt, rows_ok,
                        cols_ok, N, kTileN, kSw);
    } else {
      fill_async<signed char, 16>(qring + slot * kKt * kTileN, W.q + (size_t)kr * N + n0, kKt,
                                  rows_ok, cols_ok, N, kTileN, kTileN);
      if constexpr (MODE == kStreamQ8) {
        fill_async<float, 16>(sring + slot * kTileN, W.s + (size_t)(kr / kKt) * N + n0, 1,
                              rows_ok > 0 ? 1 : 0, cols_ok, N, kTileN, kTileN);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kGemmStages - 1; ++i) {
    if (i < steps) load_stage(i);
    cp_async_commit();
  }

  // The X tile, rounded to T: rows b < B of X[b, k0 .. k1), zeros elsewhere,
  // 4 elements a load and 4 loads in flight a thread.
  {
    const int c4s = kchunk / 4;
    const int total = 16 * MT * c4s;
    for (int i0 = tid; i0 < total; i0 += 4 * kGemmThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kGemmThreads;
        const int r = i / c4s, k = k0 + (i - r * c4s) * 4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && r < B && k < k1) {
          const size_t e = (size_t)r * K + k;
          v[u] = x_t ? load_dense4(static_cast<const T*>(X), e >> 2)
                     : load_dense4(static_cast<const float*>(X), e >> 2);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kGemmThreads;
        if (i < total) {
          const int r = i / c4s, c = (i - r * c4s) * 4;
          T* xr = xs + r * sx + c;
          xr[0] = st<T>(v[u].x);
          xr[1] = st<T>(v[u].y);
          xr[2] = st<T>(v[u].z);
          xr[3] = st<T>(v[u].w);
        }
      }
    }
  }

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mt][q] = 0.f;
  const int g = lane >> 2, t = lane & 3;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();  // stage i landed for every thread; step i - 1 is done
    if (i + kGemmStages - 1 < steps) load_stage(i + kGemmStages - 1);
    cp_async_commit();
    const int slot = i % kGemmStages;
    const T* ws = ring + slot * kKt * kSw;
    if constexpr (!kDense) {
      const signed char* qs = qring + slot * kKt * kTileN;
      const float* sc = sring + slot * kTileN;
      for (int e = tid; e < kKt * kTileN; e += kGemmThreads) {
        const int r = e / kTileN, c = e - r * kTileN;
        float v = (float)qs[e];
        if constexpr (MODE == kStreamQ8) v = rnd<T>(sc[c] * v);
        wt[r * kSw + c] = st<T>(v);
      }
      __syncthreads();
      ws = wt;
    }
    const T* xk = xs + i * kKt;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int ks = 0; ks < kKt / 16; ++ks) {
        uint32_t b[2];
        ldsm_x2_trans(b, ws + (ks * 16 + (lane & 15)) * kSw + warp * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, xk + (mt * 16 + (lane & 15)) * sx + ks * 16 + (lane >> 4) * 8);
          float d[4];
          mma_bf16_zero(d, a, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][q] += d[q];
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kKt / 8; ++ks) {
        const float* bp = ws + (ks * 8 + t) * kSw + warp * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(bp[0], bh[0], bl[0]);
        split_tf32(bp[4 * kSw], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t raw[4], ah[4], al[4];
          ldsm_x4(raw, xk + (mt * 16 + (lane & 15)) * sx + ks * 8 + (lane >> 4) * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(raw[q]), ah[q], al[q]);
          float d[4] = {0.f, 0.f, 0.f, 0.f};  // 8 rows' products, from zero
          mma_tf32(d, al, bh);
          mma_tf32(d, ah, bl);
          mma_tf32(d, ah, bh);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][q] += d[q];
        }
      }
    }
  }
  cp_async_wait<0>();

  const int n = n0 + warp * 8 + 2 * t;
  if (n < N) {
    float* pb = part + (size_t)blockIdx.y * B * N + n;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = mt * 16 + g + half * 8;
        if (b < B) {
          *reinterpret_cast<float2*>(pb + (size_t)b * N) =
              make_float2(acc[mt][2 * half], acc[mt][2 * half + 1]);
        }
      }
    }
  }
}

template <class T, int MODE, int MT>
bool gemm_smem_opted[64];  // the kernel's shared-memory opt-in, per card

template <class T, int MODE, int MT>
int launch_gemm_mt(const dim3& grid, size_t smem, const void* X, int x_t, int B,
                   const WeightRef<T>& W, float* part, int K, int N, int kchunk,
                   cudaStream_t st) {
  const auto kernel = gemm_mma_kernel<T, MODE, MT>;
  const cudaError_t err = conv_mma::opt_in_smem(kernel, gemm_smem_opted<T, MODE, MT>);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kGemmThreads, smem, st>>>(X, x_t, B, W, part, K, N, kchunk);
  return 0;
}

template <class T, int MODE>
int launch_gemm_mode(const dim3& grid, size_t smem, int mt, const void* X, int x_t, int B,
                     const WeightRef<T>& W, float* part, int K, int N, int kchunk,
                     cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_gemm_mt<T, MODE, 1>(grid, smem, X, x_t, B, W, part, K, N, kchunk, st);
    case 2:
      return launch_gemm_mt<T, MODE, 2>(grid, smem, X, x_t, B, W, part, K, N, kchunk, st);
    case 3:
      return launch_gemm_mt<T, MODE, 3>(grid, smem, X, x_t, B, W, part, K, N, kchunk, st);
    default:
      return launch_gemm_mt<T, MODE, 4>(grid, smem, X, x_t, B, W, part, K, N, kchunk, st);
  }
}

// Launches the split-K product X[B, K] @ W[K, N] with `kchunk` rows of K a
// block; returns the split count S = ceil(K / kchunk), or -error when it
// refuses the plan or the layout (the wrapper checks both first).
template <class T>
int launch_gemm(const void* X, int x_t, int B, const WeightRef<T>& W, float* part, int K,
                int N, int kchunk, cudaStream_t st) {
  const int elt = W.mode == kStreamDense ? (int)sizeof(T) : 1;
  const void* base = W.mode == kStreamDense ? static_cast<const void*>(W.w)
                                            : static_cast<const void*>(W.q);
  const bool ok = B >= 1 && B <= kMaxSlots && K >= 1 && N >= 8 && kchunk >= kKt &&
                  kchunk <= kMaxKChunk && kchunk % kKt == 0 && K % 4 == 0 &&
                  ((size_t)N * elt) % 16 == 0 && N % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                  (W.mode != kStreamQ8 ||
                   (K % kKt == 0 && reinterpret_cast<uintptr_t>(W.s) % 16 == 0));
  if (!ok) return -(int)cudaErrorInvalidValue;
  const int S = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + kTileN - 1) / kTileN, S);
  const int mt = (B + 15) / 16;
  const size_t smem = gemm_smem<T>(W.mode, mt, kchunk);
  int err;
  if (W.mode == kStreamInt8) {
    err = launch_gemm_mode<T, kStreamInt8>(grid, smem, mt, X, x_t, B, W, part, K, N, kchunk, st);
  } else if (W.mode == kStreamQ8) {
    err = launch_gemm_mode<T, kStreamQ8>(grid, smem, mt, X, x_t, B, W, part, K, N, kchunk, st);
  } else {
    err = launch_gemm_mode<T, kStreamDense>(grid, smem, mt, X, x_t, B, W, part, K, N, kchunk,
                                            st);
  }
  return err ? -err : S;
}

}  // namespace

// Field order and types mirror FrameStepBatchedArgs in
// ops/kernels/frame_step_batched.py. The void pointers hold the entry
// point's compute dtype (float for _f32, __nv_bfloat16 for _bf16).
struct FrameStepBatchedArgs {
  // per-slot state
  const void* hidden;
  const unsigned char* valid;
  const unsigned char* may_continue;
  const void* posemb;
  const unsigned char* forbid_eos;
  const int* seeds;
  const int* enc_lengths;
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
  int* new_valid;
  float* att_sc;
  float* att_po;
  int* att_tk;
  // dims and scalars
  int batch, d_model, d_ffn, n_layers, max_seq, enc_rows, d_xa, n_heads, xa_heads;
  int lt_dim, lt_ffn, n_cb, vocab;
  int write_row, rows, valid_stride, posemb_stride, top_k, audio_bos_id, audio_eos_id;
  int gelu_tanh, stream_mode, sa_chunk, xa_chunk, lt_chunk, n_gemm_plans;
  float temperature, eps, sa_scale, xa_scale, lt_scale;
  // the GEMM plan of every (K, N) product of the sequence
  GemmPlan gemm_plans[kMaxGemmPlans];
};

namespace {

template <class T>
FrameSeq<T> seq_of(const FrameStepBatchedArgs& a) {
  const auto c = [](const void* p) { return static_cast<const T*>(p); };
  FrameSeq<T> s{};
  s.B = a.batch;
  s.D = a.d_model, s.F = a.d_ffn, s.L = a.n_layers, s.NS = a.max_seq, s.E = a.enc_rows;
  s.X = a.d_xa, s.n_heads = a.n_heads, s.xa_heads = a.xa_heads, s.LT = a.lt_dim;
  s.LF = a.lt_ffn, s.ncb = a.n_cb, s.V = a.vocab;
  s.hidden = c(a.hidden);
  s.lt_in_w = c(a.lt_in_w), s.lt_in_b = c(a.lt_in_b), s.lt_pos = c(a.lt_pos);
  s.lt_norm_self = c(a.lt_norm_self), s.lt_qkv = c(a.lt_qkv), s.lt_sa_out = c(a.lt_sa_out);
  s.lt_norm_ff = c(a.lt_norm_ff), s.lt_ff_proj = c(a.lt_ff_proj);
  s.lt_ff_out = c(a.lt_ff_out), s.lt_out_w = c(a.lt_out_w), s.lt_out_b = c(a.lt_out_b);
  s.audio_emb = c(a.audio_emb);
  s.forbid_eos = a.forbid_eos, s.seeds = a.seeds, s.top_k = a.top_k;
  s.bos_id = a.audio_bos_id, s.eos_id = a.audio_eos_id, s.temperature = a.temperature;
  s.sampled = a.sampled, s.argmax = a.argmax;
  s.posemb = c(a.posemb), s.posemb_stride = a.posemb_stride;
  s.may_continue = a.may_continue, s.new_valid = a.new_valid;
  s.norm_self = c(a.norm_self), s.norm_xa_q = c(a.norm_xa_q), s.xa_q = c(a.xa_q);
  s.xa_out = c(a.xa_out), s.norm_ff = c(a.norm_ff), s.norm_out = c(a.norm_out);
  s.qkv = StreamW<T>{c(a.qkv), a.qkv_q, a.qkv_s, a.stream_mode};
  s.sa_out = StreamW<T>{c(a.sa_out), a.sa_out_q, a.sa_out_s, a.stream_mode};
  s.ff_proj = StreamW<T>{c(a.ff_proj), a.ff_proj_q, a.ff_proj_s, a.stream_mode};
  s.ff_out = StreamW<T>{c(a.ff_out), a.ff_out_q, a.ff_out_s, a.stream_mode};
  s.k_cache = static_cast<T*>(a.k_cache), s.v_cache = static_cast<T*>(a.v_cache);
  s.xa_k = c(a.xa_k), s.xa_v = c(a.xa_v);
  s.write_row = a.write_row, s.rows = a.rows, s.valid = a.valid;
  s.valid_stride = a.valid_stride, s.enc_lengths = a.enc_lengths;
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

// The sequences' matrix product: the tensor-core GEMM with the wrapper's
// plan for (K, N); a product without a plan is refused.
template <class T>
struct Gemm {
  int B;
  const GemmPlan* plans;
  int n_plans;
  template <class XT>
  int operator()(const XT* X, const WeightRef<T>& W, float* part, int K, int N,
                 cudaStream_t st) const {
    constexpr int x_t = std::is_same<XT, T>::value && !std::is_same<T, float>::value;
    for (int i = 0; i < n_plans && i < kMaxGemmPlans; ++i) {
      if (plans[i].K == K && plans[i].N == N) {
        return launch_gemm<T>(X, x_t, B, W, part, K, N, plans[i].kchunk, st);
      }
    }
    return -(int)cudaErrorInvalidValue;
  }
};

template <class T>
Gemm<T> gemm_of(const FrameStepBatchedArgs& a) {
  return Gemm<T>{a.batch, a.gemm_plans, a.n_gemm_plans};
}

// Kernel C: one fused frame for B slots.
template <class T>
int frame_step_batched(const FrameStepBatchedArgs* a, void* stream) {
  if (a->stream_mode < kStreamDense || a->stream_mode > kStreamQ8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FrameSeq<T> s = seq_of<T>(*a);
  const Gemm<T> mm = gemm_of<T>(*a);
  int err = lt_phases(s, mm, true, st);
  if (!err) err = decoder_layers(s, mm, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 7 (the split path's batched LT sampler): the codes of B slots.
template <class T>
int lt_sample_batched(const FrameStepBatchedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = lt_phases(seq_of<T>(*a), gemm_of<T>(*a), false, st);
  return err ? err : (int)cudaGetLastError();
}

// Kernel 8 (the split path's batched decoder step): `hidden` holds x_pe, the
// frame embeddings with their position embeddings; `valid` already holds
// every slot's write row (new_valid is null).
template <class T>
int decode_step_batched(const FrameStepBatchedArgs* a, void* stream) {
  if (a->stream_mode < kStreamDense || a->stream_mode > kStreamQ8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FrameSeq<T> s = seq_of<T>(*a);
  s.new_valid = nullptr;  // attention reads row write_row from valid like any row
  int err = decoder_input(s, s.hidden, st);
  if (!err) err = decoder_layers(s, gemm_of<T>(*a), st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// The two families alone, for their tests and timings: one attention
// (attend) and one product (launch_gemm), with the arguments the sequences
// pass. Field order and types mirror AttentionArgs / GemmArgs in
// ops/kernels/decode_attention.py and ops/kernels/batched_gemm.py.
struct AttentionArgs {
  const float* q;
  const void* k;
  const void* v;
  const int* rows_dev;
  const unsigned char* valid;
  const int* new_valid;
  float* out;
  float* sc;
  float* po;
  int* tk;
  long long slot_stride;
  int sq, nq, row_stride, rows, valid_stride, write_row, heads, d_head, batch, chunk;
  float scale;
};

struct GemmArgs {
  const void* x;
  const void* w;
  const signed char* q;
  const float* s;
  float* part;
  int x_t, batch, k, n, kchunk, mode;
};

namespace {

template <class T>
int attention_entry(const AttentionArgs* a, void* stream) {
  if (a->batch < 1 || a->batch > kMaxSlots) return (int)cudaErrorInvalidValue;
  const AttnCall<T> call{a->q,        a->sq,      a->nq,
                         static_cast<const T*>(a->k), static_cast<const T*>(a->v),
                         (size_t)a->slot_stride, a->row_stride, a->rows, a->rows_dev,
                         a->valid,    a->valid_stride, a->write_row, a->new_valid,
                         a->heads,    a->d_head,  a->scale,   a->out};
  const int err = attend(call, a->batch, a->chunk, AttnWork{a->sc, a->po, a->tk},
                         static_cast<cudaStream_t>(stream));
  return err ? err : (int)cudaGetLastError();
}

template <class T>
int gemm_entry(const GemmArgs* a, void* stream) {
  if (a->mode < kStreamDense || a->mode > kStreamQ8) return (int)cudaErrorInvalidValue;
  const WeightRef<T> W{static_cast<const T*>(a->w), a->q, a->s, a->mode};
  const int S = launch_gemm<T>(a->x, a->x_t, a->batch, W, a->part, a->k, a->n, a->kchunk,
                               static_cast<cudaStream_t>(stream));
  return S < 0 ? -S : (int)cudaGetLastError();
}

}  // namespace

extern "C" int magpie_decode_attention_f32(const AttentionArgs* a, void* stream) {
  return attention_entry<float>(a, stream);
}
extern "C" int magpie_decode_attention_bf16(const AttentionArgs* a, void* stream) {
  return attention_entry<__nv_bfloat16>(a, stream);
}
extern "C" int magpie_batched_gemm_f32(const GemmArgs* a, void* stream) {
  return gemm_entry<float>(a, stream);
}
extern "C" int magpie_batched_gemm_bf16(const GemmArgs* a, void* stream) {
  return gemm_entry<__nv_bfloat16>(a, stream);
}

extern "C" int magpie_frame_step_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  return frame_step_batched<float>(a, stream);
}
extern "C" int magpie_frame_step_batched_bf16(const FrameStepBatchedArgs* a, void* stream) {
  return frame_step_batched<__nv_bfloat16>(a, stream);
}
extern "C" int magpie_lt_sample_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  return lt_sample_batched<float>(a, stream);
}
extern "C" int magpie_lt_sample_batched_bf16(const FrameStepBatchedArgs* a, void* stream) {
  return lt_sample_batched<__nv_bfloat16>(a, stream);
}
extern "C" int magpie_decode_step_batched_f32(const FrameStepBatchedArgs* a, void* stream) {
  return decode_step_batched<float>(a, stream);
}
extern "C" int magpie_decode_step_batched_bf16(const FrameStepBatchedArgs* a, void* stream) {
  return decode_step_batched<__nv_bfloat16>(a, stream);
}
