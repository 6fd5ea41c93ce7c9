// Fused HalfSnake -> causal dilated Conv1d (+ bias, + optional residual) for
// the nano-codec, activations [N, T, C] and WIO weights [k, Cin, Cout], in
// float32 (magpie_snake_conv_f32) or bfloat16 (magpie_snake_conv_bf16).
//
// Replaces the TPU kernels magpie_tts_tpu/ops/pallas_kernels/codec_conv.py
// snake_causal_conv and snake_causal_conv_packed. The packed variant exists
// only because channels below 128 waste the TPU's 128-lane vector width; a
// Hopper block tiles any channel count, so one kernel serves every class the
// codec runs (pre-conv 32->864, stages C in {432, 216, 108, 54, 27}, post-conv
// 27->1), unpacked.
//
// What bounds it on the card: a 32-frame decode does 78.3 GFLOP in its 92
// convs against a few MB of activations and weights: compute-bound, so the
// products run on the tensor cores (conv_mma.cuh: mma.sync, bf16 operands
// with float32 sums in bf16, split TF32 in float32). Each block computes an
// implicit GEMM, out[t, o] = sum_i sum_c act(x)[t - (k-1-i)*d, c] W[i, c, o],
// for tile_m time rows x tile_n output channels (8 warps: tile_m / 32 over
// the rows, the rest side by side over NT n8 tiles each) of one
// utterance, with K walked chunk by chunk (kc input channels: C_in split
// evenly into chunks of at most 128 in bf16, 64 in float32, a function of
// C_in and the dtype), tap by tap inside a chunk:
// - the window of a chunk (tile_m + halo rows x kc channels) is read (8
//   loads in flight a thread), activated and rounded to the operand type
//   once, into shared memory; every tap and every output channel of the
//   block reuse it (tap i reads it shifted by i * dilation rows);
// - the weights stream through a ring of kStages [kc x tile_n] slices in
//   dynamic shared memory, filled by cp.async kStages - 1 steps ahead and
//   issued behind each step's products, so a slice's load overlaps the
//   products of the slices before it (the bf16 weights of odd width, 27 ->
//   27 and 27 -> 1, have rows that are not 4-byte aligned and are copied
//   with plain loads instead); no conv's weight is held whole;
// - the launch plan (tile_m, tile_n, kc, shared memory bytes) comes from the
//   wrapper (ops/kernels/codec_conv.py plan_conv), which picks the tiles per
//   class from the shapes, T included, so that a conv fills the 132 SMs
//   where T allows; this file checks it.
// What still bounds it: the small-T stages (432 and 216 channels: 256 and
// 2048 rows at 32 frames) have few blocks for a long serial K loop (4752
// channel-taps at k = 11), and each ring step's products wait on shared
// memory (every warp reads its own A fragments) and on the step's barrier.
// A row's value does not depend on the tile, T or N: the K order and kc are
// fixed, there is no split-K and no atomic, so a streamed window's rows
// equal the offline decode's.
//
// The activation follows the plain half_snake (sinf, not a polynomial);
// causal padding is applied after the activation (zeros). In bf16 (the
// Pallas kernel's rounding points, codec_conv.py:125-126 and :149-154) the
// activation is computed in float32 and rounded to bf16 into the window, the
// products sum in float32, + bias and + residual stay float32, and the
// output rounds to bf16 once.

#include <type_traits>

#include "conv_mma.cuh"

namespace {

using namespace conv_mma;

constexpr int kWinBatch = 8;  // window elements a thread loads before activating them

template <class E, int NT>
__global__ void __launch_bounds__(kThreads, 2)
snake_conv_kernel(const E* __restrict__ x, const E* __restrict__ w,
                  const E* __restrict__ b, const E* __restrict__ alpha, int n_snake,
                  int apply_act, float slope, const E* __restrict__ res,
                  E* __restrict__ out, int T, int Cin, int Cout, int K, int dil, int tile_m,
                  int kc, int vec) {
  using Tr = Traits<E>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warps_m = tile_m / kWarpRows, warps_n = kWarps / warps_m;
  const int tile_n = warps_n * NT * 8;
  const int halo = (K - 1) * dil;
  const int rows = tile_m + halo;
  const int sa = window_stride<E>(kc), sw = ring_stride(tile_n);
  E* win = reinterpret_cast<E*>(smem_raw);  // [rows][sa] activated window of one chunk
  E* ring = win + rows * sa;                // [kStages][kc][sw] weight slices
  const int t0 = blockIdx.x * tile_m, o0 = blockIdx.y * tile_n;
  const size_t batch = blockIdx.z;
  x += batch * T * Cin;
  out += batch * T * Cout;
  if (res) res += batch * T * Cout;
  const int cols = min(tile_n, Cout - o0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % warps_m, wn = warp / warps_m;
  const int nchunks = (Cin + kc - 1) / kc, steps = nchunks * K;
  const E* wsrc = w + o0;

  auto fill = [&](int s) {
    if (s < steps) {
      const int chunk = s / K, tap = s - chunk * K, c0 = chunk * kc;
      fill_stage<E>(ring + (s % kStages) * kc * sw, wsrc + ((size_t)tap * Cin + c0) * Cout, kc,
                    min(kc, Cin - c0), cols, Cout, tile_n, sw, vec);
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
  float part[2][NT][4];  // float32: the current ring step's sums
  zero(acc);
  zero(part);
  for (int s = 0; s < kStages - 1; ++s) fill(s);

  for (int s = 0; s < steps; ++s) {
    const int chunk = s / K, tap = s - chunk * K;
    if (tap == 0) {
      __syncthreads();  // every warp is done with the previous chunk's window
      const int c0 = chunk * kc;
      // Window element i = threadIdx.x + n * kThreads is (row r, channel cc),
      // walked without a division per element: kWinBatch loads in flight a
      // thread, then their activations, replaying the same walk.
      const int dr = kThreads / kc, dcc = kThreads - dr * kc;
      int r = threadIdx.x / kc, cc = threadIdx.x - r * kc;
      while (r < rows) {
        const int r_start = r, cc_start = cc;
        float v[kWinBatch];
#pragma unroll
        for (int u = 0; u < kWinBatch; ++u) {
          const int t = t0 - halo + r, c = c0 + cc;
          v[u] = (r < rows && t >= 0 && t < T && c < Cin) ? ld(x[(size_t)t * Cin + c]) : 0.f;
          r += dr;
          cc += dcc;
          if (cc >= kc) {
            cc -= kc;
            ++r;
          }
        }
        int rw = r_start, cw = cc_start;
#pragma unroll
        for (int u = 0; u < kWinBatch; ++u) {
          if (rw < rows) {
            const int c = c0 + cw;
            float a = v[u];
            if (apply_act && c < Cin)
              a = half_snake(a, c, c < n_snake ? ld(alpha[c]) : 1.f, n_snake, slope);
            win[rw * sa + cw] = st<E>(a);
          }
          rw += dr;
          cw += dcc;
          if (cw >= kc) {
            cw -= kc;
            ++rw;
          }
        }
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s and the window are in; slice s - 1's slot is free
    const E* a0 = win + (wm * kWarpRows + (lane & 15) + tap * dil) * sa;
    const E* ws = ring + (s % kStages) * kc * sw + wn * NT * 8;
    StageMma<E, NT>::run(acc, part, a0, a0 + 16 * sa, kc / Tr::kStep, ws, sw);
    if constexpr (std::is_same<E, float>::value) flush(acc, part);
    fill(s + kStages - 1);  // into slice s - 1's slot, behind this slice's products
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * kWarpRows + mt * 16 + g + h * 8;
        if (t >= T) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oo = (wn * NT + j) * 8 + 2 * tq + e;
          if (oo >= cols) continue;
          const int o = o0 + oo;
          float v = acc[mt][j][h * 2 + e] + ld(b[o]);
          if (res) v += ld(res[(size_t)t * Cout + o]);
          out[(size_t)t * Cout + o] = st<E>(v);
        }
      }
}

template <class E>
size_t smem_bytes(int tile_m, int tile_n, int K, int dil, int kc) {
  return sizeof(E) * ((size_t)(tile_m + (K - 1) * dil) * window_stride<E>(kc) +
                      (size_t)kStages * kc * ring_stride(tile_n));
}

template <class E, int NT>
int launch(const void* x, const void* w, const void* b, const void* alpha, int n_snake,
           int apply_act, float slope, const void* res, void* out, int N, int T, int Cin,
           int Cout, int K, int dil, int tile_m, int tile_n, int kc, size_t smem,
           cudaStream_t stream) {
  static bool opted[64] = {};
  const cudaError_t err = opt_in_smem(snake_conv_kernel<E, NT>, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_m - 1) / tile_m, (Cout + tile_n - 1) / tile_n, N);
  snake_conv_kernel<E, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), static_cast<const E*>(b),
      static_cast<const E*>(alpha), n_snake, apply_act, slope, static_cast<const E*>(res),
      static_cast<E*>(out), T, Cin, Cout, K, dil, tile_m, kc, pick_vec<E>(w, Cout, tile_n));
  return (int)cudaGetLastError();
}

template <class E>
int snake_conv(const void* x, const void* w, const void* b, const void* alpha, int n_snake,
               int apply_act, float slope, const void* res, void* out, int N, int T, int Cin,
               int Cout, int K, int dil, int tile_m, int tile_n, int kc, int smem,
               void* stream) {
  // The plan must be one the kernel takes: tile_m a whole number of warps'
  // rows dividing the 8 warps, tile_n the other warps side by side times the
  // n8 tiles a warp holds (bf16 1, 2, 4, 7, 8; float32 1, 2, 4), a chunk of
  // whole mma steps up to kMaxKC channels, and the shared memory the wrapper
  // computed.
  if (tile_m != 32 && tile_m != 64 && tile_m != 128 && tile_m != 256)
    return (int)cudaErrorInvalidValue;
  const int warps_n = kWarps / (tile_m / kWarpRows);
  if (tile_n % (8 * warps_n) || N < 1 || T < 1 || Cin < 1 || Cout < 1 || K < 1 || dil < 1 ||
      kc < Traits<E>::kStep || kc % Traits<E>::kStep || kc > kMaxKC)
    return (int)cudaErrorInvalidValue;
  const size_t need = smem_bytes<E>(tile_m, tile_n, K, dil, kc);
  if ((size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_n / (8 * warps_n)) {
#define MAGPIE_CONV_NT(nt)                                                                   \
  case nt:                                                                                   \
    return launch<E, nt>(x, w, b, alpha, n_snake, apply_act, slope, res, out, N, T, Cin, Cout, \
                         K, dil, tile_m, tile_n, kc, need, st);
    MAGPIE_CONV_NT(1)
    MAGPIE_CONV_NT(2)
    MAGPIE_CONV_NT(4)
#undef MAGPIE_CONV_NT
    case 7:
    case 8:
      if constexpr (std::is_same<E, __nv_bfloat16>::value) {
        if (tile_n / (8 * warps_n) == 7)
          return launch<E, 7>(x, w, b, alpha, n_snake, apply_act, slope, res, out, N, T, Cin,
                              Cout, K, dil, tile_m, tile_n, kc, need, st);
        return launch<E, 8>(x, w, b, alpha, n_snake, apply_act, slope, res, out, N, T, Cin,
                            Cout, K, dil, tile_m, tile_n, kc, need, st);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N, T, Cin], w [K, Cin, Cout], b [Cout], alpha [n_snake] (ignored unless
// apply_act), res [N, T, Cout] or null, out [N, T, Cout], all float32 (_f32)
// or bfloat16 (_bf16); tile_m, tile_n, kc (input channels per chunk) and
// smem: the wrapper's launch plan.
// Returns the CUDA error code of the launch (0 = success); a plan the kernel
// does not take is cudaErrorInvalidValue.
extern "C" int magpie_snake_conv_f32(const void* x, const void* w, const void* b,
                                     const void* alpha, int n_snake, int apply_act,
                                     float slope, const void* res, void* out, int N, int T,
                                     int Cin, int Cout, int K, int dil, int tile_m, int tile_n,
                                     int kc, int smem, void* stream) {
  return snake_conv<float>(x, w, b, alpha, n_snake, apply_act, slope, res, out, N, T, Cin,
                           Cout, K, dil, tile_m, tile_n, kc, smem, stream);
}
extern "C" int magpie_snake_conv_bf16(const void* x, const void* w, const void* b,
                                      const void* alpha, int n_snake, int apply_act,
                                      float slope, const void* res, void* out, int N, int T,
                                      int Cin, int Cout, int K, int dil, int tile_m, int tile_n,
                                      int kc, int smem, void* stream) {
  return snake_conv<__nv_bfloat16>(x, w, b, alpha, n_snake, apply_act, slope, res, out, N, T,
                                   Cin, Cout, K, dil, tile_m, tile_n, kc, smem, stream);
}

extern "C" const char* magpie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
