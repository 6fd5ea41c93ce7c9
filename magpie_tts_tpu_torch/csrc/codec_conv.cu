// Fused HalfSnake -> causal dilated Conv1d (+ bias, + optional residual) for
// the nano-codec, float32, activations [N, T, C] and WIO weights [k, Cin, Cout].
//
// Replaces the TPU kernels magpie_tts_tpu/ops/pallas_kernels/codec_conv.py
// snake_causal_conv and snake_causal_conv_packed. The packed variant exists
// only because channels below 128 waste the TPU's 128-lane vector width; a
// Hopper block tiles any channel count, so one kernel serves every class the
// codec runs (pre-conv 32->864, stages C in {432, 216, 108, 54, 27}, post-conv
// 27->1), unpacked.
//
// The TPU kernel walks time sequentially and carries the activated halo of
// the previous tile in VMEM. Blocks here run in no order, so each block loads
// and activates its own halo: the (k-1)*d rows before its tile are re-read
// and re-activated per block and per output-channel tile.
//
// What bounds it on the card: one decode of F frames does ~2.4 GFLOP per
// frame in these convs (most in the 216- and 108-channel stages), against
// ~2*(Cin+Cout)*4 bytes of activations per time step: compute-bound. This
// simple version is a register-tiled SIMT product (64 time rows x 64 output
// channels per block, 4x4 outputs per thread, 16 input channels per shared
// memory stage) in full float32, so the card's float32 FMA rate, not its
// tensor cores, is the ceiling; weights (up to 11*432*432*4 B = 8.2 MB) are
// streamed in [16 x 64] tiles per tap rather than held whole.
//
// The activation follows the plain half_snake: x + sin(a*x)^2 / a on the first
// n_snake channels (sinf, not a polynomial), LeakyReLU on the rest; causal
// padding is applied after the activation (zeros).

#include "common.cuh"

namespace {

constexpr int kTileT = 64;   // output time rows per block
constexpr int kTileO = 64;   // output channels per block
constexpr int kChunkC = 16;  // input channels per shared-memory stage
constexpr int kThreads = 256;

__device__ __forceinline__ float half_snake(float v, int c, const float* __restrict__ alpha,
                                            int n_snake, float slope) {
  if (c < n_snake) {
    const float a = alpha[c];
    const float s = sinf(a * v);
    return v + (s * s) / a;
  }
  return v >= 0.f ? v : slope * v;
}

__global__ void __launch_bounds__(kThreads)
snake_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ alpha, int n_snake,
                  int apply_act, float slope, const float* __restrict__ res,
                  float* __restrict__ out, int T, int Cin, int Cout, int K, int dil) {
  extern __shared__ float sm[];
  const int halo = (K - 1) * dil;
  const int rows = kTileT + halo;
  float* xs = sm;                  // [rows][kChunkC] activated input window
  float* ws = sm + rows * kChunkC; // [kChunkC][kTileO] weight tile of one tap
  const int t0 = blockIdx.x * kTileT, o0 = blockIdx.y * kTileO;
  const size_t batch = blockIdx.z;
  x += batch * T * Cin;
  out += batch * T * Cout;
  if (res) res += batch * T * Cout;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[j][jj] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kChunkC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * kChunkC; idx += kThreads) {
      const int r = idx / kChunkC, cc = idx % kChunkC;
      const int t = t0 - halo + r, c = c0 + cc;
      float v = 0.f;
      if (t >= 0 && t < T && c < Cin) {
        v = x[(size_t)t * Cin + c];
        if (apply_act) v = half_snake(v, c, alpha, n_snake, slope);
      }
      xs[idx] = v;
    }
    for (int i = 0; i < K; ++i) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kChunkC * kTileO; idx += kThreads) {
        const int cc = idx / kTileO, oo = idx % kTileO;
        const int c = c0 + cc, o = o0 + oo;
        ws[idx] = (c < Cin && o < Cout) ? w[((size_t)i * Cin + c) * Cout + o] : 0.f;
      }
      __syncthreads();
      const float* xt = xs + (i * dil + ty * 4) * kChunkC;
#pragma unroll
      for (int cc = 0; cc < kChunkC; ++cc) {
        float a[4], bw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = xt[j * kChunkC + cc];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bw[jj] = ws[cc * kTileO + tx * 4 + jj];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[j][jj] = fmaf(a[j], bw[jj], acc[j][jj]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = t0 + ty * 4 + j;
    if (t >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = o0 + tx * 4 + jj;
      if (o >= Cout) continue;
      float v = acc[j][jj] + b[o];
      if (res) v += res[(size_t)t * Cout + o];
      out[(size_t)t * Cout + o] = v;
    }
  }
}

}  // namespace

// x [N, T, Cin], w [K, Cin, Cout], b [Cout], alpha [n_snake] (ignored unless
// apply_act), res [N, T, Cout] or null, out [N, T, Cout]. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int magpie_snake_conv_f32(const float* x, const float* w, const float* b,
                                     const float* alpha, int n_snake, int apply_act,
                                     float slope, const float* res, float* out, int N, int T,
                                     int Cin, int Cout, int K, int dil, void* stream) {
  const int rows = kTileT + (K - 1) * dil;
  const size_t smem = (size_t)(rows * kChunkC + kChunkC * kTileO) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTileT - 1) / kTileT, (Cout + kTileO - 1) / kTileO, N);
  snake_conv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, alpha, n_snake, apply_act, slope, res, out, T, Cin, Cout, K, dil);
  return (int)cudaGetLastError();
}

extern "C" const char* magpie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
