// Kernel 10: the Q8_0 dequant of a block-stored weight tensor (--serve-q8)
// into the layout the loader produces, in float32 (magpie_q8_dequant_f32) or
// bfloat16 (magpie_q8_dequant_bf16: the exact float32 product rounded to
// nearest even, bit-equal to the float32 dequant cast to bf16). Replaces the TPU's in-kernel
// dequant tile, tests/test_pallas_kernels.py
// (test_q8_in_kernel_dequant_tile_bitexact: repeat(s, 32, in-axis) * q),
// which magpie_tts_tpu/io/magpie_weights.py Q8Blocks.materialize runs once per
// program for every block-stored tensor.
//
// Every loader transform is one permutation: the GGUF tensor [A, B, Kk]
// (out, in, k; Kk = 1 for linear and conv1 weights) becomes [Kk, B, A]
// (_conv_ffn_w's transpose (2, 1, 0); the plain transpose when Kk = 1). So
// the kernel writes the transposed layout directly: a 32 x 32 tile of
// (a, b) is read along b (the stored order), dequantized as s * q, staged in
// shared memory and written along a. The product of an f16-valued scale and
// an int8 value is exact in f32, so the result is bit-identical to the
// loader's numpy dequant + transform.
//
// What bounds it on the card: it reads 1 byte + 1/8 of a scale per weight and
// writes 4 bytes, 2 in bf16 (~232 MB read and ~825 MB written, ~413 MB in
// bf16, for the 18 block-stored tensors of a 357M checkpoint, ~0.32 / ~0.19
// ms at 3.35 TB/s); no arithmetic to
// speak of. The tile transpose keeps both the reads and the writes on
// consecutive addresses.

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // block of 32 x 8 threads, 4 tile rows each

// G slices of [A, B, Kk] (flat index i = (a * B + b) * Kk + kk, block scale
// s[i / 32]) -> out[g, kk, b, a] in O. Grid (B / 32, A / 32, G * Kk).
template <class O>
__global__ void __launch_bounds__(kTile * kTileRows)
q8_dequant_kernel(const signed char* __restrict__ q, const float* __restrict__ s,
                  O* __restrict__ out, int A, int B, int Kk) {
  __shared__ float tile[kTile][kTile + 1];
  const int g = blockIdx.z / Kk, kk = blockIdx.z % Kk;
  const size_t slice = (size_t)A * B * Kk;
  const signed char* qg = q + g * slice;
  const float* sg = s + g * (slice / 32);
  O* og = out + g * slice + (size_t)kk * A * B;
  const int b0 = blockIdx.x * kTile, a0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < kTile; r += kTileRows) {
    const int a = a0 + r, b = b0 + tx;
    if (a < A && b < B) {
      const size_t i = ((size_t)a * B + b) * Kk + kk;
      tile[r][tx] = __ldg(sg + (i >> 5)) * (float)__ldg(qg + i);
    }
  }
  __syncthreads();
  for (int r = ty; r < kTile; r += kTileRows) {
    const int b = b0 + r, a = a0 + tx;
    if (a < A && b < B) og[(size_t)b * A + a] = st<O>(tile[tx][r]);
  }
}

template <class O>
int q8_dequant(const signed char* q, const float* s, void* out, int G, int A, int B, int Kk,
               void* stream) {
  if (G < 1 || A < 1 || B < 1 || Kk < 1 || ((size_t)A * B * Kk) % 32 || G * Kk > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((B + kTile - 1) / kTile, (A + kTile - 1) / kTile, G * Kk);
  q8_dequant_kernel<O><<<grid, dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, static_cast<O*>(out), A, B, Kk);
  return (int)cudaGetLastError();
}

}  // namespace

// q [G, A*B*Kk] int8, s [G, A*B*Kk / 32] f32 -> out [G, Kk, B, A] in float32
// (_f32) or bfloat16 (_bf16).
extern "C" int magpie_q8_dequant_f32(const signed char* q, const float* s, void* out, int G,
                                     int A, int B, int Kk, void* stream) {
  return q8_dequant<float>(q, s, out, G, A, B, Kk, stream);
}
extern "C" int magpie_q8_dequant_bf16(const signed char* q, const float* s, void* out, int G,
                                      int A, int B, int Kk, void* stream) {
  return q8_dequant<__nv_bfloat16>(q, s, out, G, A, B, Kk, stream);
}
