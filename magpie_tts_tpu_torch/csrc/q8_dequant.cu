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
// the kernel writes the transposed layout directly. The product of an
// f16-valued scale and an int8 value is exact in f32, so the result is
// bit-identical to the loader's numpy dequant + transform.
//
// What bounds it on the card: it reads 1 byte + 1/8 of a scale per weight and
// writes 4 bytes, 2 in bf16 (~232 MB read and ~825 MB written, ~413 MB in
// bf16, for the 18 block-stored tensors of a 357M checkpoint, ~0.32 / ~0.19
// ms at 3.35 TB/s); no arithmetic to speak of: the stores are the work.
// The design (one block a 64 x 64 (a, b) tile for all Kk):
// - a tile row's 64 * Kk source bytes are contiguous ([a, b0 .. b0 + 63, 0 ..
//   Kk - 1]), so they are read once, by one block, as 16-byte loads issued
//   together (a 16-byte run lies inside one 32-weight block: one scale a
//   load); a grid over Kk would read each tile Kk times at a stride of Kk
//   bytes (the conv_ffn tensors, Kk = 3, are 37% of the bytes read);
// - each value is dequantized as s * q in float32 and staged in shared
//   memory as [a][b * Kk + kk] (rows padded by one word);
// - the Kk output tiles are written along a, 16 bytes a store (4 float32 or
//   8 bf16 values of consecutive a), several stores in flight a thread.
// Shapes whose rows are not whole 16-byte runs (B * Kk % 16 != 0, or A not a
// multiple of a store's values) take byte loads / one-value stores in the
// same kernel (the VB / VE template arguments); every 357M tensor takes the
// 16-byte forms.

#include "common.cuh"

namespace {

constexpr int kTa = 64;        // a rows of a tile
constexpr int kTb = 64;        // b columns of a tile
constexpr int kThreads = 256;
constexpr int kMaxKk = 8;      // the widest Kk a tile's shared memory takes
constexpr int kLoads = 4;      // 16-byte loads in flight a thread

// Shared memory of a block: the float tile [kTa][kTb * Kk + 1].
__host__ __device__ constexpr int tile_stride(int Kk) { return kTb * Kk + 1; }
__host__ __device__ constexpr size_t tile_bytes(int Kk) {
  return (size_t)kTa * tile_stride(Kk) * sizeof(float);
}

// G slices of [A, B, Kk] (flat index i = (a * B + b) * Kk + kk, block scale
// s[i / 32]) -> out[g, kk, b, a] in O. Grid (ceil(B / 64), ceil(A / 64), G).
// VB: bytes a load (16, or 1 when a row's bytes are not whole 16-byte runs);
// VE: values a store (16 bytes of O, or 1 when A is not a multiple of them).
template <class O, int VB, int VE>
__global__ void __launch_bounds__(kThreads)
q8_dequant_kernel(const signed char* __restrict__ q, const float* __restrict__ s,
                  O* __restrict__ out, int A, int B, int Kk) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const size_t slice = (size_t)A * B * Kk;
  const signed char* qg = q + blockIdx.z * slice;
  const float* sg = s + blockIdx.z * (slice / 32);
  O* og = out + blockIdx.z * slice;
  const int b0 = blockIdx.x * kTb, a0 = blockIdx.y * kTa;
  const int na = min(kTa, A - a0), nb = min(kTb, B - b0);
  const int W = tile_stride(Kk);
  const int row_bytes = nb * Kk;  // a tile row's source bytes

  if constexpr (VB == 16) {
    const int per_row = kTb * Kk / 16;  // 16-byte runs of a full tile row
    const int total = kTa * per_row;
    for (int v0 = tid; v0 < total; v0 += kLoads * kThreads) {
      int4 raw[kLoads];
      float sc[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int v = v0 + u * kThreads;
        const int r = v / per_row, j0 = (v - r * per_row) * 16;
        raw[u] = make_int4(0, 0, 0, 0);
        sc[u] = 0.f;
        if (v < total && r < na && j0 < row_bytes) {
          const size_t i = ((size_t)(a0 + r) * B + b0) * Kk + j0;
          raw[u] = __ldg(reinterpret_cast<const int4*>(qg + i));
          sc[u] = __ldg(sg + (i >> 5));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int v = v0 + u * kThreads;
        const int r = v / per_row, j0 = (v - r * per_row) * 16;
        if (v < total && r < na && j0 < row_bytes) {
          const signed char* b8 = reinterpret_cast<const signed char*>(&raw[u]);
          float* dst = tile + r * W + j0;
#pragma unroll
          for (int e = 0; e < 16; ++e) dst[e] = sc[u] * (float)b8[e];
        }
      }
    }
  } else {
    const int per_row = kTb * Kk;
    for (int e = tid; e < kTa * per_row; e += kThreads) {
      const int r = e / per_row, j = e - r * per_row;
      if (r < na && j < row_bytes) {
        const size_t i = ((size_t)(a0 + r) * B + b0) * Kk + j;
        tile[r * W + j] = __ldg(sg + (i >> 5)) * (float)__ldg(qg + i);
      }
    }
  }
  __syncthreads();

  // out[kk, b0 + bb, a0 + a .. + VE - 1] = tile[a ..][bb * Kk + kk]
  constexpr int kRuns = kTa / VE;  // stores along a of one output row
  const int total = Kk * kTb * kRuns;
  for (int u = tid; u < total; u += kThreads) {
    const int run = u % kRuns, rest = u / kRuns;
    const int bb = rest % kTb, kk = rest / kTb;
    const int a = run * VE;
    if (bb >= nb || a >= na) continue;
    const float* src = tile + a * W + bb * Kk + kk;
    O* dst = og + ((size_t)kk * B + b0 + bb) * A + a0 + a;
    if constexpr (VE == 1) {
      *dst = st<O>(*src);
    } else {
      alignas(16) O v[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) v[e] = st<O>(src[e * W]);
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
    }
  }
}

template <class O, int VB, int VE>
cudaError_t launch(const signed char* q, const float* s, O* out, int G, int A, int B, int Kk,
                   cudaStream_t st) {
  static bool opted[64];  // the shared-memory opt-in, per card
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return cudaErrorInvalidDevice;
  const auto kernel = q8_dequant_kernel<O, VB, VE>;
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)tile_bytes(kMaxKk));
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  const dim3 grid((B + kTb - 1) / kTb, (A + kTa - 1) / kTa, G);
  kernel<<<grid, kThreads, tile_bytes(Kk), st>>>(q, s, out, A, B, Kk);
  return cudaGetLastError();
}

template <class O>
int q8_dequant(const signed char* q, const float* s, void* out, int G, int A, int B, int Kk,
               void* stream) {
  if (G < 1 || A < 1 || B < 1 || Kk < 1 || Kk > kMaxKk || ((size_t)A * B * Kk) % 32 ||
      G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kVe = 16 / (int)sizeof(O);
  const bool vb = ((size_t)B * Kk) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool ve = A % kVe == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  O* o = static_cast<O*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vb && ve) {
    err = launch<O, 16, kVe>(q, s, o, G, A, B, Kk, st);
  } else if (vb) {
    err = launch<O, 16, 1>(q, s, o, G, A, B, Kk, st);
  } else if (ve) {
    err = launch<O, 1, kVe>(q, s, o, G, A, B, Kk, st);
  } else {
    err = launch<O, 1, 1>(q, s, o, G, A, B, Kk, st);
  }
  return (int)err;
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
