// Kernels 11-13: the H100 counterparts of the TPU's low-bit GEMV probes,
// scripts/probe_int4.py probe_native_int4 (weights held as native int4),
// probe_packed_int8 (two int4 nibbles packed per int8 byte, unpacked by
// shift / mask / (n ^ 8) - 8) and probe_bf16 (the bf16-weight baseline): the
// product x [8, K] (bf16) @ W [K, N], every weight widened to float in the
// kernel, summed in float32, out [8, N] float32.
//
// Weight layouts (what each entry point reads):
//   native_int4 [K, N / 2] bytes: element order, as a jnp.int4 array holds
//     it; byte [k, j] has column 2j in its low nibble, 2j + 1 in its high;
//   packed_int8 [K / 2, N] int8: the probe's own packing; byte [r, c] has
//     w[r, c] & 15 low and w[r + K / 2, c] & 15 high;
//   bf16 [K, N].
//
// What bounds it on the card: bytes. At the probe's shapes (K 768, N 3072)
// the weight is 1.18 MB (int4 forms) or 4.72 MB (bf16): 0.39 / 1.44 us at
// 3.35 TB/s, a few launches' worth; 37.7 MFLOP is nothing. The design reads
// each weight byte once with coalesced loads and keeps the sums in registers:
// a block owns 64 output columns (8 threads across, 8 columns each) and 32
// K-slices (the other thread index), so 8 neighbouring threads read one
// weight row's 64 columns as one 32 B (int4) / 64 B (packed) / 128 B (bf16)
// segment, kBatch rows' loads in flight at once (a slice walks only 24 rows,
// so their load latency, not the bytes, sets the time); x sits in shared
// memory as float. The 32 slices' sums are combined in a fixed order (two
// warp shuffles, then the 8 warps in order), so a run gives the same bits
// every time; with the probe's integer weights and x = ones every partial
// sum is an exact integer and the result is bit-equal to any order's.

#include "common.cuh"

namespace {

constexpr int kM = 8;                              // rows of x
constexpr int kCols = 8;                           // output columns per thread
constexpr int kColThreads = 8;                     // threads across a block's columns
constexpr int kSlices = 32;                        // threads along K
constexpr int kThreads = kColThreads * kSlices;    // 256
constexpr int kBlockCols = kCols * kColThreads;    // 64
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;                          // weight rows whose loads issue together

enum Format { kNativeInt4 = 0, kPackedInt8 = 1, kBf16 = 2 };

// A 4-bit two's-complement nibble n (0..15) as a float in [-8, 8).
__device__ __forceinline__ float nibble(unsigned v, int shift) {
  return (float)((int)(((v >> shift) & 15u) ^ 8u) - 8);
}

__device__ __forceinline__ void fma_row(float (&acc)[kM][kCols], const float* xk, int K,
                                        const float (&w)[kCols]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float xv = xk[m * K];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
  }
}

// Grid N / 64 blocks of 256 threads; dynamic shared memory gemv_smem(K).
template <int F>
__global__ void __launch_bounds__(kThreads)
probe_gemv_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ wv,
                  float* __restrict__ out, int K, int N) {
  extern __shared__ float sm[];
  float* xs = sm;                  // [kM][K]
  float* red = sm + kM * K;        // [kWarps][kM][kBlockCols]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = lane & (kColThreads - 1);               // column thread
  const int slice = warp * (32 / kColThreads) + lane / kColThreads;
  const int col0 = blockIdx.x * kBlockCols + ct * kCols;

  for (int i = tid; i < kM * K; i += kThreads) xs[i] = __bfloat162float(x[i]);
  __syncthreads();

  float acc[kM][kCols];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;
  }
  if (F == kPackedInt8) {
    const int half = K / 2, per = half / kSlices;
    const signed char* P = static_cast<const signed char*>(wv);
    for (int r0 = slice * per; r0 < (slice + 1) * per; r0 += kBatch) {
      uint2 raw[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        raw[b] = __ldg(reinterpret_cast<const uint2*>(P + (size_t)(r0 + b) * N + col0));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float lo[kCols], hi[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const unsigned word = j < 4 ? raw[b].x : raw[b].y;
          lo[j] = nibble(word, 8 * (j & 3));
          hi[j] = nibble(word, 8 * (j & 3) + 4);
        }
        fma_row(acc, xs + r0 + b, K, lo);
        fma_row(acc, xs + r0 + b + half, K, hi);
      }
    }
  } else if (F == kNativeInt4) {
    const int per = K / kSlices;
    const unsigned char* W4 = static_cast<const unsigned char*>(wv);
    for (int k0 = slice * per; k0 < (slice + 1) * per; k0 += kBatch) {
      unsigned raw[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        raw[b] = __ldg(reinterpret_cast<const unsigned*>(W4 + (size_t)(k0 + b) * (N / 2) +
                                                         col0 / 2));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[j] = nibble(raw[b], 4 * j);
        fma_row(acc, xs + k0 + b, K, w);
      }
    }
  } else {
    const int per = K / kSlices;
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(wv);
    for (int k0 = slice * per; k0 < (slice + 1) * per; k0 += kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        raw[b] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(k0 + b) * N + col0));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const unsigned words[4] = {raw[b].x, raw[b].y, raw[b].z, raw[b].w};
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const unsigned bits = (j & 1) ? (words[j >> 1] & 0xffff0000u) : (words[j >> 1] << 16);
          w[j] = __uint_as_float(bits);
        }
        fma_row(acc, xs + k0 + b, K, w);
      }
    }
  }
  // Combine the 4 slices of a warp (lane bits 3 and 4), then the 8 warps.
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(MAGPIE_FULL_MASK, v, 8);
      v += __shfl_xor_sync(MAGPIE_FULL_MASK, v, 16);
      acc[m][j] = v;
    }
  }
  if (lane < kColThreads) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) red[(warp * kM + m) * kBlockCols + ct * kCols + j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < kM * kBlockCols; i += kThreads) {
    float o = red[i];
    for (int w = 1; w < kWarps; ++w) o += red[w * kM * kBlockCols + i];
    const int m = i / kBlockCols, c = i % kBlockCols;
    out[(size_t)m * N + blockIdx.x * kBlockCols + c] = o;
  }
}

int gemv_smem(int K) { return (kM * K + kWarps * kM * kBlockCols) * (int)sizeof(float); }

template <int F>
int probe_gemv(const void* x, const void* w, float* out, int K, int N, void* stream) {
  // K: a multiple of 256 (32 slices of whole kBatch row groups; the packed
  // form's K / 2 too), at most 1024 (x and the partial sums in 48 KB of
  // shared memory); N: whole blocks.
  if (K < 256 || K > 1024 || K % 256 || N < kBlockCols || N % kBlockCols) {
    return (int)cudaErrorInvalidValue;
  }
  probe_gemv_kernel<F><<<N / kBlockCols, kThreads, gemv_smem(K),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), w, out, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x [8, K] bf16, the weight in the entry point's layout (above), out [8, N]
// float32.
extern "C" int magpie_probe_gemv_native_int4(const void* x, const void* w, float* out, int K,
                                             int N, void* stream) {
  return probe_gemv<kNativeInt4>(x, w, out, K, N, stream);
}
extern "C" int magpie_probe_gemv_packed_int8(const void* x, const void* w, float* out, int K,
                                             int N, void* stream) {
  return probe_gemv<kPackedInt8>(x, w, out, K, N, stream);
}
extern "C" int magpie_probe_gemv_bf16(const void* x, const void* w, float* out, int K, int N,
                                      void* stream) {
  return probe_gemv<kBf16>(x, w, out, K, N, stream);
}
