// The tensor-core building block of the codec convs (kernel B,
// codec_conv.cu, and kernel 9, codec_res_fused.cu): a warp's [32 x 8*NT]
// tile of a causal conv, read as an implicit GEMM, summed over one staged
// [chunk x N] slice of one tap's weights, and the ring that stages those
// slices with cp.async.
//
// The A operand is an activated window in shared memory, in the operand
// type, read at a per-row shift (tap i reads rows shifted by i * dilation).
// Each lane hands ldmatrix its own row address, so any shift works; the
// row stride is an odd multiple of 16 bytes, so the 8 rows of one 8x8
// matrix fall in 8 distinct bank groups. The B operand is the ring slice
// [chunk][sw] (output channels contiguous, sw = 8 mod 16 elements: also free
// of bank conflicts, for ldmatrix.trans in bf16 and scalar loads in float32).
// A warp holds NT n8 tiles (a template count, so no tile is predicated off);
// the callers pad the output width to the warps' tiles with zero weights.
//
// Why mma.sync and not wgmma, for every class of both kernels: wgmma takes
// A from registers in the same fragments, but its B must sit behind a
// shared-memory descriptor in the core-matrix layout, for every padded width
// the codec has (8 to 256 in steps of 8) with its own instruction per N, and
// the weight rows of the narrow stages (bf16: 108, 54 and 27 channels;
// float32: 54 and 27) are not 16-byte aligned, so TMA cannot stage them in
// that layout as they lie in memory; that layout could not be tried before
// the card run, and a wrong descriptor gives wrong sums, not a refusal.
// mma.sync's fragments are fixed by the ISA and loaded here by ldmatrix at
// per-row addresses.
//
// The tensor cores' float32 sums truncate toward zero, and a long chain of
// mma into one accumulator keeps that bias: the accumulator, of one sign, is
// truncated at every mma (chained, it set a 32-frame float32 decode's
// waveform 3.3e-4 away from kernel 9's on an H100). So no accumulator is
// chained through the K loop: the tensor cores sum a short run of products
// from zero (a sum of either sign), and ordinary float adds, which round to
// nearest, carry it into the total.
// bf16: mma.sync.m16n8k16 on bf16 operands with float32 sums (the Pallas
// kernels' jnp.dot(..., preferred_element_type=f32)), each mma's 16
// channels from zero, added to the total.
// float32: split TF32 on mma.sync.m16n8k8. Each operand is split as
// v = hi + lo (hi = v rounded to TF32, lo = v - hi rounded to TF32) and the
// product is lo*hi + hi*lo + hi*hi: about 21 bits of each operand, against
// TF32's 11. The dropped lo*lo term is 2^-22 of a product. Each 8 channels'
// three products are summed from zero and added to a ring step's (kernel 9:
// a tap's) sum, which goes to the total the same way.
//
// Every output element is summed by the same sequence of instructions
// wherever its row and column fall in the tile: the callers fix the K order
// (tap, chunk) and the chunk width from the shapes' channels and taps only.

#pragma once

#include "common.cuh"

namespace conv_mma {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32;  // a warp's rows: two m16 tiles
constexpr int kMaxKC = 128;    // the most input channels a ring slice holds
constexpr int kStages = 3;     // ring stages
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

template <class E>
struct Traits;
// kMaxNT: the most n8 tiles a warp holds (32 x 8 * kMaxNT outputs; float32
// keeps two accumulators, the total and the chunk's).
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kStep = 16;  // K of one mma
  static constexpr int kMaxNT = 8;
  static constexpr int kPad = 8;    // window stride = 16-multiple + 8 (odd x 16 bytes)
};
template <>
struct Traits<float> {
  static constexpr int kStep = 8;
  static constexpr int kMaxNT = 4;
  static constexpr int kPad = 4;
};

// Window row stride (elements) for `cols` channels: cols up to a multiple of
// 16, plus the pad that makes the stride an odd multiple of 16 bytes.
template <class E>
__host__ __device__ constexpr int window_stride(int cols) {
  return (cols + 15) / 16 * 16 + Traits<E>::kPad;
}
// Ring stage row stride for n output channels (n a multiple of 8).
__host__ __device__ constexpr int ring_stride(int n) { return n % 16 == 8 ? n : n + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d = A * B, summed from zero (no accumulator goes in).
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;  // 0: fill the destination with zeros
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <class E, int BYTES>
__device__ __forceinline__ void fill_async(E* dst, const E* src, int rows, int rows_ok,
                                           int cols_ok, int ld, int width, int sw) {
  constexpr int V = BYTES / sizeof(E);
  const int per_row = width / V;
  // copy i = threadIdx.x + n * kThreads of the slice is (row r, column c * V),
  // walked without a division per copy
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    const int o = c * V;
    const bool ok = r < rows_ok && o < cols_ok;
    cp_async<BYTES>(dst + r * sw + o, ok ? src + (size_t)r * ld + o : src, ok);
  }
}

// Stage a [rows x width] weight slice: dst[r][o] = src[r * ld + o] for
// r < rows_ok, o < cols_ok, else 0. `vec` elements per cp.async (16, 8 or
// 4 bytes); 0 = the rows are not 4-byte aligned (a bf16 tensor of odd
// width): plain loads and stores, done at once.
template <class E>
__device__ __forceinline__ void fill_stage(E* dst, const E* src, int rows, int rows_ok,
                                           int cols_ok, int ld, int width, int sw, int vec) {
  switch (vec * (int)sizeof(E)) {
    case 16:
      fill_async<E, 16>(dst, src, rows, rows_ok, cols_ok, ld, width, sw);
      break;
    case 8:
      fill_async<E, 8>(dst, src, rows, rows_ok, cols_ok, ld, width, sw);
      break;
    case 4:
      fill_async<E, 4>(dst, src, rows, rows_ok, cols_ok, ld, width, sw);
      break;
    default:
      for (int i = threadIdx.x; i < rows * width; i += kThreads) {
        const int r = i / width, o = i - r * width;
        dst[r * sw + o] = (r < rows_ok && o < cols_ok) ? src[(size_t)r * ld + o] : st<E>(0.f);
      }
  }
}

// The widest cp.async (elements) that every row start src + r * ld + o (o a
// multiple of o_step) keeps aligned; 0 if not even 4 bytes.
template <class E>
inline int pick_vec(const void* base, long long ld, long long o_step) {
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int v = bytes / (int)sizeof(E);
    if (v >= 1 && ld % v == 0 && o_step % v == 0 &&
        reinterpret_cast<uintptr_t>(base) % bytes == 0)
      return v;
  }
  return 0;
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory (past 48 KB
// only after this), once per kernel and card: `done` is the kernel's own
// flags, one per card, kept by its source file (a static inside an inline
// function would be one object for every library of the process).
template <class Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
}

// total += part; part = 0 (float32's partial sums).
template <int NT>
__device__ __forceinline__ void flush(float (&total)[2][NT][4], float (&part)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        total[mt][j][q] += part[mt][j][q];
        part[mt][j][q] = 0.f;
      }
}

// acc[mt][j] += A[rows of mt][k] * B[k][n8 tile n0 + j] over the stage's
// first ksteps * kStep channels (at most kMaxKC). a0 / a1: this lane's row of
// the two m16 tiles (row (lane & 15) of each), at the stage's first channel;
// ws: the stage at the warp's first column (n0 * 8). bf16 adds each mma's
// sum into acc; float32 adds into `part` (the caller adds it to acc; see the
// note above).
template <class E, int NT>
struct StageMma;

template <int NT>
struct StageMma<__nv_bfloat16, NT> {
  static __device__ __forceinline__ void run(float (&acc)[2][NT][4], float (&)[2][NT][4],
                                             const __nv_bfloat16* a0, const __nv_bfloat16* a1,
                                             int ksteps, const __nv_bfloat16* ws, int sw) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < kMaxKC / 16; ++ks) {
      if (ks < ksteps) {
        uint32_t a[2][4];
        ldsm_x4(a[0], a0 + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(a[1], a1 + ks * 16 + (lane >> 4) * 8);
        const __nv_bfloat16* bp = ws + (ks * 16 + (lane & 15)) * sw;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          ldsm_x2_trans(b, bp + j * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float d[4];
            mma_bf16_zero(d, a[mt], b);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][j][q] += d[q];
          }
        }
      }
    }
  }
};

template <int NT>
struct StageMma<float, NT> {
  static __device__ __forceinline__ void run(float (&acc)[2][NT][4], float (&part)[2][NT][4],
                                             const float* a0, const float* a1, int ksteps,
                                             const float* ws, int sw) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kMaxKC / 8; ++ks) {
      if (ks < ksteps) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t raw[4];
          ldsm_x4(raw, (mt ? a1 : a0) + ks * 8 + (lane >> 4) * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(raw[q]), ah[mt][q], al[mt][q]);
        }
        const float* bp = ws + (ks * 8 + t) * sw + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(bp[j * 8], bh[0], bl[0]);
          split_tf32(bp[j * 8 + 4 * sw], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};  // 8 channels' products, from zero
            mma_tf32(d, al[mt], bh);
            mma_tf32(d, ah[mt], bl);
            mma_tf32(d, ah[mt], bh);
#pragma unroll
            for (int q = 0; q < 4; ++q) part[mt][j][q] += d[q];
          }
        }
      }
    }
  }
};

// The HalfSnake of the plain half_snake: x + sin(a*x)^2 / a (libm sinf) on
// the first n_snake channels, LeakyReLU on the rest.
__device__ __forceinline__ float half_snake(float v, int c, float a, int n_snake, float slope) {
  if (c < n_snake) {
    const float s = sinf(a * v);
    return v + (s * s) / a;
  }
  return v >= 0.f ? v : slope * v;
}

}  // namespace conv_mma
