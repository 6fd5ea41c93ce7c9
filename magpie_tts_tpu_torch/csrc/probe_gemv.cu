// Kernels 11-13: the H100 counterparts of the TPU's low-bit GEMV probes,
// scripts/probe_int4.py probe_native_int4 (:42, weights held as native
// int4), probe_packed_int8 (:71, two int4 nibbles packed per int8 byte,
// unpacked by shift / mask / (n ^ 8) - 8) and probe_bf16 (:110, the
// bf16-weight baseline): the product x [8, K] (bf16) @ W [K, N], every weight
// widened exactly, summed in float32, out [8, N] float32.
//
// Weight layouts (what each entry point reads):
//   native_int4 [K, N / 2] bytes: element order, as a jnp.int4 array holds
//     it; byte [k, j] has column 2j in its low nibble, 2j + 1 in its high;
//   packed_int8 [K / 2, N] int8: the probe's own packing; byte [r, c] has
//     w[r, c] & 15 low and w[r + K / 2, c] & 15 high;
//   bf16 [K, N].
//
// What bounds it on the card: bytes. At the probe's shapes (K 768, N 3072)
// the weight is 4.72 MB in bf16, 1.18 MB in int4: with x and the output,
// 1.442 / 0.385 us at 3.35 TB/s. The 37.7 MFLOP is 0.04 us on the tensor
// cores. A launch in a CUDA-graph chain costs ~1 us by itself (a 49 KB
// torch.add takes 1.05 us), so the int4 bound sits below the launch floor
// and cannot be reached at this size; the bf16 one is about one launch.
// What is left above the bytes is latency, and the design cuts its chain:
//
// Kernels 13 (bf16) and 11 (native_int4), gemv_split_kernel:
// - K is split across the card by the plan (ops/kernels/probe_gemv.py
//   plan_gemv, mirrored by plan_splits below: a function of K alone): a CTA
//   owns 64 output columns and K / S rows, S the most splits, at most 4,
//   that leave a CTA 128 rows (8 mma steps): 2 at K 256, 4 at K 512 to
//   1024. At K 768, N 3072: 48 tiles x 4 splits = 192 CTAs of 128 threads.
//   The rule is what two sweeps of every split the kernel takes (1 to 8)
//   measured on an H100 at N 3072 (chip_profile.py gemv, PERF.md §6): 6
//   and 8 splits slower than 4 at every K (a larger cluster waits on more
//   CTAs), 4 slower than 2 at K 256 (a CTA's fixed costs over 4 mma
//   steps). Not decided by them: at K 768, 3 and 4 splits lie within 3.5%
//   and the faster changes with the format, the setting and the run (bf16:
//   4 L2-resident, 3 from HBM in three runs of four; int4: tied in one
//   sweep, 3 by 2% in the other), and the rule takes 4, in bf16 the faster
//   of the two over both settings together in every run; at K 256 in bf16, 1 split is 2.5%
//   faster than 2 from HBM and 3-4% slower L2-resident.
// - The S CTAs of a column tile are one thread-block cluster along K. Each
//   issues its whole weight slice (bf16 24 KB, int4 6 KB at K 768)
//   as 16-byte cp.async copies into shared memory as its first act, in two
//   groups (the first half of its rows, with x's slice behind them, then the
//   rest), so every weight byte of the launch is in flight at once and the
//   first half's products run while the second half lands.
// - The products run on the tensor cores as W^T x^T, mma.sync m16n8k16 bf16
//   with float32 sums: A is a 16-column x 16-k tile of W^T, the batch of 8
//   rows is n = 8 exactly. bf16: A by ldmatrix.trans from the [k][n] tile
//   (rows padded to 144 bytes: the 8 rows of a matrix fall in 8 distinct
//   bank groups); B, x^T col-major, is x's row-major rows, by ldmatrix.
//   int4: each lane reads the 4 bytes its fragment needs straight from the
//   raw tile and widens their nibbles to bf16 in registers (the 0x4300
//   exponent trick: bf16 0x4300 | (n ^ 8) is 128 + (n ^ 8), less 136 is the
//   signed nibble, exact). A byte holds two neighbouring columns of one k,
//   a fragment register two k of one column, so the m16 tile's rows are
//   permuted: row g is column 2g of the 16, row g + 8 column 2g + 1, and one
//   byte feeds both. Each mma sums its 16 k from zero and float adds carry
//   the total (the tensor cores truncate a chained float32 sum).
// - The cluster's [8, 64] float32 partials meet in rank 0's shared memory:
//   each other rank pushes its fragments there, one 16-byte st.async a
//   thread that counts its bytes on a transaction barrier (mbarrier) of
//   rank 0, and exits; rank 0 waits for the bytes (not for the other CTAs),
//   sums its own and ranks 1 .. S - 1 in rank order and stores. A
//   barrier.cluster only once, at the start, so rank 0's barrier exists
//   before anything is pushed. No atomics, no workspace, no ticket: a launch
//   gives the same bits every time, and with integer weights and
//   small-integer x every partial sum is an exact integer below 2^24,
//   bit-equal to any order's.
// - Optional phase stamps (a null pointer in every ordinary launch): thread
//   0 of block i writes %globaltimer to stamps[i * 5 + s] at 0 its start,
//   1 all its weights and x in shared memory (the first half's products
//   done), 2 its products summed, 3 the other ranks' partials landed (ranks
//   above 0: their partial pushed), 4 its end (rank 0: the output stored).
//
// Kernel 12 (packed_int8), gemv_packed_kernel, keeps the SIMT design: a
// block owns 64 output columns (8 threads across, 8 columns each) and 32
// K-slices (the other thread index), 4 weight rows' loads in flight a
// thread; x sits in shared memory as float. The 32 slices' sums are
// combined in a fixed order (two warp shuffles, then the 8 warps in order).

#include "cluster.cuh"
#include "common.cuh"
#include "conv_mma.cuh"

namespace {

constexpr int kM = 8;  // rows of x

enum Format { kNativeInt4 = 0, kPackedInt8 = 1, kBf16 = 2 };

// ------------------------------------------------- kernel 12 (packed_int8)

constexpr int kCols = 8;                           // output columns per thread
constexpr int kColThreads = 8;                     // threads across a block's columns
constexpr int kSlices = 32;                        // threads along K
constexpr int kThreads = kColThreads * kSlices;    // 256
constexpr int kBlockCols = kCols * kColThreads;    // 64
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;                          // weight rows whose loads issue together

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

// Grid N / 64 blocks of 256 threads; dynamic shared memory packed_smem(K).
__global__ void __launch_bounds__(kThreads)
gemv_packed_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ wv,
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

int packed_smem(int K) { return (kM * K + kWarps * kM * kBlockCols) * (int)sizeof(float); }

bool shape_ok(int K, int N) {
  // K: a multiple of 256 in [256, 1024]; N: whole 64-column tiles.
  return K >= 256 && K <= 1024 && K % 256 == 0 && N >= kBlockCols && N % kBlockCols == 0;
}

int gemv_packed(const void* x, const void* w, float* out, int K, int N, cudaStream_t st) {
  // 32 slices of whole kBatch row groups of K / 2; x and the partial sums in
  // 48 KB of shared memory.
  if (!shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  gemv_packed_kernel<<<N / kBlockCols, kThreads, packed_smem(K), st>>>(
      static_cast<const __nv_bfloat16*>(x), w, out, K, N);
  return (int)cudaGetLastError();
}

// ------------------------------------ kernels 11 and 13 (native_int4, bf16)

constexpr int kTile = 64;                    // output columns a CTA
constexpr int kSplitWarps = kTile / 16;      // a warp an m16 tile of columns
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kStep = 16;                    // K of one mma
constexpr int kMaxCluster = 8;               // the portable cluster size: the most splits
constexpr int kPlanSplits = 4;               // the plan's most splits
constexpr int kMinRows = 128;                // the plan's fewest K rows a CTA
constexpr int kGemvStamps = 5;
constexpr int kWStride = kTile + 8;          // bf16 tile row: 144 bytes
constexpr int kW4Stride = 48;                // int4 tile row: 32 bytes + 16

// The K split of plan_gemv (ops/kernels/probe_gemv.py): the most splits,
// at most kPlanSplits, that leave a CTA kMinRows rows. K is a multiple of
// 256 (shape_ok), so the split divides K / kStep.
int plan_splits(int K) { return K / kMinRows < kPlanSplits ? K / kMinRows : kPlanSplits; }

template <int F>
__host__ __device__ constexpr int w_tile_bytes(int kchunk) {
  return F == kBf16 ? kchunk * kWStride * 2 : kchunk * kW4Stride;
}
__host__ __device__ constexpr int x_stride(int kchunk) { return kchunk + 8; }
template <int F>
__host__ __device__ constexpr int split_smem(int kchunk, int splits) {
  return w_tile_bytes<F>(kchunk) + kM * x_stride(kchunk) * 2 +
         (splits - 1) * kSplitThreads * 16;
}

struct GemvCall {
  const __nv_bfloat16* x;  // [8, K]
  const void* w;           // the format's storage
  float* out;              // [8, N]
  unsigned long long* stamps;
  int K, N, splits, kchunk;
};

__device__ __forceinline__ void stamp(const GemvCall& a, int s) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    a.stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kGemvStamps + s] = global_ns();
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(conv_mma::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(conv_mma::smem_u32(p)));
}

// Two nibbles, at bits 0-3 and 16-19 of v, as a pair of bf16 values in
// [-8, 8): exact (bf16 0x4300 | u is 128 + u; (n ^ 8) - 8 is the signed
// nibble).
__device__ __forceinline__ uint32_t widen_nibbles(uint32_t v) {
  const uint32_t biased = (v ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// This CTA's 16-byte copies of weight rows [r0, r1) of its slice.
template <int F>
__device__ __forceinline__ void copy_rows(const GemvCall& a, unsigned char* wt, int k0, int col0,
                                          int r0, int r1) {
  if (F == kBf16) {
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w) + (size_t)k0 * a.N + col0;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(wt);
    for (int i = r0 * (kTile / 8) + threadIdx.x; i < r1 * (kTile / 8); i += kSplitThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      conv_mma::cp_async<16>(dst + r * kWStride + c, W + (size_t)r * a.N + c, true);
    }
  } else {
    const int ld = a.N / 2;
    const unsigned char* W = static_cast<const unsigned char*>(a.w) + (size_t)k0 * ld + col0 / 2;
    for (int i = r0 * (kTile / 32) + threadIdx.x; i < r1 * (kTile / 32); i += kSplitThreads) {
      const int r = i >> 1, c = (i & 1) * 16;
      conv_mma::cp_async<16>(wt + r * kW4Stride + c, W + (size_t)r * ld + c, true);
    }
  }
}

// The products of weight rows [r0, r1) (whole mma steps) added to acc.
template <int F>
__device__ __forceinline__ void products(float (&acc)[4], const unsigned char* wt,
                                         const __nv_bfloat16* xs, int xstr, int r0, int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = r0; kk < r1; kk += kStep) {
    uint32_t af[4], bf[2];
    ldsm_x2(bf, xs + (lane & 7) * xstr + kk + ((lane >> 3) & 1) * 8);
    if (F == kBf16) {
      const int q = lane >> 3;
      ldsm_x4_trans(af, reinterpret_cast<const __nv_bfloat16*>(wt) +
                            (kk + (lane & 7) + 8 * (q >> 1)) * kWStride + warp * 16 + 8 * (q & 1));
    } else {
      // rows kk + 2t, + 1, + 8, + 9; byte g of the warp's 8 bytes: columns
      // 2g (low nibble, m-row g) and 2g + 1 (high, m-row g + 8)
      const unsigned char* p = wt + (kk + 2 * t) * kW4Stride + warp * 8 + g;
      const uint32_t lo01 = (uint32_t)p[0] | ((uint32_t)p[kW4Stride] << 16);
      const uint32_t lo89 = (uint32_t)p[8 * kW4Stride] | ((uint32_t)p[9 * kW4Stride] << 16);
      af[0] = widen_nibbles(lo01 & 0x000f000fu);
      af[1] = widen_nibbles((lo01 >> 4) & 0x000f000fu);
      af[2] = widen_nibbles(lo89 & 0x000f000fu);
      af[3] = widen_nibbles((lo89 >> 4) & 0x000f000fu);
    }
    float d[4];
    conv_mma::mma_bf16_zero(d, af, bf);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += d[j];
  }
}

// Grid (splits, N / 64), clusters of (splits, 1, 1), 128 threads; dynamic
// shared memory split_smem<F>(kchunk, splits): the weight tile, x's slice
// and, in rank 0, the other ranks' partials.
template <int F>
__global__ void __launch_bounds__(kSplitThreads) gemv_split_kernel(GemvCall a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long landed;  // rank 0: the partials' transaction barrier
  stamp(a, 0);
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  const int kc = a.kchunk, k0 = blockIdx.x * kc, col0 = blockIdx.y * kTile;
  const int half = kc / (2 * kStep) * kStep;  // rows of the first stage: half the mma steps
  unsigned char* wt = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + w_tile_bytes<F>(kc));
  float* red = reinterpret_cast<float*>(smem + w_tile_bytes<F>(kc) + kM * x_stride(kc) * 2);

  // Every weight byte of the slice in flight at once, in two cp.async groups:
  // the first half of the rows, then x's slice with it, then the rest.
  copy_rows<F>(a, wt, k0, col0, 0, half);
  const int xv = kc / 8;  // 16-byte copies a row of x's slice
  for (int i = tid; i < kM * xv; i += kSplitThreads) {
    const int m = i / xv, c = (i - m * xv) * 8;
    conv_mma::cp_async<16>(xs + m * x_stride(kc) + c, a.x + (size_t)m * a.K + k0 + c, true);
  }
  conv_mma::cp_async_commit();
  copy_rows<F>(a, wt, k0, col0, half, kc);
  conv_mma::cp_async_commit();
  if (rank == 0 && tid == 0) {
    // the other ranks' partials complete this phase: one arrival, their bytes
    mbar_init(&landed, 1);
    mbar_arrive_expect_tx(&landed, (a.splits - 1) * kSplitThreads * 16);
    fence_mbar_init();
  }
  cluster_arrive_started();

  // The products of each stage as it lands, an mma a 16-row step.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  conv_mma::cp_async_wait<1>();
  __syncthreads();
  products<F>(acc, wt, xs, x_stride(kc), 0, half);
  conv_mma::cp_async_wait<0>();
  __syncthreads();
  stamp(a, 1);
  products<F>(acc, wt, xs, x_stride(kc), half, kc);
  stamp(a, 2);

  // acc: rows 2t, 2t + 1 of out at column lo (acc 0, 1) and hi (acc 2, 3).
  // Ranks 1 .. S - 1 push theirs into rank 0's slots as they hold them (a
  // thread's 4 floats at red[rank - 1][tid]: one 16-byte st.async that
  // counts its bytes on rank 0's barrier, read back by rank 0's thread of
  // the same fragment) and exit; rank 0 waits for the bytes and sums in
  // rank order.
  cluster_wait_started();
  if (rank != 0) {
    st_async_cluster4(red + ((rank - 1) * kSplitThreads + tid) * 4, acc, &landed, 0);
    stamp(a, 3);
    stamp(a, 4);
    return;
  }
  mbar_wait(&landed, 0);
  stamp(a, 3);
  for (int r = 1; r < a.splits; ++r) {
    const float4 p = reinterpret_cast<const float4*>(red)[(r - 1) * kSplitThreads + tid];
    acc[0] += p.x;
    acc[1] += p.y;
    acc[2] += p.z;
    acc[3] += p.w;
  }
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int lo = F == kBf16 ? warp * 16 + g : warp * 16 + 2 * g;
  const int hi = F == kBf16 ? lo + 8 : lo + 1;
  float* o = a.out + col0;
  o[(size_t)2 * t * a.N + lo] = acc[0];
  o[(size_t)(2 * t + 1) * a.N + lo] = acc[1];
  o[(size_t)2 * t * a.N + hi] = acc[2];
  o[(size_t)(2 * t + 1) * a.N + hi] = acc[3];
  stamp(a, 4);
}

template <int F>
int gemv_split(GemvCall a, cudaStream_t st) {
  if (!shape_ok(a.K, a.N) || a.splits < 1 || a.splits > kMaxCluster ||
      (a.K / kStep) % a.splits || a.N / kTile > 65535 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.w) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  a.kchunk = a.K / a.splits;
  const int smem = split_smem<F>(a.kchunk, a.splits);
  const int e = raise_smem(reinterpret_cast<const void*>(gemv_split_kernel<F>), smem);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.N / kTile);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_split_kernel<F>, a);
  // Reading the last error clears it: a refused launch must not fail the next one.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)last;
}

GemvCall make_call(const void* x, const void* w, float* out, int K, int N, int splits,
                   unsigned long long* stamps) {
  GemvCall a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w, a.out = out, a.stamps = stamps;
  a.K = K, a.N = N, a.splits = splits;
  return a;
}

}  // namespace

// x [8, K] bf16, the weight in the entry point's layout (above), out [8, N]
// float32.
extern "C" int magpie_probe_gemv_native_int4(const void* x, const void* w, float* out, int K,
                                             int N, void* stream) {
  return gemv_split<kNativeInt4>(make_call(x, w, out, K, N, plan_splits(K), nullptr),
                                 static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_gemv_packed_int8(const void* x, const void* w, float* out, int K,
                                             int N, void* stream) {
  return gemv_packed(x, w, out, K, N, static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_gemv_bf16(const void* x, const void* w, float* out, int K, int N,
                                      void* stream) {
  return gemv_split<kBf16>(make_call(x, w, out, K, N, plan_splits(K), nullptr),
                           static_cast<cudaStream_t>(stream));
}
// Kernels 11 and 13 with the split given (plan_gemv's, or another for a
// sweep) and optional phase stamps: fmt 0 native_int4, 2 bf16; stamps null
// or [splits * N / 64, 5] uint64.
extern "C" int magpie_probe_gemv_split(int fmt, const void* x, const void* w, float* out, int K,
                                       int N, int splits, unsigned long long* stamps,
                                       void* stream) {
  const GemvCall a = make_call(x, w, out, K, N, splits, stamps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == kNativeInt4) return gemv_split<kNativeInt4>(a, st);
  if (fmt == kBf16) return gemv_split<kBf16>(a, st);
  return (int)cudaErrorInvalidValue;
}
