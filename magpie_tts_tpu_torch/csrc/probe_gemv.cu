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
// What is left above the bytes is latency, and the design cuts its chain.
//
// All three are one kernel, gemv_split_kernel<F>, a branch a format where
// the weight is read:
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
//   faster than 2 from HBM and 3-4% slower L2-resident. packed_int8 has its
//   own rule from its own two sweeps (PERF.md §6): the most splits,
//   at most 4, that leave a CTA 256 K rows, and at least 2 (2 at K 256 and
//   512, 3 at 768, 4 at 1024; at K 768 3 splits 5% faster than 4 both
//   ways, 48 x 3 = 144 CTAs, at K 256 2 faster than 1). Its split s owns byte rows
//   [s K / 2S, (s + 1) K / 2S): K rows of the same range in their low
//   nibbles and that range plus K / 2 in their high ones, so a split reads
//   each byte once and x's two matching slices.
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
//   byte feeds both. packed_int8: a byte holds two k of one column, so a
//   fragment register's pair is two bytes of one column, unpermuted (tile
//   rows padded to 80 bytes: a warp's byte reads fall in distinct banks);
//   their low nibbles feed the mma of the low-half K rows, their high
//   nibbles the mma of the same rows plus K / 2, and 4 pairs of byte loads
//   a lane feed both. Each mma sums its 16 k from zero and float adds carry
//   the total (the tensor cores truncate a chained float32 sum); packed_int8
//   adds a step's low mma, then its high one, step by step.
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

#include "cluster.cuh"
#include "common.cuh"
#include "conv_mma.cuh"

namespace {

constexpr int kM = 8;  // rows of x

enum Format { kNativeInt4 = 0, kPackedInt8 = 1, kBf16 = 2 };

// -------------------------- kernels 11-13 (native_int4, packed_int8, bf16)

constexpr int kTile = 64;                    // output columns a CTA
constexpr int kSplitWarps = kTile / 16;      // a warp an m16 tile of columns
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kStep = 16;                    // K of one mma
constexpr int kMaxCluster = 8;               // the portable cluster size: the most splits
constexpr int kPlanSplits = 4;               // the plan's most splits
constexpr int kMinRows = 128;                // the plan's fewest K rows a CTA
constexpr int kPackedMinRows = 256;          // packed_int8: the same, in 8 byte-row steps
constexpr int kPackedMinSplits = 2;          // packed_int8: the plan's fewest splits
constexpr int kGemvStamps = 5;
constexpr int kWStride = kTile + 8;          // bf16 tile row: 144 bytes
constexpr int kW4Stride = 48;                // int4 tile row: 32 bytes + 16
constexpr int kP8Stride = 80;                // packed tile row: 64 bytes + 16

bool shape_ok(int K, int N) {
  // K: a multiple of 256 in [256, 1024]; N: whole 64-column tiles.
  return K >= 256 && K <= 1024 && K % 256 == 0 && N >= kTile && N % kTile == 0;
}

// The K split of plan_gemv (ops/kernels/probe_gemv.py): the most splits,
// at most kPlanSplits, that leave a CTA kMinRows rows; for packed_int8
// kPackedMinRows rows, and at least kPackedMinSplits. K is a multiple of 256
// (shape_ok), so the split divides K / kStep and, for packed_int8, the byte
// rows' steps K / 2 / kStep.
int plan_splits(int F, int K) {
  if (F == kPackedInt8) {
    const int s = K / kPackedMinRows;
    return s < kPackedMinSplits ? kPackedMinSplits : s > kPlanSplits ? kPlanSplits : s;
  }
  return K / kMinRows < kPlanSplits ? K / kMinRows : kPlanSplits;
}

// Rows of a CTA's weight tile: its K rows, or for packed_int8 its byte rows,
// each holding two of its K rows (one from each half of K).
template <int F>
__host__ __device__ constexpr int tile_rows(int kchunk) {
  return F == kPackedInt8 ? kchunk / 2 : kchunk;
}
template <int F>
__host__ __device__ constexpr int w_tile_bytes(int kchunk) {
  return F == kBf16 ? kchunk * kWStride * 2
                    : F == kPackedInt8 ? tile_rows<F>(kchunk) * kP8Stride : kchunk * kW4Stride;
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

// This CTA's 16-byte copies of tile rows [r0, r1) of its slice, whose first
// stored row is k0.
template <int F>
__device__ __forceinline__ void copy_rows(const GemvCall& a, unsigned char* wt, int k0, int col0,
                                          int r0, int r1) {
  if (F == kPackedInt8) {
    const unsigned char* W = static_cast<const unsigned char*>(a.w) + (size_t)k0 * a.N + col0;
    for (int i = r0 * (kTile / 16) + threadIdx.x; i < r1 * (kTile / 16); i += kSplitThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      conv_mma::cp_async<16>(wt + r * kP8Stride + c, W + (size_t)r * a.N + c, true);
    }
  } else if (F == kBf16) {
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

// The products of tile rows [r0, r1) (whole mma steps) added to acc. For
// packed_int8 a step of byte rows is two mmas, the low nibbles' K rows (x's
// slice from column kk) then the high nibbles' (x's from hi + kk).
template <int F>
__device__ __forceinline__ void products(float (&acc)[4], const unsigned char* wt,
                                         const __nv_bfloat16* xs, int xstr, int hi, int r0,
                                         int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = r0; kk < r1; kk += kStep) {
    uint32_t af[4], bf[2];
    float d[4];
    ldsm_x2(bf, xs + (lane & 7) * xstr + kk + ((lane >> 3) & 1) * 8);
    if (F == kPackedInt8) {
      // byte rows kk + 2t, + 1, + 8, + 9 at columns g (m-row g) and g + 8
      // (m-row g + 8) of the warp's 16: a fragment register's pair of k is
      // two bytes of one column, their low nibbles for the low mma and their
      // high nibbles for the high one
      const unsigned char* p = wt + (kk + 2 * t) * kP8Stride + warp * 16 + g;
      const uint32_t v[4] = {(uint32_t)p[0] | ((uint32_t)p[kP8Stride] << 16),
                             (uint32_t)p[8] | ((uint32_t)p[kP8Stride + 8] << 16),
                             (uint32_t)p[8 * kP8Stride] | ((uint32_t)p[9 * kP8Stride] << 16),
                             (uint32_t)p[8 * kP8Stride + 8] | ((uint32_t)p[9 * kP8Stride + 8] << 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) af[j] = widen_nibbles(v[j] & 0x000f000fu);
      conv_mma::mma_bf16_zero(d, af, bf);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += d[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) af[j] = widen_nibbles((v[j] >> 4) & 0x000f000fu);
      ldsm_x2(bf, xs + (lane & 7) * xstr + hi + kk + ((lane >> 3) & 1) * 8);
    } else if (F == kBf16) {
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
  const int kc = a.kchunk, col0 = blockIdx.y * kTile;
  const int rows = tile_rows<F>(kc), k0 = blockIdx.x * rows;  // the slice's first stored row
  const int half = rows / (2 * kStep) * kStep;  // rows of the first stage: half the mma steps
  unsigned char* wt = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + w_tile_bytes<F>(kc));
  float* red = reinterpret_cast<float*>(smem + w_tile_bytes<F>(kc) + kM * x_stride(kc) * 2);

  // Every weight byte of the slice in flight at once, in two cp.async groups:
  // the first half of the rows, then x's slice with it, then the rest. x's
  // slice is kc columns: for packed_int8 columns [k0, k0 + rows) of x, then
  // the same from K / 2 on.
  copy_rows<F>(a, wt, k0, col0, 0, half);
  const int xv = kc / 8;  // 16-byte copies a row of x's slice
  for (int i = tid; i < kM * xv; i += kSplitThreads) {
    const int m = i / xv, c = (i - m * xv) * 8;
    const int src = c < rows ? k0 + c : a.K / 2 + k0 + c - rows;
    conv_mma::cp_async<16>(xs + m * x_stride(kc) + c, a.x + (size_t)m * a.K + src, true);
  }
  conv_mma::cp_async_commit();
  copy_rows<F>(a, wt, k0, col0, half, rows);
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
  products<F>(acc, wt, xs, x_stride(kc), rows, 0, half);
  conv_mma::cp_async_wait<0>();
  __syncthreads();
  stamp(a, 1);
  products<F>(acc, wt, xs, x_stride(kc), rows, half, rows);
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
  const int lo = F == kNativeInt4 ? warp * 16 + 2 * g : warp * 16 + g;
  const int hi = F == kNativeInt4 ? lo + 1 : lo + 8;
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
      (tile_rows<F>(a.K) / kStep) % a.splits || a.N / kTile > 65535 ||
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
  return gemv_split<kNativeInt4>(make_call(x, w, out, K, N, plan_splits(kNativeInt4, K), nullptr),
                                 static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_gemv_packed_int8(const void* x, const void* w, float* out, int K,
                                             int N, void* stream) {
  return gemv_split<kPackedInt8>(make_call(x, w, out, K, N, plan_splits(kPackedInt8, K), nullptr),
                                 static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_gemv_bf16(const void* x, const void* w, float* out, int K, int N,
                                      void* stream) {
  return gemv_split<kBf16>(make_call(x, w, out, K, N, plan_splits(kBf16, K), nullptr),
                           static_cast<cudaStream_t>(stream));
}
// Kernels 11-13 with the split given (plan_gemv's, or another for a sweep)
// and optional phase stamps: fmt 0 native_int4, 1 packed_int8, 2 bf16;
// stamps null or [splits * N / 64, 5] uint64.
extern "C" int magpie_probe_gemv_split(int fmt, const void* x, const void* w, float* out, int K,
                                       int N, int splits, unsigned long long* stamps,
                                       void* stream) {
  const GemvCall a = make_call(x, w, out, K, N, splits, stamps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == kNativeInt4) return gemv_split<kNativeInt4>(a, st);
  if (fmt == kPackedInt8) return gemv_split<kPackedInt8>(a, st);
  if (fmt == kBf16) return gemv_split<kBf16>(a, st);
  return (int)cudaErrorInvalidValue;
}
