// Kernels 14 and 18: the H100 counterparts of the TPU's attend probes,
// scripts/opt_int8_attend_probe.py build (modes bf16, i8mixed, i8cast: entry
// points magpie_probe_attend_tr, _i8mixed, _i8cast) and
// scripts/opt_attend_probe.py build (orientations cur and tr: _cur, _tr): one
// query row per slot, H heads of 64 columns, attending over the first `rows`
// rows of the slot's K / V cache [G, S, D]. Each launch ADDS its attend to
// out [G, D] (float32): the TPU kernel's `iters` grid steps over a resident
// cache become `iters` launches.
//
// The Pallas kernels' rounding points are kept: the query is bf16 (masked per
// head, exact); scores are float32 sums of exact products, scaled by
// inv = 1 / sqrt(64) (i8mixed: by s_k[r] * inv, formed first); the softmax over
// rows is float32 (max, exp, sum, divide); the probabilities are rounded to
// bf16 (i8mixed: after the product with s_v[r]) only once normalised over all
// the rows; P V sums in float32. i8cast dequantizes every K / V value as
// float(int8) * s, rounded to bf16, before either dot; i8mixed reads the int8
// values themselves (exact as floats) and folds the scales into the [rows]
// vectors.
//
// What bounds it on the card: bytes. K and V are read once, rows x D x 2 x 2 B
// a slot in bf16 (15.7 MB at 640 rows for 8 slots: 4.7 us at 3.35 TB/s), half
// that in int8 plus 8 B of scales a row. The work is a dot and a P V term per
// row and column, ~16 MFLOP at 640 rows: ~1 flop a byte, 0.25 us on the
// float32 cores. The tensor cores, which pay from ~295 flops a byte, buy
// nothing here. At these sizes what is left above the bytes is latency: the
// launch, the copies' round trip, and every step that one block must wait
// for another's. So:
//
// - Rows are split across the card, in chunks from the wrapper's plan
//   (ops/kernels/probe_attend.py plan_attend: a function of the mode and the
//   head width alone, never of G, so a slot's bits do not depend on G).
// - Every block issues all its K and V copies (cp.async, 16 bytes a thread;
//   K first, V after it) before anything else, so the whole cache is in
//   flight at once (~120 KB an SM at 640 rows) and V arrives while K is
//   scored. Issuing V only once the first K rows had landed measured slower
//   on an H100.
// - An online (flash) softmax, exp(s - m_c) rescaled later, cannot give the
//   probabilities rounded after normalising. So each block forms its rows'
//   max and sum of exp(s - max), the blocks of a (slot, head) exchange them,
//   and only then round exp(s - m) / l to bf16 and multiply V. Every sum
//   runs in an order set by the shape; there are no float atomics.
// - Reads are 16 bytes a lane everywhere: 8 bf16 or 16 int8 values, widened
//   (and dequantized, with the row's scale loaded once) in registers.
//
// Two forms, which differ in how rows are read and in how blocks meet:
// - tr, bf16, i8mixed, i8cast (head slices): a thread-block cluster of 8 CTAs
//   a (slot, head), 768 blocks at 8 slots. Chunks of 16 bf16 / 32 int8 rows
//   (2 KB of K, one cp.async group each, scored as it lands) go round robin
//   to the cluster's CTAs; 8 lanes read a head's 128-byte slice of a row (4
//   lanes, 64 B, in int8). Each warp's (max, sum) and then each CTA's P V
//   partial go to the other CTAs' shared memory (st.shared::cluster), with
//   barrier.cluster between (~0.5 us each on an H100); CTA 0 sums the eight
//   partials in rank order and adds them to out. No workspace, no ticket.
// - cur (whole rows): a block a (slot, chunk of 16 rows), 320 blocks at 8
//   slots and 640 rows; a chunk is one contiguous 24 KB run and a warp
//   scores all heads of a row from one read. A slot's 40 blocks are more
//   than a cluster holds, so they meet at grid barriers of one cooperative
//   launch: phase 1 writes the chunk's scores and (max, sum) to the launch's
//   workspace, phase 2 reads the slot's partials in a fixed order and writes
//   the chunk's P V partial, and after a second barrier eight lanes an
//   output sum its chunk partials (each lane a run of chunks in order, then a
//   butterfly). A ticket and a last block summing all 40 partials instead
//   measured 1.5x slower on an H100. The barrier's word is the wrapper's,
//   one per device, zeroed once: block 0 adds 2^31 - (grid - 1) and every
//   other block 1, so each barrier flips the top bit and leaves the low bits
//   at 0, whatever the grid. A grid larger than the card holds is not
//   launched: blocks loop over items (the first item's V is the one
//   prefetched).
//
// Optional phase stamps (a null pointer in every ordinary launch): thread 0
// of block i writes %globaltimer to stamps[i * kStamps + s] at 0 its start,
// 1 its first K rows in shared memory, 2 its rows scored, 3 its partials
// ready, 4 past the cluster or grid barrier, 5 its P V partial ready, 6 its
// end.

#include <algorithm>
#include <mutex>

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kDh = 64;              // columns per head
constexpr int kSliceThreads = 128;   // head-slice CTA: 4 warps
constexpr int kCluster = 8;          // CTAs of a (slot, head)
constexpr int kCurThreads = 256;     // cur: 8 warps
constexpr int kCurChunk = 16;        // rows of a cur chunk: a half-warp a head in the partials
constexpr int kCurMaxD = 1024;
constexpr int kStamps = 7;

enum Mode { kBf16 = 0, kMixed = 1, kCast = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Waits until at most n of this thread's groups are pending (n above 7 waits
// for 7: more than asked, never less).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier of cur (see the note above). A wait past 2 s traps: a
// deadlock is a launch error, not a hang.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u) : 1u;
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    const unsigned old = atomicAdd(bar, add);
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0u) {
      if ((++spins & 1023u) == 0 && global_ns() - t0 > 2000000000ull) __trap();
    }
  }
  __syncthreads();
}

// 16 bytes of K / V widened to floats: 8 bf16 or 16 int8 values.
__device__ __forceinline__ void widen(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&v)[16]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * i + j] = (float)(signed char)((w[i] >> (8 * j)) & 0xffu);
  }
}

struct Call {
  const __nv_bfloat16* q;  // [G, D]
  const void* K;           // [G, S, D]
  const void* V;
  const float* sk;         // [G, S] (int8 modes)
  const float* sv;
  float* out;              // [G, D]
  float* ws;               // cur: the launch's workspace
  unsigned* bar;           // cur: the device's barrier word
  unsigned long long* stamps;
  int G, S, D, H, rows, chunk, nc;
  float inv;
};

__device__ __forceinline__ void stamp(const Call& a, int s) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    a.stamps[(size_t)blockIdx.x * kStamps + s] = global_ns();
  }
}

// ---------------------------------------------------------------- head slice

// A head's 64 columns of a row in KV: kVec 16-byte vectors of kVE values.
template <class KV>
struct Slice {
  static constexpr int kVE = 16 / (int)sizeof(KV);
  static constexpr int kVec = kDh / kVE;               // lanes a row: 8 bf16, 4 int8
  static constexpr int kGroups = kSliceThreads / kVec;  // rows a block pass: 16 / 32
  static constexpr int kChunk = kGroups;                // rows a chunk (2 KB of K): one pass
};

// Rows a CTA of the cluster holds for nc chunks of `chunk` rows.
__host__ __device__ constexpr int slice_rows(int nc, int chunk) {
  return (nc + kCluster - 1) / kCluster * chunk;
}
constexpr int kSliceWarps = kSliceThreads / 32;
constexpr int kParts = kCluster * kSliceWarps;  // (max, sum) partials of a (slot, head)
// Dynamic shared memory of a head-slice CTA holding LR rows: K, V, the rows'
// scales and scores, the warps' P V sums, the cluster's (max, sum) partials
// and, in CTA 0, the CTAs' P V partials.
template <class KV>
__host__ __device__ constexpr int slice_smem(int LR) {
  return 2 * LR * Slice<KV>::kVec * 16 +
         (3 * LR + kSliceWarps * kDh + 2 * kParts + kCluster * kDh) * 4;
}

// Copies of n rows of a head's slice (and the rows' scales); not committed.
template <class KV, int MODE>
__device__ __forceinline__ void copy_slice(uint4* dst, float* sdst, const KV* src,
                                           const float* ssrc, int D, int n) {
  using L = Slice<KV>;
  for (int i = threadIdx.x; i < n * L::kVec; i += kSliceThreads) {
    cp_async16(dst + i, src + (size_t)(i / L::kVec) * D + (i % L::kVec) * L::kVE);
  }
  if (MODE != kBf16) {
    for (int i = threadIdx.x; i < n; i += kSliceThreads) cp_async4(sdst + i, ssrc + i);
  }
}

// Cluster (slot b, head h) = blocks [8 (b H + h), 8 (b H + h) + 8). CTA j holds
// chunks j, j + 8, ... (local row lr = i * chunk + rr is row (j + 8 i) chunk + rr),
// each K chunk a cp.async group of its own, V one group after them.
// Scoring: VEC lanes a row (a butterfly ends its dot), a chunk a pass, each
// chunk as soon as it lands.
// Partials: warp w of CTA j takes local rows w * 32 + lane + 128 k; its (max,
// sum) goes to slot 4 j + w of every CTA's table (st.shared::cluster), and
// after the cluster barrier lane i of every warp reads slot i, the 32 merged
// by butterflies. P V: thread (g, l) sums rows g, g + kGroups, ... of
// columns l * VE .. + VE; the row groups of a warp by butterfly, the warps in
// order; the CTA's partial goes to row j of CTA 0's table, and after a second
// barrier CTA 0 sums the 8 rows in rank order and adds them to out.
template <class KV, int MODE>
__global__ void __launch_bounds__(kSliceThreads)
attend_slice_kernel(const Call a) {
  using L = Slice<KV>;
  constexpr int VE = L::kVE, VEC = L::kVec, GR = L::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CH = L::kChunk;
  const int LR = slice_rows(a.nc, CH);
  uint4* sK = reinterpret_cast<uint4*>(smem);  // [LR][VEC]
  uint4* sV = sK + LR * VEC;
  float* ssk = reinterpret_cast<float*>(sV + LR * VEC);  // [LR] (int8 modes)
  float* ssv = ssk + LR;
  float* sc = ssv + LR;                // [LR] scores
  float* grp = sc + LR;                // [4][64] the warps' P V sums
  float* tab = grp + kSliceWarps * kDh;  // [32][2] the cluster's (max, sum) partials
  float* pvt = tab + 2 * kParts;       // [8][64] CTA 0: the CTAs' P V partials
  stamp(a, 0);
  cluster_arrive_started();
  const int rank = cluster_rank();
  const int bh = blockIdx.x / kCluster, h = bh % a.H, b = bh / a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / VEC, l = tid % VEC;
  const int nl = rank < a.nc ? (a.nc - 1 - rank) / kCluster + 1 : 0;  // this CTA's chunks
  const int lr_end = nl * CH;
  // q (this lane's VE columns of the head) and, in CTA 0, the output it adds
  // to: loaded before the copies, so they do not queue behind them
  float* ob = a.out + (size_t)b * a.D + h * kDh;
  const float prev = rank == 0 && tid < kDh ? ob[tid] : 0.f;
  uint4 qraw[VE / 8];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(a.q + (size_t)b * a.D + h * kDh + l * VE);
#pragma unroll
    for (int j = 0; j < VE / 8; ++j) qraw[j] = __ldg(qp + j);
  }
  const size_t base = (size_t)b * a.S;
  const KV* K = static_cast<const KV*>(a.K) + base * a.D + h * kDh;
  const KV* V = static_cast<const KV*>(a.V) + base * a.D + h * kDh;
  const float* skb = MODE == kBf16 ? nullptr : a.sk + base;
  const float* svb = MODE == kBf16 ? nullptr : a.sv + base;
  auto row0 = [&](int i) { return (rank + i * kCluster) * CH; };  // first row of local chunk i
  auto row_ok = [&](int lr) { return row0(lr / CH) + lr % CH < a.rows; };
  for (int i = 0; i < nl; ++i) {  // a group a K chunk, then one for all of V
    const int r0 = row0(i);
    copy_slice<KV, MODE>(sK + i * CH * VEC, ssk + i * CH, K + (size_t)r0 * a.D,
                         skb ? skb + r0 : nullptr, a.D, min(CH, a.rows - r0));
    cp_async_commit();
  }
  for (int i = 0; i < nl; ++i) {
    const int r0 = row0(i);
    copy_slice<KV, MODE>(sV + i * CH * VEC, ssv + i * CH, V + (size_t)r0 * a.D,
                         svb ? svb + r0 : nullptr, a.D, min(CH, a.rows - r0));
  }
  cp_async_commit();
  float qv[VE];
#pragma unroll
  for (int j = 0; j < VE / 8; ++j) {
    float t[8];
    widen(qraw[j], t);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[8 * j + e] = t[e];
  }
  // chunk i is scored as soon as it lands (one pass: chunk == kGroups rows),
  // while the later chunks and V are still in flight
  for (int i = 0; i < nl; ++i) {
    cp_async_wait_at_most(nl - i);  // the groups of chunks i + 1 .. and of V
    __syncthreads();
    if (i == 0) stamp(a, 1);
    const int lr = i * CH + g;
    const bool ok = row_ok(lr);
    float dot = 0.f;
    if (ok) {
      float kv[VE];
      widen(sK[lr * VEC + l], kv);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float kk = MODE == kCast ? rnd<__nv_bfloat16>(kv[e] * ssk[lr]) : kv[e];
        dot = fmaf(qv[e], kk, dot);
      }
    }
#pragma unroll
    for (int o = VEC / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, o);
    if (l == 0) {
      sc[lr] = ok ? (MODE == kMixed ? dot * (ssk[lr] * a.inv) : dot * a.inv) : -INFINITY;
    }
  }
  __syncthreads();
  stamp(a, 2);
  // this warp's max and sum of exp(s - max), to slot 4 rank + warp of every CTA
  {
    float m = -INFINITY;
    for (int lr = warp * 32 + lane; lr < lr_end; lr += kSliceThreads) m = fmaxf(m, sc[lr]);
    m = warp_max(m);
    float ls = 0.f;
    for (int lr = warp * 32 + lane; lr < lr_end; lr += kSliceThreads) {
      if (row_ok(lr)) ls += expf(sc[lr] - m);
    }
    ls = warp_sum(ls);
    cluster_wait_started();
    if (lane < kCluster) st_cluster2(tab + 2 * (rank * kSliceWarps + warp), m, ls, lane);
  }
  stamp(a, 3);
  cluster_sync();
  stamp(a, 4);
  // the (slot, head)'s max and sum (every warp the same two numbers)
  const float pm = tab[2 * lane], pl = tab[2 * lane + 1];
  const float mx = warp_max(pm);
  const float lt = warp_sum(pl > 0.f ? pl * expf(pm - mx) : 0.f);
  cp_async_wait<0>();
  __syncthreads();
  float acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;
  for (int lr = g; lr < lr_end; lr += GR) {
    if (!row_ok(lr)) continue;
    float vv[VE];
    widen(sV[lr * VEC + l], vv);
    // the row's probability (each of its VEC lanes forms the same one)
    const float e_s = expf(sc[lr] - mx) / lt;
    const float p = rnd<__nv_bfloat16>(MODE == kMixed ? e_s * ssv[lr] : e_s);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float x = MODE == kCast ? rnd<__nv_bfloat16>(vv[e] * ssv[lr]) : vv[e];
      acc[e] = fmaf(p, x, acc[e]);
    }
  }
#pragma unroll
  for (int o = 16; o >= VEC; o >>= 1) {
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] += __shfl_xor_sync(MAGPIE_FULL_MASK, acc[e], o);
  }
  if (lane < VEC) {
#pragma unroll
    for (int e = 0; e < VE; ++e) grp[warp * kDh + l * VE + e] = acc[e];
  }
  __syncthreads();
  if (tid < kDh) {
    float o = grp[tid];
    for (int j = 1; j < kSliceWarps; ++j) o += grp[j * kDh + tid];
    st_cluster(pvt + rank * kDh + tid, o, 0);
  }
  stamp(a, 5);
  cluster_sync();
  if (rank == 0 && tid < kDh) {
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) o += pvt[j * kDh + tid];
    ob[tid] = prev + o;
  }
  stamp(a, 6);
}

// ----------------------------------------------------------------------- cur

// The workspace of one cur launch (float32 words; the wrapper sizes it by the
// same layout, probe_attend.workspace_words): scores [G, H, rows], chunk
// partials (m_c, l_c) [G, H, nc, 2] and P V partials [G, nc, D].
struct Work {
  float* sc;
  float* part;
  float* po;
  __device__ Work(float* ws, int G, int H, int D, int rows, int nc) {
    sc = ws;
    part = sc + (size_t)G * H * rows;
    po = part + (size_t)G * H * nc * 2;
  }
};

// Dynamic shared memory of cur for D columns: K and V chunks (the K region
// holds the P V halves in phase 2), then scores and probabilities [H][16].
__host__ __device__ constexpr int cur_smem(int D) {
  return 2 * kCurChunk * D * 2 + 2 * (D / kDh) * kCurChunk * 4;
}

__device__ __forceinline__ void copy_rows(uint4* dst, const __nv_bfloat16* src, int D, int n) {
  const int nv = n * D / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < nv; i += kCurThreads) cp_async16(dst + i, s + i);
  cp_async_commit();
}

// Items (b, c) with c fastest. Scoring: warp w takes rows w and w + 8; a
// lane covers 8 columns of each 256-wide third, heads 4j + lane / 8, and
// 8 lanes end a head's dot in a butterfly. Partials and probabilities: a
// half-warp a head, a lane a row. P V: thread (half, column vector) sums
// rows 8 half .. 8 half + 7 of 8 columns.
__global__ void __launch_bounds__(kCurThreads, 3) attend_cur_kernel(const Call a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, H = a.H, VR = D / 8;
  uint4* sK = reinterpret_cast<uint4*>(smem);  // [16][VR]
  uint4* sV = sK + kCurChunk * VR;
  float* sc = reinterpret_cast<float*>(sV + kCurChunk * VR);  // [H][16]
  float* pr = sc + H * kCurChunk;                             // [H][16]
  float* grp = reinterpret_cast<float*>(sK);                  // [2][D], phase 2
  const Work w(a.ws, a.G, H, D, a.rows, a.nc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int items = a.G * a.nc;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.K);
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.V);
  const int hr = tid / kCurChunk, j = tid % kCurChunk;  // partials: head hr, row / lane j
  const bool part_thread = tid < H * kCurChunk;

  stamp(a, 0);
  // ---- phase 1
  for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
    const int c = it % a.nc, b = it / a.nc;
    const int r0 = c * kCurChunk, n = min(kCurChunk, a.rows - r0);
    const size_t row0 = (size_t)b * a.S + r0;
    // this lane's 8 columns of q in each 256-wide third, loaded before the
    // copies so that they do not queue behind them
    uint4 qraw[kCurMaxD / 256];
    const uint4* qp = reinterpret_cast<const uint4*>(a.q + (size_t)b * D);
#pragma unroll
    for (int t = 0; t < kCurMaxD / 256; ++t) {
      if (t < D / 256) qraw[t] = __ldg(qp + t * 32 + lane);
    }
    copy_rows(sK, K + row0 * D, D, n);
    if (k == 0) copy_rows(sV, V + row0 * D, D, n);
    if (k == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k == 0) stamp(a, 1);
    for (int r = warp; r < kCurChunk; r += kCurThreads / 32) {
#pragma unroll
      for (int t = 0; t < kCurMaxD / 256; ++t) {
        if (t >= D / 256) break;
        float dot = 0.f;
        if (r < n) {
          float qv[8], kv[8];
          widen(qraw[t], qv);
          widen(sK[r * VR + t * 32 + lane], kv);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qv[e], kv[e], dot);
        }
        dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 1);
        dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 2);
        dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 4);
        if ((lane & 7) == 0) sc[(t * 4 + lane / 8) * kCurChunk + r] = r < n ? dot * a.inv
                                                                            : -INFINITY;
      }
    }
    __syncthreads();
    if (k == 0) stamp(a, 2);
    if (part_thread) {  // whole warps: H is a multiple of 4
      const float s = sc[tid];
      if (j < n) w.sc[((size_t)b * H + hr) * a.rows + r0 + j] = s;
      float m = s;
#pragma unroll
      for (int o = kCurChunk / 2; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(MAGPIE_FULL_MASK, m, o));
      }
      float l_c = j < n ? expf(s - m) : 0.f;
#pragma unroll
      for (int o = kCurChunk / 2; o > 0; o >>= 1) {
        l_c += __shfl_xor_sync(MAGPIE_FULL_MASK, l_c, o);
      }
      if (j == 0) {
        float* p = w.part + (((size_t)b * H + hr) * a.nc + c) * 2;
        p[0] = m;
        p[1] = l_c;
      }
    }
    __syncthreads();
  }
  stamp(a, 3);

  grid_sync(a.bar);
  stamp(a, 4);

  // ---- phase 2
  for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
    const int c = it % a.nc, b = it / a.nc;
    const int r0 = c * kCurChunk, n = min(kCurChunk, a.rows - r0);
    const size_t row0 = (size_t)b * a.S + r0;
    if (k > 0) copy_rows(sV, V + row0 * D, D, n);
    if (part_thread) {
      // head hr's max and sum: lane j takes chunks j, j + 16, ..., then a
      // butterfly over the half-warp
      // (the first kHeld of them loaded once, into registers)
      constexpr int kHeld = 4;
      const float* part = w.part + ((size_t)b * H + hr) * a.nc * 2;
      const float s = j < n ? __ldcg(w.sc + ((size_t)b * H + hr) * a.rows + r0 + j) : 0.f;
      float pm[kHeld], pl[kHeld];
#pragma unroll
      for (int u = 0; u < kHeld; ++u) {
        const int cc = j + u * kCurChunk;
        const float2 v = cc < a.nc ? __ldcg(reinterpret_cast<const float2*>(part) + cc)
                                   : make_float2(-INFINITY, 0.f);
        pm[u] = v.x, pl[u] = v.y;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kHeld; ++u) mx = fmaxf(mx, pm[u]);
      for (int cc = j + kHeld * kCurChunk; cc < a.nc; cc += kCurChunk) {
        mx = fmaxf(mx, __ldcg(part + 2 * cc));
      }
#pragma unroll
      for (int o = kCurChunk / 2; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(MAGPIE_FULL_MASK, mx, o));
      }
      float ls = 0.f;
#pragma unroll
      for (int u = 0; u < kHeld; ++u) {
        if (j + u * kCurChunk < a.nc) ls += pl[u] * expf(pm[u] - mx);
      }
      for (int cc = j + kHeld * kCurChunk; cc < a.nc; cc += kCurChunk) {
        ls += __ldcg(part + 2 * cc + 1) * expf(__ldcg(part + 2 * cc) - mx);
      }
#pragma unroll
      for (int o = kCurChunk / 2; o > 0; o >>= 1) {
        ls += __shfl_xor_sync(MAGPIE_FULL_MASK, ls, o);
      }
      pr[tid] = j < n ? rnd<__nv_bfloat16>(expf(s - mx) / ls) : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tid < 2 * VR) {
      const int cv = tid % VR, half = tid / VR, h = cv / (kDh / 8);
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      for (int r = half * 8; r < min(n, half * 8 + 8); ++r) {
        float vv[8];
        widen(sV[r * VR + cv], vv);
        const float p = pr[h * kCurChunk + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) grp[half * D + cv * 8 + e] = acc[e];
    }
    __syncthreads();
    float* po = w.po + ((size_t)b * a.nc + c) * D;
    for (int d = tid; d < D; d += kCurThreads) po[d] = grp[d] + grp[D + d];
    if (k == 0) stamp(a, 5);
    __syncthreads();
  }

  grid_sync(a.bar);

  // ---- phase 3: out[b, d] += the sum of the slot's nc partials. Eight
  // lanes an output: lane p sums chunks [p per, (p + 1) per) in order, then
  // a butterfly over the eight (a whole warp is four outputs: G D is a
  // multiple of 4, so every lane of a warp runs the same loop).
  const int per = (a.nc + 7) / 8, p8 = lane & 7;
  const int n_out = a.G * D, stride = gridDim.x * kCurThreads / 8;
  for (int o = (blockIdx.x * kCurThreads + tid) / 8; o < n_out; o += stride) {
    const int b = o / D, d = o - b * D;
    const float* po = w.po + (size_t)b * a.nc * D + d;
    const int c0 = min(a.nc, p8 * per), c1 = min(a.nc, c0 + per);
    float sum = 0.f;
    for (int cc = c0; cc < c1; cc += 8) {
      float v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) v[x] = cc + x < c1 ? __ldcg(po + (size_t)(cc + x) * D) : 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        if (cc + x < c1) sum += v[x];
      }
    }
    sum += __shfl_xor_sync(MAGPIE_FULL_MASK, sum, 4);
    sum += __shfl_xor_sync(MAGPIE_FULL_MASK, sum, 2);
    sum += __shfl_xor_sync(MAGPIE_FULL_MASK, sum, 1);
    if (p8 == 0) a.out[o] += sum;
  }
  stamp(a, 6);
}

// ------------------------------------------------------------------ launches

// Co-resident blocks an SM of cur at `smem` bytes, cached per device and size;
// -1 on a CUDA error.
int cur_blocks_per_sm(int smem, int* n_sm) {
  struct Entry {
    int device, smem, blocks, sms;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].device == dev && cache[i].smem == smem) {
      *n_sm = cache[i].sms;
      return cache[i].blocks;
    }
  }
  int blocks = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attend_cur_kernel, kCurThreads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  if (used < 16) cache[used++] = Entry{dev, smem, blocks, sms};
  *n_sm = sms;
  return blocks;
}

// One launch through cudaLaunchKernelEx with one attribute (cluster
// dimension or cooperative).
int launch(void (*fn)(Call), const Call& a, int grid, int threads, int smem,
           const cudaLaunchAttribute& attr, cudaStream_t st) {
  const int e = raise_smem(reinterpret_cast<const void*>(fn), smem);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1] = {attr};
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  // Reading the last error clears it: a refused launch must not fail the next one.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)last;
}

bool common_ok(const Call& a) {
  return a.G >= 1 && a.D % kDh == 0 && a.D >= kDh && a.rows >= 1 && a.rows <= a.S &&
         a.chunk >= 1 && a.nc == (a.rows + a.chunk - 1) / a.chunk &&
         reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && reinterpret_cast<uintptr_t>(a.K) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.V) % 16 == 0;
}

template <class KV, int MODE>
int attend_slice(Call a, cudaStream_t st) {
  a.H = a.D / kDh;
  a.nc = a.chunk > 0 ? (a.rows + a.chunk - 1) / a.chunk : 0;
  const bool ok = common_ok(a) && a.chunk == Slice<KV>::kChunk &&
                  (long long)a.G * a.H * kCluster < (1LL << 31) &&
                  slice_smem<KV>(slice_rows(a.nc, a.chunk)) <= 227 * 1024 &&
                  (MODE == kBf16 || (a.sk && a.sv));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return launch(attend_slice_kernel<KV, MODE>, a, a.G * a.H * kCluster, kSliceThreads,
                slice_smem<KV>(slice_rows(a.nc, a.chunk)), attr, st);
}

int attend_cur(Call a, cudaStream_t st) {
  a.H = a.D / kDh;
  a.nc = a.chunk > 0 ? (a.rows + a.chunk - 1) / a.chunk : 0;
  if (!common_ok(a) || a.chunk != kCurChunk || a.D % 256 || a.D > kCurMaxD || !a.ws || !a.bar ||
      (long long)a.G * a.nc >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = cur_smem(a.D);
  int e = raise_smem(reinterpret_cast<const void*>(attend_cur_kernel), smem);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  int n_sm = 0;
  const int per_sm = cur_blocks_per_sm(smem, &n_sm);
  if (per_sm < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
  }
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  return launch(attend_cur_kernel, a, std::min(a.G * a.nc, per_sm * n_sm), kCurThreads, smem,
                attr, st);
}

Call make_call(const void* q, const void* k, const void* v, const float* sk, const float* sv,
               float* out, int G, int S, int D, int rows, float inv, int chunk,
               unsigned long long* stamps) {
  Call a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.K = k, a.V = v, a.sk = sk, a.sv = sv, a.out = out, a.stamps = stamps;
  a.G = G, a.S = S, a.D = D, a.rows = rows, a.chunk = chunk, a.inv = inv;
  return a;
}

}  // namespace

// q [G, D] bf16; k, v [G, S, D] (bf16, or int8 for the i8 modes); sk, sv
// [G, S] float32 (the i8 modes' per-row scales); out [G, D] float32, to which
// the attend over rows [0, rows) is added; chunk: rows a chunk (the plan's);
// stamps: null, or [blocks, 6] uint64 for the phase stamps; cur also takes
// ws, the launch's workspace (float32 words, probe_attend.workspace_words),
// and bar, the device's barrier word (zeroed once, reused by every launch).
extern "C" int magpie_probe_attend_tr(const void* q, const void* k, const void* v, float* out,
                                      int G, int S, int D, int rows, float inv, int chunk,
                                      unsigned long long* stamps, void* stream) {
  return attend_slice<__nv_bfloat16, kBf16>(
      make_call(q, k, v, nullptr, nullptr, out, G, S, D, rows, inv, chunk, stamps),
      static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_attend_i8mixed(const void* q, const void* k, const void* v,
                                           const float* sk, const float* sv, float* out, int G,
                                           int S, int D, int rows, float inv, int chunk,
                                           unsigned long long* stamps, void* stream) {
  return attend_slice<signed char, kMixed>(
      make_call(q, k, v, sk, sv, out, G, S, D, rows, inv, chunk, stamps),
      static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_attend_i8cast(const void* q, const void* k, const void* v,
                                          const float* sk, const float* sv, float* out, int G,
                                          int S, int D, int rows, float inv, int chunk,
                                          unsigned long long* stamps, void* stream) {
  return attend_slice<signed char, kCast>(
      make_call(q, k, v, sk, sv, out, G, S, D, rows, inv, chunk, stamps),
      static_cast<cudaStream_t>(stream));
}
extern "C" int magpie_probe_attend_cur(const void* q, const void* k, const void* v, float* out,
                                       int G, int S, int D, int rows, float inv, int chunk,
                                       float* ws, unsigned* bar, unsigned long long* stamps,
                                       void* stream) {
  Call a = make_call(q, k, v, nullptr, nullptr, out, G, S, D, rows, inv, chunk, stamps);
  a.ws = ws, a.bar = bar;
  return attend_cur(a, static_cast<cudaStream_t>(stream));
}
