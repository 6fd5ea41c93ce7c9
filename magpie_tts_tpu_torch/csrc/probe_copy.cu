// Kernels 15-17: the H100 counterparts of the TPU's launch-cost probes,
// scripts/opt_slope_probe.py probe_minimal (a copy kernel at grid 8) and
// probe_constblk (the same plus 10 constant bf16 weight blocks, 2.02 MB, read
// on every call), and scripts/opt_launch_probe.py minimal_probe (the copy
// kernel at grid 1 / 8 / 20, optionally streaming a [grid_n, 512, 1024] bf16
// block, 1 MB per grid step).
//
// What it computes: out = x + (grid_n - 1) in bf16 (what the TPU kernel's
// last grid step writes; the streamed form adds w[grid_n - 1, 0, 0]
// instead), and cs[i] for each TPU grid step i, the XOR of every 32-bit word
// that step reads: words [i * n / grid_n, (i + 1) * n / grid_n) of x (bf16
// pairs) and of every constant block, and slab i of the streamed weight
// (exact and independent of order; the plain version computes the same).
//
// What bounds it on the card: the bytes of the constant blocks and the
// slabs, and below them the launch. [32, 768] bf16 in and out is 98 KB
// (0.03 us at 3.35 TB/s); the constant blocks add 2.02 MB (0.63 us), the
// streamed slabs 8 MB at grid 8 (2.5 us). A launch in a CUDA-graph chain
// costs ~1 us by itself (a 49 KB torch.add takes 1.05 us). The probe exists
// to measure that cost and what the weights add to it, so what it adds of
// its own has to be one round trip of reads and little code: at this size
// the instructions a launch runs are most of its time, and a loop unrolled
// wider, or a branch for an unused option, costs more than its arithmetic.
//
// The design. The TPU runs its grid steps in order on one core; the CUDA
// grid is not grid_n. A step is a thread-block cluster of C CTAs, C from the
// plan (ops/kernels/probe_copy.py plan_copy, mirrored by plan_ctas below): a
// function of the bytes a step reads, the fewest CTAs that read at most
// kCtaBytes each, at most kMaxCtas (the portable cluster; a launch takes up
// to 16 for sweeps, and 16-CTA clusters did not all fit on the card at
// once). Grid (C, grid_n): at the probe's shapes 2 x 1 at grid 1, 1 x 8 and
// 1 x 20 for the plain copies (a step's 6 KB or 2.4 KB), 8 x 8 = 64 CTAs for
// the constant blocks (258 KB a step) and for the streamed slabs (1 MB).
// Four instantiations, by whether there are other segments and whether C >
// 1, so that a plain copy runs none of the code of the others.
// - x: CTA r of a step adds to and stores the r-th contiguous C-th of the
//   step's share, as 16-byte vectors, 8 loads a thread issued before any is
//   used, or, where the share does not start and end on a vector (grid 20),
//   as 32-bit words, 4 a batch.
// - The other segments (the constant blocks, or the step's slab): their
//   step shares' aligned vectors, one segment after another, make one run;
//   CTA r reads the r-th C-th of the run, so a CTA reads a few long pieces
//   and not a sliver of every block (the ten blocks hold four of 4 KB).
//   Lane s of warp 0 finds segment s's share and, by a scan, where it starts
//   in the run. Each thread copies its vectors (every 256th) by 16-byte
//   cp.async into its own slots of shared memory, all before x's loads, and
//   XORs them once they land: no register waits on a load while the others
//   issue, and no barrier of the CTA. The (< 4) words of a segment before
//   its first vector and after its last go to rank 0, a word a thread.
//   Measured beside it on the card, and not kept: the same run read by
//   unrolled 16-byte ld.global.nc batches walking the segments, and by
//   cp.async.bulk (the tensor memory accelerator) into a staging buffer on
//   transaction barriers, both with a sliver of every segment a CTA.
// - The CTA's XOR (redux.sync in each warp, then in warp 0 over the warps)
//   goes to rank 0 by one 4-byte st.async onto rank 0's transaction barrier,
//   and the CTA exits; rank 0 XORs the ranks' words in rank order and writes
//   cs[i]. No atomics, no workspace; XOR is exact in any order, so the bits
//   do not depend on C.
// - Optional phase stamps (null in every ordinary launch): thread 0 of CTA
//   (r, i) writes %globaltimer to stamps[(i * C + r) * 5 + s] at 0 its
//   start, 1 its share of x stored, 2 its reads XORed, 3 the other ranks'
//   words landed (ranks above 0: theirs pushed), 4 its end.

#include <algorithm>

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kXLoads = 8;         // 16-byte loads of x a thread issues before it uses one
constexpr int kWordLoads = 4;      // the same, 32-bit loads of a share not whole vectors
constexpr int kMaxConst = 16;
constexpr int kMaxSegs = kMaxConst + 2;  // x, the constant blocks, the slab
constexpr int kCtaBytes = 32768;   // the plan: the most bytes a CTA of a step reads
constexpr int kMaxCtas = 8;        // the plan's most CTAs a step (the portable cluster)
constexpr int kMaxCluster = 16;    // the most a launch takes (non-portable above 8)
constexpr int kCopyStamps = 5;
constexpr int kEdge = 6;           // unaligned words a segment can have: 3 before, 3 after
constexpr int kMaxSlots = 32;      // 16-byte staging slots a thread, at most (128 KB a CTA)
// A step's share of a segment: words [lo, hi), unaligned words [lo, head)
// and [tail, hi), this CTA's vectors [cva, cvz).
enum Seg { kLo, kHi, kHead, kTail, kCva, kCvz, kSegFields };
// A row of the segment table: the segment's first virtual vector in its
// step's run, its end there, its step share's first vector, its base.
enum Row { kRowOff, kRowEnd, kRowVa, kRowBase, kRowFields };

// Division by a launch-wide divisor d (grid_n, or the CTAs a step) as a
// multiply and a shift (Granlund and Montgomery; the host finds them), exact
// for a dividend below 2^31: a division is a long chain of instructions on
// the card, and a CTA's shares take eight of them in a row.
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv fast_div(unsigned d) {
  if (d == 1) return FastDiv{1u, 0u, 0u};
  unsigned l = 0;
  while ((1ull << l) < d) ++l;  // ceil(log2(d))
  const unsigned p = 31 + l;
  return FastDiv{d, (unsigned)(((1ull << p) + d - 1) / d), p - 32};
}

// The launch's arguments; the kernel reads the scalars into registers at its
// start, and the arrays where it needs them.
struct CopyCall {
  unsigned* out;
  unsigned* cs;
  unsigned long long* stamps;
  const unsigned* add_from;       // the streamed slab's w[grid_n - 1, 0, 0] word, or null
  FastDiv by_g, by_c;             // division by grid_n and by the CTAs a step
  int nseg, slab_seg;             // segments; the slab's (the last) or -1
  int slots;                      // 16-byte staging slots a thread (dynamic shared memory)
  const unsigned* ptr[kMaxSegs];  // segment 0: x; then the constant blocks; the slab last
  long long words[kMaxSegs];      // their words (the slab: one step's)
};

// The plan's CTAs a step for a step that reads step_words 32-bit words.
int plan_ctas(long long step_words) {
  const long long c = (step_words * 4 + kCtaBytes - 1) / kCtaBytes;
  return c < 1 ? 1 : c > kMaxCtas ? kMaxCtas : (int)c;
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int s) {
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kCopyStamps + s] = global_ns();
  }
}

__device__ __forceinline__ unsigned add_pair(unsigned word, float add) {
  const float lo = __uint_as_float(word << 16) + add;
  const float hi = __uint_as_float(word & 0xffff0000u) + add;
  const unsigned short l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return (unsigned)l | ((unsigned)h << 16);
}

// 16 bytes from global memory into shared memory, asynchronously: the copy
// holds no register and waits on nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// a * b / d for non-negative operands: a multiply and a shift when the
// product is below 2^31, else a 64-bit division.
__device__ __forceinline__ long long mul_div(long long a, long long b, const FastDiv& f) {
  const unsigned long long p = (unsigned long long)a * (unsigned long long)b;
  if (p >= 0x80000000ull) return (long long)(p / f.d);
  return f.d == 1 ? (long long)p : (long long)(__umulhi((unsigned)p, f.mul) >> f.shr);
}

// 4 bytes into CTA `rank`'s shared memory: one word at this CTA's address p,
// counted on that CTA's transaction barrier at this CTA's address bar.
__device__ __forceinline__ void st_async_word(unsigned* p, unsigned v, unsigned long long* bar,
                                              int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(b), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   ra),
               "r"(v), "r"(rb)
               : "memory");
}

// Step i's share of a segment of n words (a slab: n words a step, slab i),
// the unaligned words at its ends and, with kSplit, CTA r of C's contiguous
// C-th of the aligned 16-byte vectors between them (without, all of them).
template <bool kSplit>
__device__ __forceinline__ void segment_share(long long (&s)[kSegFields], long long n, bool slab,
                                              int i, int r, const FastDiv& by_g,
                                              const FastDiv& by_c) {
  const long long lo = slab ? i * n : mul_div(i, n, by_g);
  const long long hi = slab ? (i + 1) * n : mul_div(i + 1, n, by_g);
  const long long up = (lo + 3) & ~3LL, down = hi & ~3LL;
  const long long nv = max(0LL, down - up) / 4;
  s[kLo] = lo;
  s[kHi] = hi;
  s[kHead] = min(up, hi);
  s[kTail] = max(down, s[kHead]);
  s[kCva] = up / 4 + (kSplit ? mul_div(r, nv, by_c) : 0);
  s[kCvz] = up / 4 + (kSplit ? mul_div(r + 1, nv, by_c) : nv);
}

__device__ __forceinline__ uint4 add4(uint4 v, float add) {
  return make_uint4(add_pair(v.x, add), add_pair(v.y, add), add_pair(v.z, add),
                    add_pair(v.w, add));
}

// Grid (C, grid_n), clusters of (C, 1, 1) when C > 1, kThreads threads;
// dynamic shared memory slots x 4 KB when there are other segments. kMore:
// segments besides x (the constant blocks or the slab); kCluster: C > 1. A
// plain copy runs none of their code: at this size what a launch executes is
// most of its cost.
template <bool kMore, bool kCluster>
__global__ void __launch_bounds__(kThreads) probe_copy_kernel(CopyCall a) {
  extern __shared__ __align__(16) uint4 staged[];  // kMore: [slots][kThreads]
  __shared__ long long table[kMore ? kMaxSegs : 1][kRowFields];  // kMore: the other segments
  __shared__ unsigned red[kThreads / 32];
  __shared__ unsigned parts[kMaxCluster];  // rank 0: the other ranks' XORs
  __shared__ __align__(8) unsigned long long landed;
  const int tid = threadIdx.x, i = blockIdx.y, r = blockIdx.x;
  // every parameter this thread reads first, at once
  unsigned long long* const stamps = a.stamps;
  unsigned* const out = a.out;
  unsigned* const cs = a.cs;
  const unsigned* const add_from = a.add_from;
  const FastDiv by_g = a.by_g, by_c = a.by_c;
  const int nseg = a.nseg, slab_seg = a.slab_seg, slots = a.slots;
  const long long x_words = a.words[0];
  const unsigned* const x = a.ptr[0];
  stamp(stamps, 0);
  if (kCluster) {
    if (r == 0 && tid == 0) {
      mbar_init(&landed, 1);
      mbar_arrive_expect_tx(&landed, (gridDim.x - 1) * 4);
      fence_mbar_init();
    }
    cluster_arrive_started();
  }
  const float add = kMore && add_from != nullptr ? __uint_as_float(__ldg(add_from) << 16)
                                                 : (float)(gridDim.y - 1);

  // The other segments as one run of 16-byte vectors: each one's step share
  // in order. Lane s of warp 0 finds segment s's share and, by a scan over
  // the lanes, where it starts in the run; CTA r reads the run's r-th C-th
  // [v, w1), its threads every kThreads-th vector: v, the thread's next, in
  // segment s, which ends at end. A round copies as many as the thread's
  // slots hold by 16-byte cp.async, issued before x's loads, and XORs them
  // after.
  __shared__ long long run_total;
  if (kMore) {
    if (tid < 32) {
      long long sh[kSegFields] = {0, 0, 0, 0, 0, 0};
      if (tid > 0 && tid < nseg) {
        segment_share<false>(sh, a.words[tid], tid == slab_seg, i, r, by_g, by_c);
      }
      const long long nv = sh[kCvz] - sh[kCva];
      long long incl = nv;
      for (int o = 1; o < 32; o <<= 1) {
        const long long up = __shfl_up_sync(MAGPIE_FULL_MASK, incl, o);
        if (tid >= o) incl += up;
      }
      if (tid > 0 && tid < nseg) {
        table[tid][kRowOff] = incl - nv;
        table[tid][kRowEnd] = incl;
        table[tid][kRowVa] = sh[kCva];
        table[tid][kRowBase] = reinterpret_cast<long long>(a.ptr[tid]);
      }
      if (tid == 31) run_total = incl;
    }
    __syncthreads();
  }
  int s = 1;
  long long v = 0, w1 = 0, end = 0, delta = 0;
  const uint4* seg_base = nullptr;  // vector v is seg_base[v + delta]
  auto settle = [&]() {
    if (v >= w1) {
      s = nseg;
    } else if (v >= end) {
      while (v >= table[s][kRowEnd]) ++s;
      end = table[s][kRowEnd];
      delta = table[s][kRowVa] - table[s][kRowOff];
      seg_base = reinterpret_cast<const uint4*>(table[s][kRowBase]);
    }
  };
  auto issue_round = [&]() {
    int k = 0;
    for (; k < slots && s < nseg; ++k) {
      cp_async16(&staged[k * kThreads + tid], seg_base + (v + delta));
      v += kThreads;
      settle();
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    return k;
  };
  int copied = 0;
  if (kMore) {
    v = mul_div(r, run_total, by_c) + tid;
    w1 = mul_div(r + 1, run_total, by_c);
    settle();
    copied = issue_round();
  }

  // x: its share in registers, every word added to and stored once. A
  // share that starts and ends on 16-byte vectors goes as vectors, kXLoads a
  // batch; another as 32-bit words, kWordLoads a batch.
  unsigned acc = 0;
  {
    long long xs[kSegFields];
    segment_share<kCluster>(xs, x_words, false, i, r, by_g, by_c);
    if (((xs[kLo] | xs[kHi]) & 3) == 0) {
      const uint4* x4 = reinterpret_cast<const uint4*>(x);
      uint4* out4 = reinterpret_cast<uint4*>(out);
      for (long long q0 = xs[kCva] + tid; q0 < xs[kCvz]; q0 += kThreads * kXLoads) {
        uint4 v[kXLoads];
#pragma unroll
        for (int u = 0; u < kXLoads; ++u) {
          if (q0 + u * kThreads < xs[kCvz]) v[u] = __ldg(x4 + q0 + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kXLoads; ++u) {
          if (q0 + u * kThreads < xs[kCvz]) {
            acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
            out4[q0 + u * kThreads] = add4(v[u], add);
          }
        }
      }
    } else {
      const long long n = xs[kHi] - xs[kLo];
      const long long w1 = kCluster ? xs[kLo] + mul_div(r + 1, n, by_c) : xs[kHi];
      for (long long w0 = (kCluster ? xs[kLo] + mul_div(r, n, by_c) : xs[kLo]) + tid; w0 < w1;
           w0 += kThreads * kWordLoads) {
        unsigned v[kWordLoads];
#pragma unroll
        for (int u = 0; u < kWordLoads; ++u) {
          if (w0 + u * kThreads < w1) v[u] = __ldg(x + w0 + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kWordLoads; ++u) {
          if (w0 + u * kThreads < w1) {
            acc ^= v[u];
            out[w0 + u * kThreads] = add_pair(v[u], add);
          }
        }
      }
    }
  }
  stamp(stamps, 1);

  if (kMore) {
    // Rank 0: the other segments' unaligned words, one a thread.
    if (r == 0 && tid < (nseg - 1) * kEdge) {
      const int es = 1 + tid / kEdge, e = tid % kEdge;
      long long sh[kSegFields];
      segment_share<false>(sh, a.words[es], es == slab_seg, i, r, by_g, by_c);
      const long long w = e < 3 ? sh[kLo] + e : sh[kTail] + e - 3;
      if (w < (e < 3 ? sh[kHead] : sh[kHi])) acc ^= __ldg(a.ptr[es] + w);
    }
    // The staged vectors, round after round; a thread reads only its own
    // slots, so no barrier of the CTA is needed.
    for (;;) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      for (int k = 0; k < copied; ++k) {
        const uint4 t = staged[k * kThreads + tid];
        acc ^= t.x ^ t.y ^ t.z ^ t.w;
      }
      if (s >= nseg) break;
      copied = issue_round();
    }
  }

  // The CTA's XOR (a warp's, then warp 0's over the warps'), then the
  // cluster's in rank 0.
  acc = __reduce_xor_sync(MAGPIE_FULL_MASK, acc);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) acc = __reduce_xor_sync(MAGPIE_FULL_MASK, tid < kThreads / 32 ? red[tid] : 0u);
  stamp(stamps, 2);
  if (kCluster) {
    cluster_wait_started();
    if (r != 0) {
      if (tid == 0) st_async_word(&parts[r - 1], acc, &landed, 0);
      stamp(stamps, 3);
      stamp(stamps, 4);
      return;
    }
    if (tid == 0) {
      mbar_wait(&landed, 0);
      for (int k = 0; k < (int)gridDim.x - 1; ++k) acc ^= parts[k];
    }
  }
  stamp(stamps, 3);
  if (tid == 0) cs[i] = acc;
  stamp(stamps, 4);
}

// ctas 0: the plan's.
int launch(CopyCall a, long long n_words, int grid_n, int ctas, void* stream) {
  if (n_words < 1 || n_words > INT_MAX || grid_n < 1 || grid_n > 65535 || a.nseg < 1 ||
      a.nseg > kMaxSegs || ctas < 0 || ctas > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  long long step_words = 0;
  for (int j = 0; j < a.nseg; ++j) {
    if (a.words[j] < 1 || reinterpret_cast<uintptr_t>(a.ptr[j]) % 16) {
      return (int)cudaErrorInvalidValue;
    }
    step_words += j == a.slab_seg ? a.words[j] : (a.words[j] + grid_n - 1) / grid_n;
  }
  if (reinterpret_cast<uintptr_t>(a.out) % 16) return (int)cudaErrorInvalidValue;
  if (ctas == 0) ctas = plan_ctas(step_words);
  a.by_g = fast_div((unsigned)grid_n);
  a.by_c = fast_div((unsigned)ctas);
  if (a.slab_seg >= 0) {
    a.add_from = a.ptr[a.slab_seg] + (long long)(grid_n - 1) * a.words[a.slab_seg];
  }
  const bool more = a.nseg > 1;
  if (more) {
    // the staging slots: a thread's vectors of the other segments at most (a
    // step's run, a C-th of it and a kThreads-th of that), at most kMaxSlots
    long long run = 0;
    for (int j = 1; j < a.nseg; ++j) {
      run += (j == a.slab_seg ? a.words[j] : (a.words[j] + grid_n - 1) / grid_n) / 4;
    }
    const long long window = (run + ctas - 1) / ctas;
    a.slots = (int)std::max(1LL, std::min((long long)kMaxSlots,
                                          (window + kThreads - 1) / kThreads));
  }
  void (*kernel)(CopyCall) = more ? (ctas > 1 ? probe_copy_kernel<true, true>
                                              : probe_copy_kernel<true, false>)
                                  : (ctas > 1 ? probe_copy_kernel<false, true>
                                              : probe_copy_kernel<false, false>);
  if (more) {
    const int e = raise_smem(reinterpret_cast<const void*>(kernel), a.slots * kThreads * 16);
    if (e != 0) {
      cudaGetLastError();
      return e;
    }
  }
  if (ctas > kMaxCtas) {  // a cluster above the portable 8 CTAs (sweeps only)
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, grid_n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = more ? a.slots * kThreads * 16 : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ctas;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  // Reading the last error clears it: a refused launch must not fail the next one.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)last;
}

// The call of every entry point: x, then n_const constant blocks (ptrs[j]:
// words[j] words), then the slab [grid_n, slab_words] words (null: none).
CopyCall make_call(const void* x, void* out, void* cs, long long n_words,
                   const void* const* ptrs, const long long* words, int n_const,
                   const void* slab, long long slab_words, unsigned long long* stamps) {
  CopyCall a{};
  a.out = static_cast<unsigned*>(out);
  a.cs = static_cast<unsigned*>(cs);
  a.stamps = stamps;
  a.ptr[0] = static_cast<const unsigned*>(x);
  a.words[0] = n_words;
  a.nseg = 1;
  a.slab_seg = -1;
  for (int j = 0; j < n_const && j < kMaxConst; ++j, ++a.nseg) {
    a.ptr[a.nseg] = static_cast<const unsigned*>(ptrs[j]);
    a.words[a.nseg] = words[j];
  }
  if (slab != nullptr) {
    a.ptr[a.nseg] = static_cast<const unsigned*>(slab);
    a.words[a.nseg] = slab_words;
    a.slab_seg = a.nseg++;
  }
  return a;
}

}  // namespace

// x / out: n_words 32-bit words of bf16 pairs, 16-byte aligned; cs [grid_n]
// uint32 (the XOR of the words each TPU grid step reads).
extern "C" int magpie_probe_copy(const void* x, void* out, void* cs, long long n_words,
                                 int grid_n, void* stream) {
  return launch(make_call(x, out, cs, n_words, nullptr, nullptr, 0, nullptr, 0, nullptr),
                n_words, grid_n, 0, stream);
}
// The same plus n_const constant blocks (ptrs[j]: words[j] 32-bit words,
// 16-byte aligned), each read once per call, split over the grid_n steps.
extern "C" int magpie_probe_copy_const(const void* x, void* out, void* cs, long long n_words,
                                       int grid_n, const void* const* ptrs,
                                       const long long* words, int n_const, void* stream) {
  if (n_const < 0 || n_const > kMaxConst) return (int)cudaErrorInvalidValue;
  return launch(make_call(x, out, cs, n_words, ptrs, words, n_const, nullptr, 0, nullptr),
                n_words, grid_n, 0, stream);
}
// The copy at grid_n steps with a streamed weight slab [grid_n, slab_words]
// words (16-byte aligned): step i reads slab i.
extern "C" int magpie_probe_copy_streamed(const void* x, void* out, void* cs, long long n_words,
                                          int grid_n, const void* slab, long long slab_words,
                                          void* stream) {
  if (!slab) return (int)cudaErrorInvalidValue;
  return launch(make_call(x, out, cs, n_words, nullptr, nullptr, 0, slab, slab_words, nullptr),
                n_words, grid_n, 0, stream);
}
// Any variant with the CTAs a step given (0: the plan's; 1 to 16, for
// sweeps) and optional phase stamps (null or [grid_n * ctas, 5] uint64).
extern "C" int magpie_probe_copy_ctas(const void* x, void* out, void* cs, long long n_words,
                                      int grid_n, const void* const* ptrs,
                                      const long long* words, int n_const, const void* slab,
                                      long long slab_words, int ctas,
                                      unsigned long long* stamps, void* stream) {
  if (n_const < 0 || n_const > kMaxConst || (n_const > 0 && slab != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(make_call(x, out, cs, n_words, ptrs, words, n_const, slab, slab_words, stamps),
                n_words, grid_n, ctas, stream);
}
