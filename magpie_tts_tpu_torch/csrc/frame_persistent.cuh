// Kernels A, 4 and 5 as one persistent, cooperative launch a frame.
//
// Replaces, for one stream, the TPU kernels
// magpie_tts_tpu/ops/pallas_kernels/frame_step.py (frame_step_pallas: LT
// sampling of the 8 codes, the frame embedding, the 12 cached decoder layers),
// magpie_tts_tpu/ops/pallas_kernels/lt_sampler.py (sample_frame_codes_pallas:
// the LT sampling alone; lt_persistent_kernel, A's LT phases without the
// seam and the decoder) and magpie_tts_tpu/ops/pallas_kernels/decoder_step.py
// (decode_step_pallas: the decoder layers from a frame embedding), with their
// dense float32 / bfloat16, int8-column and Q8_0-block weight streams.
//
// What bounds a frame on the card: ~392 MB of float32 weights and cache rows
// read once (0.117 ms at 3.35 TB/s; half in bf16, a quarter for the streamed
// matrices of int8 / Q8_0), with ~2 flops a byte. The launch sequence this
// replaces (frame_sequence.cuh: ~260 launches for A, 157 for 5) sat far
// above that: each GEMV near a launch's fixed cost, 60 one-block reducers,
// a host enqueue of every launch. Here one cooperative launch of one block
// an SM (kBlocksPerSm: two measured slower, their barriers and redundant
// reads cost more than their extra tiles gain) walks a fixed
// phase table; blocks meet at a grid barrier (a monotonic arrival count in
// the call's workspace) where a phase needs another block's result:
// - a product x[K] @ W[K, N] is cut into tiles of kTileCols columns (64
//   bytes a row in float32, 32 in bf16), dealt round-robin to the blocks;
//   inside a block 64 row groups split K, each thread sums its rows of four
//   columns in order with fmaf, and the groups are reduced by a fixed
//   butterfly and then the 8 warps in order. A column's sum order therefore
//   depends on (K, N) and the plan's split only: not on the grid, the dtype
//   or the weight stream, so a Q8_0 stream keeps the bits of dense on its
//   dequantized weights and a 66-block grid gives the bits of a 132-block
//   one. The narrow products (N <= 256: xa_q and the LT's in_proj, sa_out,
//   ff_out) may split K across blocks (the plan's split); their consumers
//   sum the partials in order.
// - a thread stages its weight rows through its own slots of a shared-memory
//   ring with cp.async (kRing - 1 rows in flight: 60 KB a block in float32).
//   Nothing is prefetched into L2 across the barriers: a prefetch of the
//   next products' weights (cp.async.bulk.prefetch.L2 or by line, at a
//   phase's start or before its barrier) and of the attention's rows
//   measured slower or no faster (PERF.md).
// - the reducers are gone: after the barrier that follows a product, every
//   block redundantly sums its partials and adds the residual (x lives in
//   every block's shared memory); the blocks with tiles in the next product
//   run the LayerNorm of the row (or load its input row) and feed their
//   tiles. The qkv tile writes q and the new K / V cache row; ff_proj's tile
//   applies GELU; int8 column scales are applied after a tile's sum. Every
//   row a prologue reads is loaded with all its loads issued first (one L2
//   round trip, not one an element).
// - attention runs frame_kernels.cuh's items (attn_scores_item, a barrier,
//   attn_pv_item, a barrier): the row chunks of plan_attention and the
//   two-step numerics of the separate attention launches; the
//   consumer sums the chunk partials in chunk order, so the outputs have the
//   bits of the separate launches for the same inputs.
// - kernel A's 8 LT phases run before the decoder layers: every block
//   samples redundantly from the logits in L2 (block_sample: argmax, exact
//   top-k by radix select, Gumbel-max), so every block knows the code and the
//   next phase starts without a broadcast barrier; the LT attention (at most
//   16 rows) runs redundantly too, in every block with tiles in the product
//   after it, and so does the cross-attention when its rows fit one chunk
//   (32 rows at d_head 128).
// Barriers: 6 an LT phase, 8 a decoder layer (10 when the cross-attention
// takes more than one chunk) (plan_frame in
// ops/kernels/frame_step.py counts them; the phase stamps count them on the
// card). Rounding points (rnd<T>) are frame_kernels.cuh's.

#pragma once

#include "frame_sequence.cuh"

namespace {

constexpr int kPThreads = 256;                            // threads of a persistent block
constexpr int kTileCols = 16;                             // columns of a product tile
constexpr int kRowGroups = kPThreads / (kTileCols / 4);   // 64 K-groups of a tile
constexpr int kRing = 16;                                 // cp.async slots of a thread
constexpr int kMaxSplit = 8;                              // most K splits of a product
constexpr int kOneChunkRows = kAttnMaxChunk;              // rows of a one-chunk attention
constexpr int kBlocksPerSm = 1;                           // the grid: blocks an SM

// Phase-stamp kinds: what a phase's prologue and work were (chip_profile.py).
enum { kProNone = 0, kProLN = 1, kProSample = 2, kProAttn = 3 };
enum { kWorkNone = 0, kWorkGemv = 1, kWorkAttn = 2 };

// Arguments of the persistent frame kernel: the frame (FrameSeq, one slot)
// and what the persistent design adds.
template <class T>
struct Persist {
  FrameSeq<T> s;
  float* part2;                // the second partial buffer (products alternate)
  unsigned* bar;               // the barrier's arrival count, zeroed before the launch
  unsigned long long* stamps;  // optional: [records, then 4 words a phase]
  int stamp_cap;               // phases the stamp buffer holds
  int split_lt_in, split_lt_sa, split_lt_ff, split_xa_q;
};

// Shared memory of a block, in 4-byte words (16-byte granules).
struct PSmem {
  int xs, xd, lx, eacc, lg, qs, red, pr, grp, lsc, gred, hist, redi, ring, words;
};

__host__ __device__ inline int psmem_take(int& o, int n) {
  const int r = o;
  o += (n + 3) & ~3;
  return r;
}

// kmax: the widest product input (max of D, F, LT, LF, X).
__host__ __device__ inline PSmem psmem_layout(int kmax, int D, int LT, int V) {
  PSmem m;
  int o = 0;
  m.xs = psmem_take(o, kmax);   // a product's input row (rounded to T)
  m.xd = psmem_take(o, D);      // the decoder's residual x
  m.lx = psmem_take(o, LT);     // the LT's residual
  m.eacc = psmem_take(o, D);    // the sum of the frame's code embeddings
  m.lg = psmem_take(o, V);      // an LT phase's logits
  m.qs = psmem_take(o, kAttnMaxDHead);
  m.red = psmem_take(o, 32);
  m.pr = psmem_take(o, kAttnMaxChunk);
  m.grp = psmem_take(o, kAttnThreads * 8);
  m.lsc = psmem_take(o, kOneChunkRows);
  m.gred = psmem_take(o, 2 * 8 * kTileCols);  // a tile's warp sums, double-buffered
  m.hist = psmem_take(o, 256);
  m.redi = psmem_take(o, 32);
  m.ring = psmem_take(o, kRing * kPThreads * 4);
  m.words = o;
  return m;
}

// Rows of one K split of a product: a multiple of the row groups.
__host__ __device__ inline int split_rows(int K, int S) {
  return ((K + S - 1) / S + kRowGroups - 1) / kRowGroups * kRowGroups;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The grid barrier: a monotonic arrival count. Thread 0 of every block
// makes the block's writes visible at gpu scope (fence.acq_rel), adds one
// (a relaxed red, no round trip), and spins with acquire loads until the
// count reaches this barrier's target, `target` += the grid each time; no
// block resets anything, so one pass is one atomic and the polls. A wait
// past 2 s traps: a deadlock is a launch error, not a hang. bar lives in the
// call's workspace, zeroed before the launch, so two frames on two streams
// never share one.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
    if (ld_acquire(bar) < target) {
      const unsigned long long t0 = global_ns();
      unsigned spins = 0;
      while (ld_acquire(bar) < target) {
        if ((++spins & 1023u) == 0 && global_ns() - t0 > 2000000000ull) __trap();
      }
    }
  }
  __syncthreads();
}

// The count a launch starts from: a whole number of passes of this grid
// (0 after the wrapper's zeroing; the probe reuses its words launch after
// launch). Read before the first arrival, when the count can be at most
// gridDim.x - 1 past it.
__device__ __forceinline__ unsigned barrier_base(const unsigned* bar) {
  return ld_acquire(bar) / gridDim.x * gridDim.x;
}

// The barrier probe: n grid barriers and nothing else (its graph slope over
// n is the cost of one barrier at this grid).
__global__ void __launch_bounds__(kPThreads) barrier_probe_kernel(unsigned* bar, int n) {
  unsigned target = 0u;
  if (threadIdx.x == 0) target = barrier_base(bar);
  for (int i = 0; i < n; ++i) grid_sync(bar, target);
}

template <class T, int MODE, bool kLT>
struct Frame {
  const Persist<T>& p;
  const FrameSeq<T>& s;
  float *xs, *xd, *lx, *eacc, *lg, *qs, *lsc, *gred;
  AttnSmem am;
  int *hist, *redi;
  uint4* ring;
  unsigned target;  // thread 0: the arrival count the next barrier waits for
  int nrec, pro_kind;
  unsigned long long t_start, t_pro;

  __device__ Frame(const Persist<T>& p_, float* sm) : p(p_), s(p_.s) {
    const int kmax = max(max(max(s.D, s.F), max(s.LT, s.LF)), s.X);
    const PSmem m = psmem_layout(kmax, s.D, s.LT, s.V);
    xs = sm + m.xs, xd = sm + m.xd, lx = sm + m.lx, eacc = sm + m.eacc, lg = sm + m.lg;
    qs = sm + m.qs, lsc = sm + m.lsc, gred = sm + m.gred;
    am = AttnSmem{sm + m.red, sm + m.pr, sm + m.grp};
    hist = reinterpret_cast<int*>(sm + m.hist);
    redi = reinterpret_cast<int*>(sm + m.redi);
    ring = reinterpret_cast<uint4*>(sm + m.ring);
    target = 0u;
    if (threadIdx.x == 0) target = barrier_base(p.bar);
    nrec = 0, pro_kind = kProNone;
    t_start = t_pro = stamping() ? global_ns() : 0ull;
  }

  __device__ bool stamping() const {
    return p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  }
  // The end of a phase's prologue (residual, LayerNorm, sampling, ...).
  __device__ void pro(int kind) {
    if (stamping()) t_pro = global_ns(), pro_kind = kind;
  }
  __device__ void record(int work_kind) {
    if (stamping() && nrec < p.stamp_cap) {
      unsigned long long* r = p.stamps + 1 + 4 * (size_t)nrec;
      r[0] = t_start, r[1] = t_pro, r[2] = global_ns();
      r[3] = (unsigned long long)(pro_kind | (work_kind << 4));
    }
    ++nrec;
  }

  __device__ void barrier(int work_kind) {
    record(work_kind);
    grid_sync(p.bar, target);
    if (stamping()) t_start = t_pro = global_ns(), pro_kind = kProNone;
  }

  // One 16-column tile of x @ W over rows [k0, k1): this thread's sum of
  // four columns over rows k0 + g, k0 + g + 64, ... (g = tid / 4), staged
  // through the thread's own ring slots (a thread reads only what it copied,
  // so the ring needs no block barrier).
  template <int M>
  __device__ float4 tile_sum(const WeightRef<T>& W, int N, int k0, int k1, int c0) {
    const int t = threadIdx.x, g = t >> 2;
    const int col = c0 + 4 * (t & 3);
    const int first = k0 + g;
    const int nrows = col < N && first < k1 ? (k1 - first + kRowGroups - 1) / kRowGroups : 0;
    uint4* slot = ring + t;
    const auto issue = [&](int j) {
      const size_t i = (size_t)(first + j * kRowGroups) * N + col;
      uint4* dst = slot + (j % kRing) * kPThreads;
      if constexpr (M == kStreamDense) {
        cp_async<4 * (int)sizeof(T)>(dst, W.w + i);
      } else {
        cp_async<4>(dst, W.q + i);
      }
    };
#pragma unroll
    for (int j = 0; j < kRing - 1; ++j) {
      if (j < nrows) issue(j);
      cp_async_commit();
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < nrows; ++j) {
      cp_async_wait<kRing - 2>();
      if (j + kRing - 1 < nrows) issue(j + kRing - 1);  // refills the slot read last time
      cp_async_commit();
      const int k = first + j * kRowGroups;
      const uint4* src = slot + (j % kRing) * kPThreads;
      float4 w;
      if constexpr (M == kStreamDense) {
        if constexpr (sizeof(T) == 4) {
          w = *reinterpret_cast<const float4*>(src);
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          w = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        }
      } else {
        const char4 q = *reinterpret_cast<const char4*>(src);
        w = make_float4((float)q.x, (float)q.y, (float)q.z, (float)q.w);
        if constexpr (M == kStreamQ8) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(W.s) +
                                  (size_t)(k >> 5) * (N >> 2) + (col >> 2));
          w.x = rnd<T>(sc.x * w.x);
          w.y = rnd<T>(sc.y * w.y);
          w.z = rnd<T>(sc.z * w.z);
          w.w = rnd<T>(sc.w * w.w);
        }
      }
      const float xv = xs[k];
      acc.x = fmaf(xv, w.x, acc.x);
      acc.y = fmaf(xv, w.y, acc.y);
      acc.z = fmaf(xv, w.z, acc.z);
      acc.w = fmaf(xv, w.w, acc.w);
    }
    cp_async_wait<0>();
    return acc;
  }

  // x (xs, K values) @ W [K, N]: tiles x S splits dealt round-robin over the
  // grid (item i on block i % grid); epi(split, column, sum) runs once for
  // every column of every split, on threads 0..15 of the item's block. A
  // column's sum: its thread's fmaf chain, the butterfly over the 8 row
  // groups of a warp, the 8 warps in order.
  template <int M, class Epi>
  __device__ void gemv(const WeightRef<T>& W, int K, int N, int S, const Epi& epi) {
    const int tiles = (N + kTileCols - 1) / kTileCols;
    const int kc = split_rows(K, S);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int parity = 0;
    for (int it = blockIdx.x; it < tiles * S; it += gridDim.x, parity ^= 1) {
      const int tile = it % tiles, sp = it / tiles;
      const int k0 = sp * kc, k1 = min(K, k0 + kc);
      float4 a = tile_sum<M>(W, N, k0, k1, tile * kTileCols);
      for (int o = 4; o < 32; o <<= 1) {
        a.x += __shfl_xor_sync(MAGPIE_FULL_MASK, a.x, o);
        a.y += __shfl_xor_sync(MAGPIE_FULL_MASK, a.y, o);
        a.z += __shfl_xor_sync(MAGPIE_FULL_MASK, a.z, o);
        a.w += __shfl_xor_sync(MAGPIE_FULL_MASK, a.w, o);
      }
      float* red = gred + parity * 8 * kTileCols;
      if (lane < 4) reinterpret_cast<float4*>(red + warp * kTileCols)[lane] = a;
      __syncthreads();
      const int c = tile * kTileCols + threadIdx.x;
      if (threadIdx.x < kTileCols && c < N) {
        float v = red[threadIdx.x];
        for (int w = 1; w < kPThreads / 32; ++w) v += red[w * kTileCols + threadIdx.x];
        epi(sp, c, v);
      }
    }
  }

  // Whether this block has items in a product N wide with S splits: only
  // those blocks need the product's input row (the prologue's LayerNorm,
  // attention output or loaded row); every block keeps the residual.
  __device__ bool has_items(int N, int S) const {
    return (int)blockIdx.x < (N + kTileCols - 1) / kTileCols * S;
  }

  // Rows of up to kRow4 * 4 * kPThreads floats moved with every load issued
  // before the first is used: one round trip, not one an element.
  static constexpr int kRow4 = 4;
  // dst[0:n] (+)= src[0:n], src written in this launch (n % 4 == 0).
  template <bool kAdd>
  __device__ static void take_row(float* dst, const float* src, int n) {
    float4 v[kRow4];
#pragma unroll
    for (int i = 0; i < kRow4; ++i) {
      const int j = threadIdx.x + i * kPThreads;
      v[i] = 4 * j < n ? __ldcg(reinterpret_cast<const float4*>(src) + j)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kRow4; ++i) {
      const int j = threadIdx.x + i * kPThreads;
      if (4 * j < n) {
        float4* d = reinterpret_cast<float4*>(dst) + j;
        if constexpr (kAdd) {
          const float4 o = *d;
          *d = make_float4(o.x + v[i].x, o.y + v[i].y, o.z + v[i].z, o.w + v[i].w);
        } else {
          *d = v[i];
        }
      }
    }
  }
  // v[i] = the weights-side row w[0:n] (T, read-only) as float4s, the same
  // element split as take_row.
  __device__ static void weight_row(const T* w, int n, float4 (&v)[kRow4]) {
#pragma unroll
    for (int i = 0; i < kRow4; ++i) {
      const int j = threadIdx.x + i * kPThreads;
      v[i] = 4 * j < n ? load_dense4(w, (size_t)j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // The sum of S partials [S, N] at column n, in order.
  __device__ static float parts(const float* part, int S, int N, int n) {
    return sum_parts<true>(part, S, 1, N, 0, n);
  }

  __device__ void layer_norm(const float* x, const T* w, int N) {
    block_layer_norm<T, float>(x, w, xs, N, s.eps, am.red);
    __syncthreads();
  }

  // The attention items of one step, dealt round-robin over the grid; run
  // by the first kAttnThreads threads of a block.
  template <bool kScores>
  __device__ void attend_step(const AttnCall<T>& a, int chunk, float* po) {
    const int nch = (a.rows + chunk - 1) / chunk;
    if (threadIdx.x >= kAttnThreads) return;
    for (int it = blockIdx.x; it < a.heads * nch; it += gridDim.x) {
      const int h = it / nch, c = it - h * nch;
      float* sc = s.att.sc + (size_t)h * a.rows;
      if constexpr (kScores) {
        attn_scores_item<T, true>(a, sc, chunk, c, h, 0, 1, qs);
      } else {
        attn_pv_item<T, true, ScGlobal<true>>(a, sc, nullptr, po + (size_t)h * nch * a.d_head,
                                              false, chunk, c, h, 0, am);
      }
      attn_sync();  // qs / the item's shared memory are rewritten by the next item
    }
  }

  // An attention whose rows fit one chunk, every head in this block: the
  // scores into shared memory, the output rows straight into xs (the next
  // product's input). No barrier, and the same bits as the two steps over
  // the grid (one chunk: its partial is the output). kCoKV: K / V are
  // written in this launch (the LT's); else (the encoder rows) they are
  // read through the read-only path.
  template <bool kCoKV>
  __device__ void attend_one_chunk(const AttnCall<T>& a, int chunk) {
    if (threadIdx.x < kAttnThreads) {
      for (int h = 0; h < a.heads; ++h) {
        attn_scores_item<T, true, kCoKV>(a, lsc, chunk, 0, h, 0, 1, qs);
        attn_sync();
        attn_pv_item<T, kCoKV, ScPlain>(a, lsc, xs + h * a.d_head, nullptr, true, chunk, 0, h, 0,
                                        am);
        attn_sync();
      }
    }
    __syncthreads();
  }

  // xs[n] = rnd(sum of the chunk partials of n's head, in chunk order),
  // each thread four outputs, the chunks' loads out together, 8 at a time.
  __device__ void attention_out(const float* po, int W, int d_head, int rows, int chunk) {
    const int nch = (rows + chunk - 1) / chunk;
    for (int n = 4 * threadIdx.x; n < W; n += 4 * kPThreads) {
      const int h = n / d_head, d = n - h * d_head;
      const float4* pp = reinterpret_cast<const float4*>(po + (size_t)h * nch * d_head + d);
      const size_t step = d_head / 4;
      float4 o = __ldcg(pp);
      for (int c0 = 1; c0 < nch; c0 += 8) {
        float4 t[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t[i] = c0 + i < nch ? __ldcg(pp + (c0 + i) * step) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (c0 + i < nch) o = make_float4(o.x + t[i].x, o.y + t[i].y, o.z + t[i].z, o.w + t[i].w);
        }
      }
      xs[n] = rnd<T>(o.x), xs[n + 1] = rnd<T>(o.y), xs[n + 2] = rnd<T>(o.z);
      xs[n + 3] = rnd<T>(o.w);
    }
    __syncthreads();
  }

  // Phase cb's draw from the logits in part2 (every block, redundantly),
  // the code's embedding row into xs (the next phase's input) and the
  // embedding sum; after the last codebook (kSeam: kernel A) x =
  // rnd(rnd(sum / n_cb) + posemb) and xs = LayerNorm_0(x), the decoder's
  // input; without the seam (kernel 4) the last draw ends the frame.
  template <bool kSeam>
  __device__ void sample(int cb) {
    const int V = s.V, D = s.D;
    {
      float4 l4[kRow4], b4[kRow4];
      weight_row(s.lt_out_b + (size_t)cb * V, V, b4);
#pragma unroll
      for (int i = 0; i < kRow4; ++i) {
        const int j = threadIdx.x + i * kPThreads;
        l4[i] = 4 * j < V ? __ldcg(reinterpret_cast<const float4*>(p.part2) + j)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kRow4; ++i) {
        const int v = 4 * (threadIdx.x + i * kPThreads);
        const float lv[4] = {l4[i].x, l4[i].y, l4[i].z, l4[i].w};
        const float bv[4] = {b4[i].x, b4[i].y, b4[i].z, b4[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (v + e < V) {
            lg[v + e] = lt_forbidden(v + e, s.bos_id, s.eos_id, s.forbid_eos1)
                            ? kNegBig : (0.f + lv[e]) + bv[e];
          }
        }
      }
    }
    __syncthreads();
    int amax;
    const int code = block_sample(lg, V, s.temperature, s.top_k,
                                  (uint32_t)s.seed1 + (uint32_t)cb * kPhaseC, am.red, redi, hist,
                                  amax);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      s.sampled[cb] = code;
      s.argmax[cb] = amax;
    }
    const bool last = cb == s.ncb - 1;
    if (last && !kSeam) {
      pro(kProSample);
      return;
    }
    float4 e4[kRow4], pe4[kRow4];
    weight_row(s.audio_emb + ((size_t)cb * V + code) * D, D, e4);
    if (last) weight_row(s.posemb, D, pe4);
#pragma unroll
    for (int i = 0; i < kRow4; ++i) {
      const int n = 4 * (threadIdx.x + i * kPThreads);
      if (n < D) {
        const float ev[4] = {e4[i].x, e4[i].y, e4[i].z, e4[i].w};
        const float pv[4] = {pe4[i].x, pe4[i].y, pe4[i].z, pe4[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float acc = cb == 0 ? ev[k] : eacc[n + k] + ev[k];
          eacc[n + k] = acc;
          if (last) {
            xd[n + k] = rnd<T>(rnd<T>(acc / (float)s.ncb) + pv[k]);
          } else {
            xs[n + k] = ev[k];
          }
        }
      }
    }
    __syncthreads();
    if (last && has_items(3 * D, 1)) layer_norm(xd, s.norm_self, D);
    pro(kProSample);
  }

  template <bool kSeam>
  __device__ void lt_phases() {
    const int D = s.D, LT = s.LT, LF = s.LF, V = s.V;
    float* P0 = s.part;
    float* P1 = p.part2;
    for (int cb = 0; cb < s.ncb; ++cb) {
      // in_proj of the frame's hidden row, or of the last code's embedding
      if (cb == 0) {
        if (has_items(LT, p.split_lt_in)) {
          float4 h4[kRow4];
          weight_row(s.hidden, D, h4);
#pragma unroll
          for (int i = 0; i < kRow4; ++i) {
            const int j = threadIdx.x + i * kPThreads;
            if (4 * j < D) reinterpret_cast<float4*>(xs)[j] = h4[i];
          }
        }
        __syncthreads();
      } else {
        sample<kSeam>(cb - 1);
      }
      gemv<kStreamDense>(dense_ref(s.lt_in_w), D, LT, p.split_lt_in,
                         [&](int sp, int c, float v) { P0[sp * LT + c] = v; });
      barrier(kWorkGemv);
      // x = rnd(in_proj + bias) + pos[cb]; qkv of LayerNorm(x)
      for (int n = threadIdx.x; n < LT; n += kPThreads) {
        const float v = parts(P0, p.split_lt_in, LT, n) + ld(s.lt_in_b[n]);
        lx[n] = rnd<T>(v) + ld(s.lt_pos[(size_t)cb * LT + n]);
      }
      __syncthreads();
      if (has_items(3 * LT, 1)) layer_norm(lx, s.lt_norm_self, LT);
      pro(kProLN);
      gemv<kStreamDense>(dense_ref(s.lt_qkv), LT, 3 * LT, 1, [&](int, int c, float v) {
        if (c < LT) {
          s.lt_q[c] = rnd<T>(v);
        } else if (c < 2 * LT) {
          s.lt_k[(size_t)cb * LT + c - LT] = st<T>(v);
        } else {
          s.lt_v[(size_t)cb * LT + c - 2 * LT] = st<T>(v);
        }
      });
      barrier(kWorkGemv);
      // the LT attention over rows 0..cb (one chunk, in the blocks with
      // sa_out items), sa_out
      if (has_items(LT, p.split_lt_sa)) {
        attend_one_chunk<true>(AttnCall<T>{s.lt_q, 1, LT, s.lt_k, s.lt_v, 0, LT, cb + 1,
                                           nullptr, nullptr, 0, 0, nullptr, 1, LT, s.lt_scale,
                                           nullptr},
                               s.lt_chunk);
      }
      pro(kProAttn);
      gemv<kStreamDense>(dense_ref(s.lt_sa_out), LT, LT, p.split_lt_sa,
                         [&](int sp, int c, float v) { P1[sp * LT + c] = v; });
      barrier(kWorkGemv);
      // x += sa_out; ff_proj of LayerNorm(x), GELU
      for (int n = threadIdx.x; n < LT; n += kPThreads) {
        lx[n] = lx[n] + parts(P1, p.split_lt_sa, LT, n);
      }
      __syncthreads();
      if (has_items(LF, 1)) layer_norm(lx, s.lt_norm_ff, LT);
      pro(kProLN);
      gemv<kStreamDense>(dense_ref(s.lt_ff_proj), LT, LF, 1, [&](int, int c, float v) {
        s.lt_f[c] = rnd<T>(gelu_f(v, s.gelu_tanh));
      });
      barrier(kWorkGemv);
      // ff_out
      if (has_items(LT, p.split_lt_ff)) take_row<false>(xs, s.lt_f, LF);
      __syncthreads();
      pro(kProLN);
      gemv<kStreamDense>(dense_ref(s.lt_ff_out), LF, LT, p.split_lt_ff,
                         [&](int sp, int c, float v) { P0[sp * LT + c] = v; });
      barrier(kWorkGemv);
      // x += ff_out; the codebook's logits
      for (int n = threadIdx.x; n < LT; n += kPThreads) {
        const float x = lx[n] + parts(P0, p.split_lt_ff, LT, n);
        lx[n] = x;
        xs[n] = rnd<T>(x);
      }
      __syncthreads();
      pro(kProLN);
      gemv<kStreamDense>(dense_ref(s.lt_out_w + (size_t)cb * LT * V), LT, V, 1,
                         [&](int, int c, float v) { P1[c] = v; });
      barrier(kWorkGemv);
    }
    sample<kSeam>(s.ncb - 1);
  }

  // The last stamp record, and the records' count in word 0.
  __device__ void end_stamps() {
    record(kWorkNone);
    if (stamping()) p.stamps[0] = (unsigned long long)nrec;
  }

  // Kernel 5's input: x = rnd(hidden + posemb), xs = LayerNorm_0(x).
  __device__ void decoder_input() {
    float4 h4[kRow4], pe4[kRow4];
    weight_row(s.hidden, s.D, h4);
    weight_row(s.posemb, s.D, pe4);
#pragma unroll
    for (int i = 0; i < kRow4; ++i) {
      const int n = 4 * (threadIdx.x + i * kPThreads);
      if (n < s.D) {
        const float hv[4] = {h4[i].x, h4[i].y, h4[i].z, h4[i].w};
        const float pv[4] = {pe4[i].x, pe4[i].y, pe4[i].z, pe4[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) xd[n + k] = rnd<T>((0.f + hv[k]) + pv[k]);
      }
    }
    __syncthreads();
    if (has_items(3 * s.D, 1)) layer_norm(xd, s.norm_self, s.D);
    pro(kProLN);
  }

  // The decoder layers.
  __device__ void decoder_layers() {
    const int D = s.D, F = s.F, X = s.X, E = s.E, NS = s.NS;
    const int dh = D / s.n_heads, dxh = X / s.xa_heads;
    const int pos = s.write_row;
    float* P0 = s.part;
    float* P1 = p.part2;
    for (int l = 0; l < s.L; ++l) {
      T* kc = s.k_cache + (size_t)l * NS * D;
      T* vc = s.v_cache + (size_t)l * NS * D;
      const T* xk = s.xa_k + (size_t)l * E * X;
      const T* xv = s.xa_v + (size_t)l * E * X;
      const T* wxq = s.xa_q + (size_t)l * D * X;
      const T* wxo = s.xa_out + (size_t)l * X * D;
      const WeightRef<T> wqkv = s.qkv.layer(l, D, 3 * D);
      const WeightRef<T> wsa = s.sa_out.layer(l, D, D);
      const WeightRef<T> wfp = s.ff_proj.layer(l, D, F);
      const WeightRef<T> wfo = s.ff_out.layer(l, F, D);
      const float* cs_qkv = s.qkv.col_scale(l, 3 * D);
      const float* cs_sa = s.sa_out.col_scale(l, D);
      const float* cs_fp = s.ff_proj.col_scale(l, F);
      const float* cs_fo = s.ff_out.col_scale(l, D);

      // qkv: q, and the new K / V row at pos
      gemv<MODE>(wqkv, D, 3 * D, 1, [&](int, int c, float v) {
        if (cs_qkv) v *= cs_qkv[c];
        if (c < D) {
          s.q[c] = rnd<T>(v);
        } else if (c < 2 * D) {
          kc[(size_t)pos * D + c - D] = st<T>(v);
        } else {
          vc[(size_t)pos * D + c - 2 * D] = st<T>(v);
        }
      });
      barrier(kWorkGemv);
      // self-attention over rows [0, pos]
      const AttnCall<T> sa{s.q, 1, D, kc, vc, 0, D, s.rows, nullptr, nullptr, 0, 0, nullptr,
                           s.n_heads, dh, s.sa_scale, nullptr};
      attend_step<true>(sa, s.sa_chunk, s.att.po);
      barrier(kWorkAttn);
      attend_step<false>(sa, s.sa_chunk, s.att.po);
      barrier(kWorkAttn);
      // sa_out
      if (has_items(D, 1)) attention_out(s.att.po, D, dh, s.rows, s.sa_chunk);
      pro(kProLN);
      gemv<MODE>(wsa, D, D, 1, [&](int, int c, float v) { P0[c] = cs_sa ? v * cs_sa[c] : v; });
      barrier(kWorkGemv);
      // x += sa_out; xa_q of LayerNorm(x)
      take_row<true>(xd, P0, D);
      __syncthreads();
      if (has_items(X, p.split_xa_q)) layer_norm(xd, s.norm_xa_q + (size_t)l * D, D);
      pro(kProLN);
      gemv<kStreamDense>(dense_ref(wxq), D, X, p.split_xa_q,
                         [&](int sp, int c, float v) { P1[sp * X + c] = v; });
      barrier(kWorkGemv);
      // cross-attention over the enc_len encoder rows: in one chunk the
      // blocks with xa_out items attend themselves (no barrier); else the
      // two steps over the grid
      const AttnCall<T> xa{P1, p.split_xa_q, X, xk, xv, 0, X, s.enc_len, nullptr, nullptr, 0, 0,
                           nullptr, s.xa_heads, dxh, s.xa_scale, nullptr};
      if (s.enc_len <= s.xa_chunk) {
        if (has_items(D, 1)) attend_one_chunk<false>(xa, s.xa_chunk);
        pro(kProAttn);
      } else {
        attend_step<true>(xa, s.xa_chunk, s.att.po);
        barrier(kWorkAttn);
        attend_step<false>(xa, s.xa_chunk, s.att.po);
        barrier(kWorkAttn);
        if (has_items(D, 1)) attention_out(s.att.po, X, dxh, s.enc_len, s.xa_chunk);
        pro(kProLN);
      }
      // xa_out
      gemv<kStreamDense>(dense_ref(wxo), X, D, 1, [&](int, int c, float v) { P0[c] = v; });
      barrier(kWorkGemv);
      // x += xa_out; ff_proj of LayerNorm(x), GELU
      take_row<true>(xd, P0, D);
      __syncthreads();
      if (has_items(F, 1)) layer_norm(xd, s.norm_ff + (size_t)l * D, D);
      pro(kProLN);
      gemv<MODE>(wfp, D, F, 1, [&](int, int c, float v) {
        if (cs_fp) v *= cs_fp[c];
        s.f[c] = rnd<T>(gelu_f(v, s.gelu_tanh));
      });
      barrier(kWorkGemv);
      // ff_out
      if (has_items(D, 1)) take_row<false>(xs, s.f, F);
      __syncthreads();
      pro(kProLN);
      gemv<MODE>(wfo, F, D, 1, [&](int, int c, float v) { P1[c] = cs_fo ? v * cs_fo[c] : v; });
      barrier(kWorkGemv);
      // x += ff_out; the next layer's LayerNorm, or the final norm
      take_row<true>(xd, P1, D);
      __syncthreads();
      if (l + 1 < s.L) {
        if (has_items(3 * D, 1)) layer_norm(xd, s.norm_self + (size_t)(l + 1) * D, D);
        pro(kProLN);
      }
    }
    if (blockIdx.x == 0) {
      block_layer_norm<T, T>(xd, s.norm_out, s.hidden_out, D, s.eps, am.red);
      pro(kProLN);
      end_stamps();
    }
  }
};

template <class T, int MODE, bool kLT>
__global__ void __launch_bounds__(kPThreads, kBlocksPerSm)
frame_persistent_kernel(const __grid_constant__ Persist<T> p) {
  extern __shared__ __align__(16) float smem[];
  Frame<T, MODE, kLT> f(p, smem);
  if constexpr (kLT) {
    f.template lt_phases<true>();
  } else {
    f.decoder_input();
  }
  f.decoder_layers();
}

// Kernel 4: kernel A's LT phases alone, the codes of `hidden`: the same
// phase table up to the last draw, the same grid, products and draw, so
// its codes are A's.
template <class T>
__global__ void __launch_bounds__(kPThreads, kBlocksPerSm)
lt_persistent_kernel(const __grid_constant__ Persist<T> p) {
  extern __shared__ __align__(16) float smem[];
  Frame<T, kStreamDense, true> f(p, smem);
  f.template lt_phases<false>();
  f.end_stamps();
}

}  // namespace
