// Kernels 15-17: the H100 counterparts of the TPU's launch-cost probes,
// scripts/opt_slope_probe.py probe_minimal (a copy kernel at grid 8) and
// probe_constblk (the same plus 10 constant bf16 weight blocks, 2.02 MB, read
// on every call), and scripts/opt_launch_probe.py minimal_probe (the copy
// kernel at grid 1 / 8 / 20, optionally streaming a [grid_n, 512, 1024] bf16
// block, 1 MB per grid step).
//
// out = x + (grid_n - 1) in bf16 (what the TPU kernel's last grid step
// writes; the streamed form adds w[grid_n - 1, 0, 0] instead). The TPU's grid
// steps run in order on one core; here they become grid_n thread blocks that
// run at once, so grid 1 / 8 / 20 measures a launch plus block scheduling,
// not a serial cost per step. Block i owns words [i * n / grid_n,
// (i + 1) * n / grid_n) of x (32-bit words of bf16 pairs) and of every
// constant block, and slab i of the streamed weight; so that no read can be
// dropped, it writes the XOR of every 32-bit word it read to cs[i] (exact and
// independent of order; the plain version computes the same partials).
//
// What bounds it on the card: nothing the kernel does. [32, 768] bf16 in and
// out is 98 KB (0.03 us at 3.35 TB/s); the constant blocks add 2.02 MB
// (0.63 us) and the streamed slabs 1 MB a block. The probe measures the cost
// of a launch, and the rate at which grid_n blocks read.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxConst = 16;

struct ConstBlocks {
  const unsigned* ptr[kMaxConst];
  long long words[kMaxConst];
  int n;
};

// XOR of words [lo, hi) of p, read by the block's threads (16 B loads where
// aligned); every thread returns its share.
__device__ __forceinline__ unsigned xor_range(const unsigned* __restrict__ p, long long lo,
                                              long long hi) {
  unsigned acc = 0;
  const long long a = min(hi, (lo + 3) & ~3LL);
  const long long z = max(a, hi & ~3LL);
  for (long long w = lo + threadIdx.x; w < a; w += blockDim.x) acc ^= __ldg(p + w);
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
  for (long long q = a / 4 + threadIdx.x; q < z / 4; q += blockDim.x) {
    const uint4 t = __ldg(v + q);
    acc ^= t.x ^ t.y ^ t.z ^ t.w;
  }
  for (long long w = z + threadIdx.x; w < hi; w += blockDim.x) acc ^= __ldg(p + w);
  return acc;
}

__device__ __forceinline__ unsigned add_pair(unsigned word, float add) {
  const float lo = __uint_as_float(word << 16) + add;
  const float hi = __uint_as_float(word & 0xffff0000u) + add;
  const unsigned short l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return (unsigned)l | ((unsigned)h << 16);
}

// Grid (grid_n), kThreads threads. With `slab`, block i also reads words
// [i * slab_words, (i + 1) * slab_words) and the added value is the slab's
// first element w[grid_n - 1, 0, 0]; else it is grid_n - 1.
__global__ void __launch_bounds__(kThreads)
probe_copy_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                  unsigned* __restrict__ cs, long long n_words, ConstBlocks blocks,
                  const unsigned* __restrict__ slab, long long slab_words) {
  __shared__ unsigned red[kThreads / 32];
  const int i = blockIdx.x, g = gridDim.x;
  const float add = slab ? __uint_as_float(__ldg(slab + (long long)(g - 1) * slab_words) << 16)
                         : (float)(g - 1);
  const long long lo = i * n_words / g, hi = (i + 1) * n_words / g;
  unsigned acc = 0;
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    const unsigned word = __ldg(x + w);
    acc ^= word;
    out[w] = add_pair(word, add);
  }
  for (int j = 0; j < blocks.n; ++j) {
    const long long n = blocks.words[j];
    acc ^= xor_range(blocks.ptr[j], i * n / g, (i + 1) * n / g);
  }
  if (slab) acc ^= xor_range(slab, i * slab_words, (i + 1) * slab_words);
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(MAGPIE_FULL_MASK, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t ^= red[w];
    cs[i] = t;
  }
}

int launch(const void* x, void* out, void* cs, long long n_words, int grid_n,
           const ConstBlocks& blocks, const void* slab, long long slab_words, void* stream) {
  if (n_words < 1 || grid_n < 1 || grid_n > 65535 || blocks.n < 0 || blocks.n > kMaxConst ||
      (slab && slab_words < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  probe_copy_kernel<<<grid_n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), static_cast<unsigned*>(cs),
      n_words, blocks, static_cast<const unsigned*>(slab), slab_words);
  return (int)cudaGetLastError();
}

}  // namespace

// x / out: n_words 32-bit words of bf16 pairs; cs [grid_n] uint32 (the XOR
// of the words each block read).
extern "C" int magpie_probe_copy(const void* x, void* out, void* cs, long long n_words,
                                 int grid_n, void* stream) {
  ConstBlocks none{};
  return launch(x, out, cs, n_words, grid_n, none, nullptr, 0, stream);
}
// The same plus n_const constant blocks (ptrs[j]: words[j] 32-bit words,
// 16-byte aligned), each read once per call, split over the grid_n blocks.
extern "C" int magpie_probe_copy_const(const void* x, void* out, void* cs, long long n_words,
                                       int grid_n, const void* const* ptrs,
                                       const long long* words, int n_const, void* stream) {
  if (n_const < 0 || n_const > kMaxConst) return (int)cudaErrorInvalidValue;
  ConstBlocks blocks{};
  for (int j = 0; j < n_const; ++j) {
    blocks.ptr[j] = static_cast<const unsigned*>(ptrs[j]);
    blocks.words[j] = words[j];
  }
  blocks.n = n_const;
  return launch(x, out, cs, n_words, grid_n, blocks, nullptr, 0, stream);
}
// The copy at grid_n blocks with a streamed weight slab [grid_n, slab_words]
// words (16-byte aligned): block i reads slab i.
extern "C" int magpie_probe_copy_streamed(const void* x, void* out, void* cs, long long n_words,
                                          int grid_n, const void* slab, long long slab_words,
                                          void* stream) {
  if (!slab) return (int)cudaErrorInvalidValue;
  return launch(x, out, cs, n_words, grid_n, ConstBlocks{}, slab, slab_words, stream);
}
