// Kernel 9: one whole nano-codec res layer in one launch, in float32
// (magpie_res_layer_fused_f32) or bfloat16 (magpie_res_layer_fused_bf16):
// 3 branches x 3 residual blocks x (HalfSnake -> dilated causal in-conv,
// HalfSnake -> causal sk-conv, + block residual), then the mean of the 3
// branches, for activations [N, T, C] with C <= 128 (the codec's 108-, 54-
// and 27-channel stages).
//
// Replaces the TPU kernel magpie_tts_tpu/ops/pallas_kernels/codec_res_fused.py
// res_layer_fused. The TPU kernel walks time in 1024-row tiles on one core,
// keeps all 18 convs' weights (126 taps x 128 x 128) resident in 100 MB of
// VMEM and four (H + tile)-row windows beside them. A Hopper block has 227 KB
// of shared memory, so here:
// - a block owns `tile` output rows of one utterance and all C channels; its
//   window is the H = max branch halo rows before the tile plus the tile
//   (H = 120 for k = 11: 10 + 10 + 30 + 10 + 50 + 10), recomputed per block;
// - two float windows stay in shared memory: `h`, the branch carry, and `a`,
//   the activated conv input (the in-conv's result is written over it, then
//   activated in place for the sk-conv); the raw input is re-read from global
//   memory (an L2 hit) at each branch's start, and the branch sum lives in
//   the output rows in global memory (each element read and written by the
//   thread that owns it);
// - the weights stream from global memory (L2: 5.9 MB in f32 at C = 108) in
//   32-input-channel chunks of one tap, staged in shared memory;
// - each branch starts at the first row it needs (H - its own halo), and
//   each conv computes only the rows that a later conv reads: at tile 64 and
//   H = 120 the 18 convs compute 1.7x the tile's rows (1 + 43.9 / tile).
//
// What bounds it on the card: a 32-frame decode does 42.1 GFLOP in the three
// layers (126 taps x 2 T C^2, T = 8192 / 16384 / 32768 at C = 108 / 54 / 27)
// and moves ~21 MB: compute-bound. This simple version is a register-tiled
// SIMT product (4 rows x 4 output channels per item, up to 4 items a thread,
// their sums held in registers through the conv), in full float32, so the
// float32 FMA rate, not the tensor cores, is its ceiling; wgmma is later work.
//
// Every value is computed by the same arithmetic wherever the tile and the
// window start fall: a conv output sums tap by tap, input channels in
// ascending order, and every other step is elementwise. So a row of a
// streamed window equals the row of the offline decode at the same time.
//
// The rounding points (rnd<T>) are the TPU kernel's, which differ from
// kernel B's in bf16: HalfSnake in float32, rounded (:80-87); each conv's
// acc + bias in float32, rounded once (:101-102); the block residual h + r in
// the storage type (:119); the branch sum in the storage type, branch by
// branch (:121-124); the mean a float32 divide, rounded (:126-127). Rows at
// time < 0 are zero after every conv (each conv zero-pads its own input).
// The activation is the plain half_snake's: x + sin(a*x)^2 / a with libm
// sinf on the first n_snake channels, LeakyReLU on the rest.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;      // output rows per item
constexpr int kCols = 4;      // output channels per item
constexpr int kMaxItems = 4;  // items per thread
constexpr int kChunk = 32;    // input channels per staged weight chunk
constexpr int kMaxConvs = 32;
constexpr int kMaxC = 128;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

struct LayerMeta {
  int n_branches, per_branch, halo;
  int k[kMaxConvs], dil[kMaxConvs], n_snake[kMaxConvs];
  int branch_halo[kMaxConvs];
  long long w_off[kMaxConvs];  // element offset of conv c's [k, C, C] weights
};

__device__ __forceinline__ float snake_act(float v, int c, const float a, int n_snake,
                                           float slope) {
  if (c < n_snake) {
    const float s = sinf(a * v);
    return v + (s * s) / a;
  }
  return v >= 0.f ? v : slope * v;
}

// dst[r][c] = rnd(act(src[r][c])) for window rows [r0, W); pad channels 0.
template <class E>
__device__ __forceinline__ void activate(const float* src, float* dst, int r0, int W, int C,
                                         int Cp, const E* __restrict__ alpha, int n_snake,
                                         float slope) {
  for (int idx = threadIdx.x; idx < (W - r0) * Cp; idx += kThreads) {
    const int r = r0 + idx / Cp, c = idx % Cp;
    float v = 0.f;
    if (c < C) v = rnd<E>(snake_act(src[r * Cp + c], c, c < n_snake ? ld(alpha[c]) : 1.f,
                                    n_snake, slope));
    dst[r * Cp + c] = v;
  }
}

// acc[it] = sum over taps, then input channels in ascending order, of
// a[row - (k-1-tap)*dil][c] * w[tap][c][o] for the item's 4 rows (from lo)
// and 4 output channels. Staging a weight chunk syncs the block.
template <class E>
__device__ __forceinline__ void conv_sums(const float* a, float* wsm,
                                          const E* __restrict__ w, int k, int dil, int lo,
                                          int W, int C, int Cp,
                                          float (&acc)[kMaxItems][kRows][kCols]) {
  const int groups = Cp / kCols;
  const int n_items = (W - lo + kRows - 1) / kRows * groups;
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it)
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[it][j][jj] = 0.f;
  for (int tap = 0; tap < k; ++tap) {
    const int shift = (k - 1 - tap) * dil;
    for (int c0 = 0; c0 < Cp; c0 += kChunk) {
      const int kc = min(kChunk, Cp - c0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kc * Cp; idx += kThreads) {
        const int c = c0 + idx / Cp, o = idx % Cp;
        wsm[idx] = (c < C && o < C) ? ld(w[((size_t)tap * C + c) * C + o]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const int item = threadIdx.x + it * kThreads;
        if (item < n_items) {
          const int rg = item / groups, cg = item % groups;
          const float* ap = a + (lo + rg * kRows - shift) * Cp + c0;
          const float4* wp = reinterpret_cast<const float4*>(wsm) + cg;
#pragma unroll 4
          for (int cc = 0; cc < kc; ++cc) {
            const float4 wv = wp[cc * groups];
            const float wr[kCols] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              const float av = ap[j * Cp + cc];
#pragma unroll
              for (int jj = 0; jj < kCols; ++jj) acc[it][j][jj] = fmaf(av, wr[jj], acc[it][j][jj]);
            }
          }
        }
      }
    }
  }
}

template <class E>
__global__ void __launch_bounds__(kThreads)
res_fused_kernel(const E* __restrict__ x, const E* __restrict__ w, const E* __restrict__ bias,
                 const E* __restrict__ alpha, float slope, E* __restrict__ out, int T, int C,
                 int Cp, int tile, LayerMeta m) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = m.halo, W = H + tile, Wr = W + kRows;
  float* hb = sm;             // [Wr][Cp] branch carry h
  float* ab = sm + Wr * Cp;   // [Wr][Cp] activated conv input / in-conv result
  float* wsm = ab + Wr * Cp;  // [kChunk][Cp] one staged weight chunk
  const int t0 = blockIdx.x * tile;
  const int base = t0 - H;  // time of window row 0
  const size_t nb = blockIdx.y;
  x += nb * T * C;
  out += nb * T * C;
  const int groups = Cp / kCols;
  float acc[kMaxItems][kRows][kCols];

  for (int b = 0; b < m.n_branches; ++b) {
    int off = H - m.branch_halo[b];
    __syncthreads();
    for (int idx = threadIdx.x; idx < (W - off) * Cp; idx += kThreads) {
      const int r = off + idx / Cp, c = idx % Cp, t = base + r;
      hb[r * Cp + c] = (t >= 0 && t < T && c < C) ? ld(x[(size_t)t * C + c]) : 0.f;
    }
    for (int blk = 0; blk < m.per_branch / 2; ++blk) {
      const int c1 = b * m.per_branch + 2 * blk, c2 = c1 + 1;
      // in-conv: a = act(h); r = conv(a) + b, written over a
      __syncthreads();
      activate<E>(hb, ab, off, W, C, Cp, alpha + (size_t)c1 * C, m.n_snake[c1], slope);
      const int lo1 = off + (m.k[c1] - 1) * m.dil[c1];
      conv_sums<E>(ab, wsm, w + m.w_off[c1], m.k[c1], m.dil[c1], lo1, W, C, Cp, acc);
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const int item = threadIdx.x + it * kThreads;
        const int rg = item / groups, cg = item % groups;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = lo1 + rg * kRows + j;
          if (r >= W) continue;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            const int o = cg * kCols + jj;
            if (o >= C) continue;
            ab[r * Cp + o] =
                base + r < 0 ? 0.f : rnd<E>(acc[it][j][jj] + ld(bias[(size_t)c1 * C + o]));
          }
        }
      }
      // sk-conv: a = act(r) in place; h = h + (conv(a) + b)
      __syncthreads();
      activate<E>(ab, ab, lo1, W, C, Cp, alpha + (size_t)c2 * C, m.n_snake[c2], slope);
      const int lo2 = lo1 + (m.k[c2] - 1) * m.dil[c2];
      conv_sums<E>(ab, wsm, w + m.w_off[c2], m.k[c2], m.dil[c2], lo2, W, C, Cp, acc);
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const int item = threadIdx.x + it * kThreads;
        const int rg = item / groups, cg = item % groups;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = lo2 + rg * kRows + j;
          if (r >= W || base + r < 0) continue;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            const int o = cg * kCols + jj;
            if (o >= C) continue;
            const float rv = rnd<E>(acc[it][j][jj] + ld(bias[(size_t)c2 * C + o]));
            hb[r * Cp + o] = rnd<E>(hb[r * Cp + o] + rv);
          }
        }
      }
      off = lo2;
    }
    // The branch's rows [H, W) are the tile's: add them to the branch sum.
    __syncthreads();
    for (int idx = threadIdx.x; idx < tile * C; idx += kThreads) {
      const int i = idx / C, o = idx % C, t = t0 + i;
      if (t >= T) continue;
      float v = hb[(H + i) * Cp + o];
      if (b > 0) v = rnd<E>(ld(out[(size_t)t * C + o]) + v);
      if (b == m.n_branches - 1) v = v / (float)m.n_branches;
      out[(size_t)t * C + o] = st<E>(v);
    }
  }
}

size_t smem_bytes(int tile, int halo, int Cp) {
  return (size_t)(2 * (halo + tile + kRows) * Cp + kChunk * Cp) * sizeof(float);
}

template <class E>
int res_fused(const void* x, const void* w, const void* b, const void* alpha, const int* meta,
              float slope, void* out, int N, int T, int C, int tile, void* stream) {
  LayerMeta m = {};
  m.n_branches = meta[0];
  m.per_branch = meta[1];
  const int n_convs = m.n_branches * m.per_branch;
  if (C < 1 || C > kMaxC || n_convs < 1 || n_convs > kMaxConvs || m.per_branch % 2 ||
      tile < 1 || N < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  long long off = 0;
  for (int c = 0; c < n_convs; ++c) {
    m.k[c] = meta[2 + 3 * c];
    m.dil[c] = meta[3 + 3 * c];
    m.n_snake[c] = meta[4 + 3 * c];
    if (m.k[c] < 1 || m.dil[c] < 1) return (int)cudaErrorInvalidValue;
    m.w_off[c] = off;
    off += (long long)m.k[c] * C * C;
    m.branch_halo[c / m.per_branch] += (m.k[c] - 1) * m.dil[c];
  }
  for (int br = 0; br < m.n_branches; ++br) m.halo = max(m.halo, m.branch_halo[br]);
  const int Cp = (C + kCols - 1) / kCols * kCols;
  // Every conv's items must fit the threads' register sums.
  for (int br = 0; br < m.n_branches; ++br) {
    int lo = m.halo - m.branch_halo[br];
    for (int c = br * m.per_branch; c < (br + 1) * m.per_branch; ++c) {
      lo += (m.k[c] - 1) * m.dil[c];
      const int items = (m.halo + tile - lo + kRows - 1) / kRows * (Cp / kCols);
      if (items > kMaxItems * kThreads) return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = smem_bytes(tile, m.halo, Cp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(res_fused_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, N);
  res_fused_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), static_cast<const E*>(b),
      static_cast<const E*>(alpha), slope, static_cast<E*>(out), T, C, Cp, tile, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [N, T, C]; w: the n_branches * per_branch convs' [k, C, C] (WIO)
// weights one after another, in branch order, each block's in-conv then its
// sk-conv; b, alpha [n_convs, C] (alpha read on each conv's first n_snake
// channels); meta (host memory): n_branches, per_branch, then (k, dilation,
// n_snake) per conv. All tensors float32 (_f32) or bfloat16 (_bf16). Returns
// the CUDA error code of the launch (0 = success); a shape the kernel does
// not take (C > 128, a tile whose windows or sums do not fit) is
// cudaErrorInvalidValue.
extern "C" int magpie_res_layer_fused_f32(const void* x, const void* w, const void* b,
                                          const void* alpha, const int* meta, float slope,
                                          void* out, int N, int T, int C, int tile,
                                          void* stream) {
  return res_fused<float>(x, w, b, alpha, meta, slope, out, N, T, C, tile, stream);
}
extern "C" int magpie_res_layer_fused_bf16(const void* x, const void* w, const void* b,
                                           const void* alpha, const int* meta, float slope,
                                           void* out, int N, int T, int C, int tile,
                                           void* stream) {
  return res_fused<__nv_bfloat16>(x, w, b, alpha, meta, slope, out, N, T, C, tile, stream);
}
