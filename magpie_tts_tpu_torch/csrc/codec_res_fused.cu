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
// - two windows in the operand type (bf16 in bf16: half the bytes, so the
//   tile can be 2-4x that of float32) stay in shared memory: `h`, the branch
//   carry, and `a`, the activated conv input; the in-conv's result is written
//   over `a` and activated in place for the sk-conv; the raw input is re-read
//   from global memory (an L2 hit) at each branch's start, and the branch sum
//   lives in the output rows in global memory (each element read and written
//   by the thread that owns it);
// - the products run on the tensor cores through conv_mma.cuh, as kernel B's
//   (mma.sync: bf16 operands with float32 sums, or split TF32 in float32):
//   the 8 warps cover a pass of `pm` rows x all C channels, and a conv whose
//   rows do not fit one pass takes several, from the top rows down: a causal
//   conv's output row r reads input rows <= r only, so writing a pass's
//   outputs over the input rows it came from never touches a row a lower
//   pass still reads;
// - the weights stream (from L2: 2.9 MB in bf16 at C = 108) through the same
//   ring of [kChunk x C] slices as kernel B, filled by cp.async kStages - 1
//   slices ahead along the block's whole sequence of (conv, pass, tap,
//   chunk), across pass and conv boundaries;
// - each branch starts at the first row it needs (H - its own halo), and
//   each conv computes only the rows that a later conv reads.
//
// What bounds it on the card: a 32-frame decode does 42.1 GFLOP in the three
// layers (126 taps x 2 T C^2, T = 8192 / 16384 / 32768 at C = 108 / 54 / 27)
// and moves ~21 MB: compute-bound. On top of kernel B's work it redoes the
// halo's rows per block, rounds each conv's rows up to whole passes (pm =
// 128 rows at C = 108 in bf16, 64 in float32), re-streams the weights per
// pass, and runs one block per SM; between kernel B's launches the stages
// stay in the 50 MB L2, so the fusion saves no bytes that matter.
//
// Every value is computed by the same arithmetic wherever the tile and the
// window start fall: a conv output sums tap by tap, input channels in
// ascending kChunk chunks inside a tap (bf16: each mma's 16 channels
// summed from zero, then added to the total; float32: each tap's sum in its
// own accumulator, then added to the total), and every other step is
// elementwise. So a row of a streamed window equals the row of the offline
// decode at the same time. The warp split (warps side by side, n8 tiles
// each) is a function of C and the dtype, computed by the wrapper.
//
// The rounding points (rnd<T>) are the TPU kernel's, which differ from
// kernel B's in bf16: HalfSnake in float32, rounded (:80-87); each conv's
// acc + bias in float32, rounded once (:101-102); the block residual h + r in
// the storage type (:119); the branch sum in the storage type, branch by
// branch (:121-124); the mean a float32 divide, rounded (:126-127). Rows at
// time < 0 are zero after every conv (each conv zero-pads its own input).
// The activation is the plain half_snake's: x + sin(a*x)^2 / a with libm
// sinf on the first n_snake channels, LeakyReLU on the rest.

#include <type_traits>

#include "conv_mma.cuh"

namespace {

using namespace conv_mma;

constexpr int kMaxConvs = 32;
constexpr int kMaxC = 128;
// Input channels per weight slice: 64 in bf16 (half the ring steps); 32 in
// float32, whose windows take the shared memory a wider slice would need.
template <class E>
constexpr int kChunk = std::is_same<E, float>::value ? 32 : 64;

struct LayerMeta {
  int n_branches, per_branch, halo, n_convs;
  int k[kMaxConvs], dil[kMaxConvs], n_snake[kMaxConvs];
  int branch_halo[kMaxConvs];
  int lo[kMaxConvs];     // window row of conv c's first output row
  int passes[kMaxConvs]; // passes of pm rows that cover [lo, H + tile)
  long long w_off[kMaxConvs];  // element offset of conv c's [k, C, C] weights
};

// dst[r][c] = rnd(act(src[r][c])) for window rows [r0, W); pad channels 0.
template <class E>
__device__ __forceinline__ void activate(const E* src, E* dst, int r0, int W, int C, int S,
                                         const E* __restrict__ alpha, int n_snake,
                                         float slope) {
  for (int idx = threadIdx.x; idx < (W - r0) * S; idx += kThreads) {
    const int r = r0 + idx / S, c = idx % S;
    float v = 0.f;
    if (c < C)
      v = rnd<E>(half_snake(ld(src[r * S + c]), c, c < n_snake ? ld(alpha[c]) : 1.f, n_snake,
                            slope));
    dst[r * S + c] = st<E>(v);
  }
}

template <class E, int NT>
__global__ void __launch_bounds__(kThreads, 1)
res_fused_kernel(const E* __restrict__ x, const E* __restrict__ w, const E* __restrict__ bias,
                 const E* __restrict__ alpha, float slope, E* __restrict__ out, int T, int C,
                 int tile, int warps_n, int vec, LayerMeta m) {
  using Tr = Traits<E>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = m.halo, W = H + tile;
  const int S = window_stride<E>(C);   // window row stride
  const int Cn = warps_n * NT * 8;     // output channels, padded to the warps' n8 tiles
  const int sw = ring_stride(Cn);
  const int Ck = (C + 15) / 16 * 16;         // input channels, padded to the k16 step
  constexpr int kc = kChunk<E>;
  const int nchunks = (Ck + kc - 1) / kc;
  E* hb = reinterpret_cast<E*>(smem_raw);  // [W][S] branch carry h
  E* ab = hb + W * S;                      // [W][S] activated conv input / in-conv result
  E* ring = ab + W * S;                    // [kStages][kc][sw] weight slices
  const int t0 = blockIdx.x * tile;
  const int base = t0 - H;  // time of window row 0
  const size_t nb = blockIdx.y;
  x += nb * T * C;
  out += nb * T * C;
  const int warps_m = kWarps / warps_n;
  const int pm = warps_m * kWarpRows;  // rows a pass covers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % warps_m, wn = warp / warps_m;

  // The ring's fill cursor walks (conv, pass, tap, chunk) kStages - 1 slices
  // ahead of the products.
  int fc = 0, fp = 0, ft = 0, fch = 0;
  int slot = 0;  // ring slot of the next slice to fill
  auto fill_next = [&]() {
    if (fc < m.n_convs) {
      const int c0 = fch * kc;
      fill_stage<E>(ring + slot * kc * sw, w + m.w_off[fc] + ((size_t)ft * C + c0) * C, kc,
                    min(kc, C - c0), C, C, Cn, sw, vec);
      if (++fch == nchunks) {
        fch = 0;
        if (++ft == m.k[fc]) {
          ft = 0;
          if (++fp == m.passes[fc]) {
            fp = 0;
            ++fc;
          }
        }
      }
    }
    cp_async_commit();
    slot = slot + 1 == kStages ? 0 : slot + 1;
  };
  for (int s = 0; s < kStages - 1; ++s) fill_next();
  int use = 0;  // ring slot of the next slice to multiply

  float acc[2][NT][4];
  float part[2][NT][4];  // float32: the current tap's sums
  const int g = lane >> 2, tq = lane & 3;

  // One conv (c, reading `ab` from row lo - its halo) over the rows [lo, W),
  // pass by pass from the top; epi(r, o, acc) stores an output element.
  auto conv = [&](int c, auto epi) {
    const int k = m.k[c], dil = m.dil[c], lo = m.lo[c];
    for (int q = 0; q < m.passes[c]; ++q) {
      const int p0 = W - (q + 1) * pm;
      const int r_warp = p0 + wm * kWarpRows;
      const bool active = r_warp + kWarpRows > lo;
      zero(acc);
      zero(part);
      for (int tap = 0; tap < k; ++tap) {
        const int shift = (k - 1 - tap) * dil;
        const E* a0 = ab + max(r_warp + (lane & 15) - shift, 0) * S;
        const E* a1 = ab + max(r_warp + 16 + (lane & 15) - shift, 0) * S;
        for (int ch = 0; ch < nchunks; ++ch) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // this slice is in; the previous slice's slot is free
          fill_next();
          const E* ws = ring + use * kc * sw + wn * NT * 8;
          use = use + 1 == kStages ? 0 : use + 1;
          if (active) {
            const int ksteps = min(kc, Ck - ch * kc) / Tr::kStep;
            StageMma<E, NT>::run(acc, part, a0 + ch * kc, a1 + ch * kc, ksteps, ws, sw);
          }
        }
        if constexpr (std::is_same<E, float>::value) flush(acc, part);
      }
      __syncthreads();  // every warp has read the rows this pass overwrites
      if (active) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int nt = wn * NT + j;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = r_warp + mt * 16 + g + hh * 8;
              if (r < lo) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int o = nt * 8 + 2 * tq + e;
                if (o < C) epi(r, o, acc[mt][j][hh * 2 + e]);
              }
            }
          }
      }
    }
  };

  for (int b = 0; b < m.n_branches; ++b) {
    int off = H - m.branch_halo[b];
    __syncthreads();  // the previous branch's sum has read h
    for (int idx = threadIdx.x; idx < (W - off) * S; idx += kThreads) {
      const int r = off + idx / S, c = idx % S, t = base + r;
      hb[r * S + c] = (t >= 0 && t < T && c < C) ? x[(size_t)t * C + c] : st<E>(0.f);
    }
    for (int blk = 0; blk < m.per_branch / 2; ++blk) {
      const int c1 = b * m.per_branch + 2 * blk, c2 = c1 + 1;
      // in-conv: a = act(h); r = conv(a) + b, written over a
      __syncthreads();
      activate<E>(hb, ab, off, W, C, S, alpha + (size_t)c1 * C, m.n_snake[c1], slope);
      const E* b1 = bias + (size_t)c1 * C;
      conv(c1, [&](int r, int o, float v) {
        ab[r * S + o] = st<E>(base + r < 0 ? 0.f : rnd<E>(v + ld(b1[o])));
      });
      // sk-conv: a = act(r) in place; h = h + (conv(a) + b)
      __syncthreads();
      activate<E>(ab, ab, m.lo[c1], W, C, S, alpha + (size_t)c2 * C, m.n_snake[c2], slope);
      const E* b2 = bias + (size_t)c2 * C;
      conv(c2, [&](int r, int o, float v) {
        if (base + r < 0) return;
        const float rv = rnd<E>(v + ld(b2[o]));
        hb[r * S + o] = st<E>(rnd<E>(ld(hb[r * S + o]) + rv));
      });
      off = m.lo[c2];
    }
    // The branch's rows [H, W) are the tile's: add them to the branch sum.
    __syncthreads();
    for (int idx = threadIdx.x; idx < tile * C; idx += kThreads) {
      const int i = idx / C, o = idx % C, t = t0 + i;
      if (t >= T) continue;
      float v = ld(hb[(H + i) * S + o]);
      if (b > 0) v = rnd<E>(ld(out[(size_t)t * C + o]) + v);
      if (b == m.n_branches - 1) v = v / (float)m.n_branches;
      out[(size_t)t * C + o] = st<E>(v);
    }
  }
  cp_async_wait<0>();
}

// cn: the output channels padded to the warps' n8 tiles (warps_n * nt * 8).
template <class E>
size_t smem_bytes(int tile, int halo, int C, int cn) {
  return sizeof(E) * (2 * (size_t)(halo + tile) * window_stride<E>(C) +
                      (size_t)kStages * kChunk<E> * ring_stride(cn));
}

template <class E, int NT>
int launch(const void* x, const void* w, const void* b, const void* alpha, float slope,
           void* out, int N, int T, int C, int tile, int warps_n, int vec, const LayerMeta& m,
           size_t smem, cudaStream_t stream) {
  static bool opted[64] = {};
  const cudaError_t err = opt_in_smem(res_fused_kernel<E, NT>, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, N);
  res_fused_kernel<E, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), static_cast<const E*>(b),
      static_cast<const E*>(alpha), slope, static_cast<E*>(out), T, C, tile, warps_n, vec, m);
  return (int)cudaGetLastError();
}

template <class E>
int res_fused(const void* x, const void* w, const void* b, const void* alpha, const int* meta,
              float slope, void* out, int N, int T, int C, int tile, int warps_n, int nt,
              int smem, void* stream) {
  LayerMeta m = {};
  m.n_branches = meta[0];
  m.per_branch = meta[1];
  m.n_convs = m.n_branches * m.per_branch;
  // The warp split must be one the kernel takes: warps_n side by side (a
  // divisor of the 8 warps) times nt n8 tiles each (an instantiated count)
  // covering the C channels.
  if (C < 1 || C > kMaxC || m.n_convs < 1 || m.n_convs > kMaxConvs || m.per_branch % 2 ||
      tile < 1 || N < 1 || T < 1 || warps_n < 1 || kWarps % warps_n || nt < 1 ||
      nt > Traits<E>::kMaxNT || warps_n * nt * 8 < C)
    return (int)cudaErrorInvalidValue;
  long long off = 0;
  for (int c = 0; c < m.n_convs; ++c) {
    m.k[c] = meta[2 + 3 * c];
    m.dil[c] = meta[3 + 3 * c];
    m.n_snake[c] = meta[4 + 3 * c];
    if (m.k[c] < 1 || m.dil[c] < 1) return (int)cudaErrorInvalidValue;
    m.w_off[c] = off;
    off += (long long)m.k[c] * C * C;
    m.branch_halo[c / m.per_branch] += (m.k[c] - 1) * m.dil[c];
  }
  for (int br = 0; br < m.n_branches; ++br) m.halo = max(m.halo, m.branch_halo[br]);
  const int W = m.halo + tile;
  const int pm = kWarps / warps_n * kWarpRows;
  int vec = 16;
  for (int br = 0; br < m.n_branches; ++br) {
    int lo = m.halo - m.branch_halo[br];
    for (int c = br * m.per_branch; c < (br + 1) * m.per_branch; ++c) {
      lo += (m.k[c] - 1) * m.dil[c];
      m.lo[c] = lo;
      m.passes[c] = (W - lo + pm - 1) / pm;
      const E* wc = static_cast<const E*>(w) + m.w_off[c];
      vec = min(vec, pick_vec<E>(wc, C, 0));
    }
  }
  const size_t need = smem_bytes<E>(tile, m.halo, C, warps_n * nt * 8);
  if ((size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1:
      return launch<E, 1>(x, w, b, alpha, slope, out, N, T, C, tile, warps_n, vec, m, need, st);
    case 2:
      return launch<E, 2>(x, w, b, alpha, slope, out, N, T, C, tile, warps_n, vec, m, need, st);
    case 4:
      return launch<E, 4>(x, w, b, alpha, slope, out, N, T, C, tile, warps_n, vec, m, need, st);
    case 7:
    case 8:
      if constexpr (std::is_same<E, __nv_bfloat16>::value) {
        if (nt == 7)
          return launch<E, 7>(x, w, b, alpha, slope, out, N, T, C, tile, warps_n, vec, m, need,
                              st);
        return launch<E, 8>(x, w, b, alpha, slope, out, N, T, C, tile, warps_n, vec, m, need,
                            st);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out [N, T, C]; w: the n_branches * per_branch convs' [k, C, C] (WIO)
// weights one after another, in branch order, each block's in-conv then its
// sk-conv; b, alpha [n_convs, C] (alpha read on each conv's first n_snake
// channels); meta (host memory): n_branches, per_branch, then (k, dilation,
// n_snake) per conv; tile (output rows a block), warps_n (warps side by
// side over the channels), nt (n8 tiles a warp holds) and smem (shared
// memory bytes): the wrapper's launch plan (ops/kernels/codec_res_fused.py).
// All tensors float32 (_f32) or bfloat16 (_bf16). Returns the CUDA error
// code of the launch (0 = success); a shape or plan the kernel does not take
// (C > 128, a warp split it has no instance of, a tile whose windows do not
// fit, another smem) is cudaErrorInvalidValue.
extern "C" int magpie_res_layer_fused_f32(const void* x, const void* w, const void* b,
                                          const void* alpha, const int* meta, float slope,
                                          void* out, int N, int T, int C, int tile,
                                          int warps_n, int nt, int smem, void* stream) {
  return res_fused<float>(x, w, b, alpha, meta, slope, out, N, T, C, tile, warps_n, nt, smem,
                          stream);
}
extern "C" int magpie_res_layer_fused_bf16(const void* x, const void* w, const void* b,
                                           const void* alpha, const int* meta, float slope,
                                           void* out, int N, int T, int C, int tile,
                                           int warps_n, int nt, int smem, void* stream) {
  return res_fused<__nv_bfloat16>(x, w, b, alpha, meta, slope, out, N, T, C, tile, warps_n, nt,
                                  smem, stream);
}
