// Kernels 14 and 18: the H100 counterparts of the TPU's attend probes,
// scripts/opt_int8_attend_probe.py build (modes bf16, i8mixed, i8cast) and
// scripts/opt_attend_probe.py build (orientations cur and tr): one query row
// per slot, H heads of 64 columns, attending over the first `rows` rows of the
// slot's K / V cache [G, S, D]. Each launch ADDS its attend to out [G, D]
// (float32): the TPU kernel's `iters` grid steps over a resident cache become
// `iters` launches.
//
// The Pallas kernels' rounding points are kept: the query is bf16 (masked per
// head, exact); scores are float32 sums of exact products, scaled by
// inv = 1 / sqrt(64) (i8mixed: by s_k[r] * inv, formed first); the softmax over
// rows is float32 (max, exp, sum, divide); the probabilities are rounded to
// bf16 (i8mixed: after the product with s_v[r]); P V sums in float32. i8cast
// dequantizes every K / V value as float(int8) * s, rounded to bf16, before
// either dot; i8mixed reads the int8 values themselves (exact as floats) and
// folds the scales into the [rows] vectors.
//
// Two work decompositions of the same function (bf16):
//   tr  (also the int8 modes): a block per (head, slot); warps walk the rows,
//       a warp scoring one row from its head's 64-wide slice (128 B in bf16,
//       64 B in int8), as kernel C's attention does today;
//   cur: a block per slot; a warp scores one row for all H heads from one
//       contiguous D-wide read (16 B a lane), and P V reads whole rows.
// What bounds it on the card: bytes, K and V read once: rows x D x 2 x 2 B
// per slot in bf16 (7.9 MB at 320 rows for 8 slots, 2.35 us at 3.35 TB/s),
// half that in int8 plus 8 B of scales a row. Neither form splits rows across
// blocks, so one slot's rows stream through one SM (tr: 12 SMs a slot; cur:
// 1), which is what the probe measures.

#include "common.cuh"

namespace {

constexpr int kDh = 64;            // columns per head
constexpr int kTrThreads = 256;    // tr: 8 warps walk the rows
constexpr int kTrGroups = kTrThreads / kDh;

enum Mode { kBf16 = 0, kMixed = 1, kCast = 2 };

template <class KV>
__device__ __forceinline__ float2 load2(const KV* p);
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<signed char>(const signed char* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}
__device__ __forceinline__ float load1(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load1(signed char v) { return (float)v; }

// A K / V value as the mode's dot sees it: i8cast dequantizes and rounds.
template <int MODE>
__device__ __forceinline__ float kv_value(float v, const float* s, int r) {
  return MODE == kCast ? rnd<__nv_bfloat16>(v * s[r]) : v;
}

// Grid (H, G), kTrThreads threads; dynamic shared memory (rows + kTrThreads)
// floats.
template <class KV, int MODE>
__global__ void __launch_bounds__(kTrThreads)
attend_tr_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ K,
                 const KV* __restrict__ V, const float* __restrict__ sk,
                 const float* __restrict__ sv, float* __restrict__ out, int S, int D, int rows,
                 float inv) {
  extern __shared__ float sm[];
  float* sc = sm;              // [rows]
  float* acc = sm + rows;      // [kTrThreads]
  __shared__ float qs[kDh];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kTrThreads / 32;
  const int off = h * kDh;
  K += (size_t)b * S * D;
  V += (size_t)b * S * D;
  if (MODE != kBf16) {
    sk += (size_t)b * S;
    sv += (size_t)b * S;
  }
  if (tid < kDh) qs[tid] = __bfloat162float(q[(size_t)b * D + off + tid]);
  __syncthreads();
  for (int r = warp; r < rows; r += nw) {
    const float2 kk = load2<KV>(K + (size_t)r * D + off + 2 * lane);
    const float k0 = kv_value<MODE>(kk.x, sk, r), k1 = kv_value<MODE>(kk.y, sk, r);
    float dot = fmaf(qs[2 * lane + 1], k1, qs[2 * lane] * k0);
    dot = warp_sum(dot);
    if (lane == 0) sc[r] = MODE == kMixed ? dot * (sk[r] * inv) : dot * inv;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int r = tid; r < rows; r += kTrThreads) m = fmaxf(m, sc[r]);
  m = block_max(m, red);
  float s = 0.f;
  for (int r = tid; r < rows; r += kTrThreads) {
    const float e = expf(sc[r] - m);
    sc[r] = e;
    s += e;
  }
  s = block_sum(s, red);
  for (int r = tid; r < rows; r += kTrThreads) {
    const float p = sc[r] / s;
    sc[r] = rnd<__nv_bfloat16>(MODE == kMixed ? p * sv[r] : p);
  }
  __syncthreads();
  const int d = tid % kDh, g = tid / kDh;
  float a = 0.f;
  for (int r = g; r < rows; r += kTrGroups) {
    a = fmaf(sc[r], kv_value<MODE>(load1(V[(size_t)r * D + off + d]), sv, r), a);
  }
  acc[tid] = a;
  __syncthreads();
  if (tid < kDh) {
    float o = acc[tid];
    for (int k = 1; k < kTrGroups; ++k) o += acc[k * kDh + tid];
    out[(size_t)b * D + off + tid] += o;
  }
}

// Grid (G), D threads (a warp per row while scoring, a thread per column
// pair and row parity in P V); dynamic shared memory (D + H * rows + 2 * D)
// floats. bf16 K / V only.
__global__ void __launch_bounds__(1024)
attend_cur_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ K,
                  const __nv_bfloat16* __restrict__ V, float* __restrict__ out, int S, int D,
                  int rows, float inv) {
  extern __shared__ float sm[];
  const int H = D / kDh;
  float* qs = sm;                  // [D]
  float* sc = sm + D;              // [H][rows]
  float* acc = sc + H * rows;      // [2][D]
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  K += (size_t)b * S * D;
  V += (size_t)b * S * D;
  for (int i = tid; i < D; i += blockDim.x) qs[i] = __bfloat162float(q[(size_t)b * D + i]);
  __syncthreads();
  // A lane covers 8 columns of each 256-wide third: heads 4j + lane / 8.
  for (int r = warp; r < rows; r += nw) {
    const __nv_bfloat16* kr = K + (size_t)r * D;
    for (int j = 0; j < D / 256; ++j) {
      const int c0 = j * 256 + lane * 8;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + c0));
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const unsigned bits = (t & 1) ? (words[t >> 1] & 0xffff0000u) : (words[t >> 1] << 16);
        dot = fmaf(qs[c0 + t], __uint_as_float(bits), dot);
      }
      dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 1);
      dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 2);
      dot += __shfl_xor_sync(MAGPIE_FULL_MASK, dot, 4);
      if ((lane & 7) == 0) sc[(j * 4 + lane / 8) * rows + r] = dot * inv;
    }
  }
  __syncthreads();
  // Softmax: warp h takes head h.
  for (int h = warp; h < H; h += nw) {
    float* sh = sc + h * rows;
    float m = -INFINITY;
    for (int r = lane; r < rows; r += 32) m = fmaxf(m, sh[r]);
    m = warp_max(m);
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(sh[r] - m);
      sh[r] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int r = lane; r < rows; r += 32) sh[r] = rnd<__nv_bfloat16>(sh[r] / s);
  }
  __syncthreads();
  const int pairs = D / 2;
  if (tid < 2 * pairs) {
    const int cp = tid % pairs, g = tid / pairs, h = (2 * cp) / kDh;
    const float* ph = sc + h * rows;
    float a0 = 0.f, a1 = 0.f;
    for (int r = g; r < rows; r += 2) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(V + (size_t)r * D + 2 * cp));
      a0 = fmaf(ph[r], v.x, a0);
      a1 = fmaf(ph[r], v.y, a1);
    }
    acc[g * D + 2 * cp] = a0;
    acc[g * D + 2 * cp + 1] = a1;
  }
  __syncthreads();
  for (int i = tid; i < D; i += blockDim.x) out[(size_t)b * D + i] += acc[i] + acc[D + i];
}

constexpr int kSmemLimit = 48 * 1024;

template <class KV, int MODE>
int attend_tr(const void* q, const void* k, const void* v, const float* sk, const float* sv,
              float* out, int G, int S, int D, int rows, float inv, void* stream) {
  const int smem = (rows + kTrThreads) * (int)sizeof(float);
  if (G < 1 || G > 65535 || D % kDh || D / kDh < 1 || rows < 1 || rows > S ||
      smem > kSmemLimit || (MODE != kBf16 && (!sk || !sv))) {
    return (int)cudaErrorInvalidValue;
  }
  attend_tr_kernel<KV, MODE><<<dim3(D / kDh, G), kTrThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), sk, sv, out, S, D, rows, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// q [G, D] bf16; k, v [G, S, D] (bf16, or int8 for the i8 modes); sk, sv
// [G, S] float32 (the i8 modes' per-row scales; null for bf16); out [G, D]
// float32, to which the attend over rows [0, rows) is added.
extern "C" int magpie_probe_attend_tr(const void* q, const void* k, const void* v, float* out,
                                      int G, int S, int D, int rows, float inv, void* stream) {
  return attend_tr<__nv_bfloat16, kBf16>(q, k, v, nullptr, nullptr, out, G, S, D, rows, inv,
                                         stream);
}
extern "C" int magpie_probe_attend_i8mixed(const void* q, const void* k, const void* v,
                                           const float* sk, const float* sv, float* out, int G,
                                           int S, int D, int rows, float inv, void* stream) {
  return attend_tr<signed char, kMixed>(q, k, v, sk, sv, out, G, S, D, rows, inv, stream);
}
extern "C" int magpie_probe_attend_i8cast(const void* q, const void* k, const void* v,
                                          const float* sk, const float* sv, float* out, int G,
                                          int S, int D, int rows, float inv, void* stream) {
  return attend_tr<signed char, kCast>(q, k, v, sk, sv, out, G, S, D, rows, inv, stream);
}
extern "C" int magpie_probe_attend_cur(const void* q, const void* k, const void* v, float* out,
                                       int G, int S, int D, int rows, float inv, void* stream) {
  const int smem = (D + (D / kDh) * rows + 2 * D) * (int)sizeof(float);
  if (G < 1 || G > 65535 || D % 256 || D > 1024 || rows < 1 || rows > S || smem > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  attend_cur_kernel<<<G, D, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, S, D, rows, inv);
  return (int)cudaGetLastError();
}
