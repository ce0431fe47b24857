// moe_dispatch: the MoE layer's dispatch gather and its gradient -- each
// capacity slot's token row copied into the expert-major [E, G*C, d] buffer
// that the expert products take, and back, each token's kept slot rows
// summed into its gradient row.
//
// Replaces no TPU kernel: the reference dispatches with XLA's gather
// (repro/models/moe.py, `x_pad[src_tok]`).  The port did the same through
// autograd, `cat([x, zeros(1, d)])[arange(G), src_tok]`, whose backward is
// `index_put_(accumulate=True)`: on CUDA a radix sort of the E*C slot
// indices, then one block walking every duplicate of an index in series.
// Every empty slot points at the one zero pad row `T`, so at deepseek-moe-16b's
// B4 x S2048 (T 8192, K 6, E 64, C 960: 61,440 slots for at most 49,152 kept
// assignments) one block summed >= 12,288 rows of 4 KB one after another
// into a gradient row that is thrown away: ~46 ms a call, against a bound of
// well under a millisecond.
//
// What bounds it on the H100: memory; there is no arithmetic but the
// backward's adds.  The forward reads each kept token row once and writes
// E*G*C rows (cell B4 x S2048: <= 49,152 rows read, 61,440 written, 2048
// bf16 each, 453 MB); the backward reads each token's kept slot rows and
// writes G*T rows (<= 49,152 read, 8,192 written, 235 MB).  The floor is
// those bytes over 3.35 TB/s.  The design:
//   * forward, a row copy: one warp per output row reads the slot's token
//     index once and copies the row in 16-byte vectors (a few loads in
//     flight per lane before the stores), or writes zeros for an empty slot
//     -- no pad row, no `cat`, and with G > 1 no transpose copy after;
//   * backward, a per-token gather-sum: one warp per token row; its lanes
//     k < K hold the grad row of the token's k-th slot (the caller gives the
//     slots in ascending expert order), and each lane sums its 16-byte
//     column of those rows in f32, in that order, rounding once to the
//     output type.  No sort, no atomics, no pad row: two runs give the
//     same bits, and each token is written once.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;   // 16-byte loads in flight per lane in the copy
constexpr int MAX_K = 32;   // a token's slots, one per lane

// out[e, g*C + c, :] = x[g, src_tok[g, e, c], :], or zeros where the index
// is outside [0, T) (the empty slot's T).  Rows are `vecs` 16-byte vectors.
__global__ void __launch_bounds__(THREADS)
dispatch_kernel(const uint4* __restrict__ x, const long long* __restrict__ src_tok,
                uint4* __restrict__ out, long long rows, int G, int T, int E, int C,
                int vecs) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long gc = static_cast<long long>(G) * C;
  const long long e = row / gc;
  const long long g = (row % gc) / C;
  const long long c = row % C;
  const long long tok = src_tok[(g * E + e) * C + c];
  uint4* dst = out + row * vecs;
  if (tok < 0 || tok >= T) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int v = lane; v < vecs; v += 32) dst[v] = zero;
    return;
  }
  const uint4* src = x + (g * T + tok) * vecs;
  for (int v0 = lane; v0 < vecs; v0 += 32 * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + 32 * u;
      if (v < vecs) buf[u] = src[v];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + 32 * u;
      if (v < vecs) dst[v] = buf[u];
    }
  }
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return raw;
  }
};

// gx[g, t, :] = sum over k in order, kept[g, t, k], of grad[row(slot[g, t, k])]
// in f32, rounded once; row(s) = (s / C) * G*C + g*C + s % C of [E, G*C, d].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dispatch_backward_kernel(const T* __restrict__ grad, const long long* __restrict__ slot,
                         const bool* __restrict__ kept, T* __restrict__ gx, long long tokens,
                         int Tn, int G, int C, int K, int d) {
  constexpr int N = Vec<T>::N;
  __shared__ long long grad_rows[WARPS][MAX_K];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long tok = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (tok >= tokens) return;
  const long long g = tok / Tn;
  if (lane < K) {
    long long r = -1;
    if (kept[tok * K + lane]) {
      const long long s = slot[tok * K + lane];
      r = (s / C) * G * C + g * C + s % C;
    }
    grad_rows[warp][lane] = r;
  }
  __syncwarp();
  const int vecs = d / N;
  for (int v = lane; v < vecs; v += 32) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const long long r = grad_rows[warp][k];
      if (r < 0) continue;
      float f[N];
      load_as_float<T, N>(grad + r * d + static_cast<long long>(v) * N, f);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
    }
    reinterpret_cast<uint4*>(gx + tok * d)[v] = Vec<T>::pack(acc);
  }
}

inline unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + WARPS - 1) / WARPS);
}

}  // namespace
}  // namespace repro

// x: [G, T, d] (any dtype; a row is `row_bytes`, a multiple of 16); src_tok:
// [G, E, C] int64; out: [E, G*C, d].  Pointers 16-byte aligned.
extern "C" int repro_moe_dispatch(const void* x, const void* src_tok, void* out, int G, int T,
                                  int E, int C, long long row_bytes, void* stream) {
  using namespace repro;
  if (G <= 0 || T <= 0 || E <= 0 || C <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(E) * G * C;
  dispatch_kernel<<<blocks_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const long long*>(src_tok),
      static_cast<uint4*>(out), rows, G, T, E, C, static_cast<int>(row_bytes / 16));
  return static_cast<int>(cudaGetLastError());
}

// grad: [E, G*C, d]; slot: [G, T, K] int64 (flat slot e*C + c of group g,
// each token's in ascending expert order); kept: [G, T, K] bool; gx:
// [G, T, d].  dtype: DT_F32 or DT_BF16; d % 8 == 0; K <= 32.
extern "C" int repro_moe_dispatch_backward(const void* grad, const void* slot, const void* kept,
                                           void* gx, int G, int T, int C, int K, int d,
                                           int dtype, void* stream) {
  using namespace repro;
  if (G <= 0 || T <= 0 || C <= 0 || K <= 0 || K > MAX_K || d <= 0 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tokens = static_cast<long long>(G) * T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(slot);
  const bool* kp = static_cast<const bool*>(kept);
  switch (dtype) {
    case DT_F32:
      dispatch_backward_kernel<float><<<blocks_for(tokens), THREADS, 0, st>>>(
          static_cast<const float*>(grad), sp, kp, static_cast<float*>(gx), tokens, T, G, C, K,
          d);
      break;
    case DT_BF16:
      dispatch_backward_kernel<__nv_bfloat16><<<blocks_for(tokens), THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(grad), sp, kp, static_cast<__nv_bfloat16*>(gx),
          tokens, T, G, C, K, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
