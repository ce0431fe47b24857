// choco_fused: the two single-pass kernels of one fused CHOCO gossip round.
//
// Replaces repro/kernels/choco_fused.py::fused_encode_pallas
// (_fused_encode_kernel) and fused_mix_pallas (_fused_mix_kernel).
//
// What bounds them on the H100: memory.  A few flops per element against
//   fused_encode: theta_new, hat (leaf dtype) and xi (f32) read, hat_new
//                 (leaf dtype) and the (b+1)/8-byte payload written;
//   fused_mix:    K payloads of (b+1)/8 bytes and s (f32) read, s written;
// the floor is those bytes over 3.35 TB/s.  The design touches each byte
// once and never materialises the f32 residual, q_self or a per-neighbour
// decode in device memory:
//   * one thread owns one lane of one 8-row group of one node (the
//     [m, rows, 128] grid): loads coalesce along the 128 lanes, the group
//     yields `b` level bytes and one sign byte, as in csrc/quantize.cu;
//   * fused_encode forms the residual in the leaf dtype (one rounding, as
//     the reference's `tn - hat`), quantizes it with the node's scales, packs
//     it, and writes hat + dequant(q) back, cast once to the leaf dtype;
//   * the optional digest (int32 wraparound sum of hat_new's bits per node)
//     reduces inside each warp, then across the block's warps, and lands
//     with one atomicAdd per block and node -- blocks run in any order, and
//     wraparound addition commutes, so the sum equals the sequential one
//     exactly (one atomic per warp, 196,608 of them on 3 addresses at the
//     faulted round's chunk, ran the variant at 46% of its bound);
//   * fused_mix decodes each of the K payloads for its node straight from
//     the packed bytes.  The payload slab of shift k for node i is
//     k * kstride + (i - shift_k) mod m: kstride = m reads K stacked rolled
//     copies (the reference's signature), kstride = 0 reads the one
//     unrolled payload with the node offset, so the round never builds
//     rolled copies.  s may alias s_new (each element is read, then written,
//     by the same thread).
// Rounding follows the reference exactly: no FMA contraction (__fmul_rn /
// __fadd_rn, and the file builds with -fmad=false), IEEE operations only,
// the f32 accumulator filled in shift order and added to s last.
#include "common.cuh"

namespace repro {
namespace {

constexpr int LANES = 128;
constexpr int GROUP = 8;
constexpr int THREADS = 256;
constexpr int MAX_SHIFTS = 8;

struct Shifts {
  int k[MAX_SHIFTS];
};

// residual in the leaf dtype, then f32 (the reference's (tn - hat).astype(f32))
__device__ __forceinline__ float resid_of(float a, float h) { return __fsub_rn(a, h); }
__device__ __forceinline__ float resid_of(__nv_bfloat16 a, __nv_bfloat16 h) {
  return __bfloat162float(__float2bfloat16(__fsub_rn(__bfloat162float(a), __bfloat162float(h))));
}

// the stored value's raw bits, widened to int32 as core.faults.digest does
__device__ __forceinline__ uint32_t digest_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t digest_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(__bfloat16_as_short(v))));
}

template <typename T, int BITS, bool DIGEST>
__global__ void __launch_bounds__(THREADS)
fused_encode_kernel(const T* __restrict__ tn, const T* __restrict__ hat,
                    const float* __restrict__ xi, const float* __restrict__ scales,
                    uint8_t* __restrict__ lvl, uint8_t* __restrict__ sign,
                    T* __restrict__ hat_new, int32_t* __restrict__ digest, long long groups,
                    long long total) {
  constexpr int PACK = 8 / BITS;
  constexpr float MAXLVL = static_cast<float>((1 << BITS) - 1);
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  uint32_t part = 0u;
  int node = 0;
  if (t < total) {
    const long long per_node = groups * LANES;
    node = static_cast<int>(t / per_node);
    const long long within = t % per_node;
    const long long g = within / LANES;
    const int lane = static_cast<int>(within % LANES);
    const float enc = scales[2 * node];
    const float deq = scales[2 * node + 1];
    const long long base = static_cast<long long>(node) * groups * GROUP * LANES;

    uint32_t bytes[BITS];
#pragma unroll
    for (int b = 0; b < BITS; ++b) bytes[b] = 0u;
    uint32_t sbyte = 0u;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const long long idx = base + (g * GROUP + j) * LANES + lane;
      const T h = hat[idx];
      const float r = resid_of(tn[idx], h);
      const float q = floorf(__fadd_rn(__fmul_rn(fabsf(r), enc), xi[idx]));
      const float l = fminf(fmaxf(q, 0.f), MAXLVL);
      const bool neg = r < 0.f;
      bytes[j / PACK] |= static_cast<uint32_t>(l) << ((j % PACK) * BITS);
      sbyte |= static_cast<uint32_t>(neg) << j;
      const float mag = __fmul_rn(l, deq);
      const T stored = from_float<T>(__fadd_rn(to_float(h), neg ? -mag : mag));
      hat_new[idx] = stored;
      if constexpr (DIGEST) part += digest_bits(stored);
    }
    const long long pbase = static_cast<long long>(node) * groups;
#pragma unroll
    for (int b = 0; b < BITS; ++b)
      lvl[((pbase + g) * BITS + b) * LANES + lane] = static_cast<uint8_t>(bytes[b]);
    sign[(pbase + g) * LANES + lane] = static_cast<uint8_t>(sbyte);
  }
  if constexpr (DIGEST) {
    // a warp never straddles two nodes (a node owns a multiple of 128
    // threads) and lies wholly before or past `total`; a block may straddle
    // two nodes, so thread 0 adds its warps' sums node by node
    constexpr int WARPS = THREADS / 32;
    __shared__ uint32_t warp_sum[WARPS];
    __shared__ int warp_node[WARPS];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((threadIdx.x & 31) == 0) {
      warp_sum[threadIdx.x >> 5] = part;
      warp_node[threadIdx.x >> 5] = t < total ? node : -1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t acc = 0u;
      int cur = -1;
      for (int w = 0; w < WARPS; ++w) {
        if (warp_node[w] < 0) continue;
        if (warp_node[w] != cur) {
          if (cur >= 0) atomicAdd(reinterpret_cast<unsigned int*>(digest + cur), acc);
          cur = warp_node[w];
          acc = 0u;
        }
        acc += warp_sum[w];
      }
      if (cur >= 0) atomicAdd(reinterpret_cast<unsigned int*>(digest + cur), acc);
    }
  }
}

template <typename S, int BITS>
__global__ void __launch_bounds__(THREADS)
fused_mix_kernel(const uint8_t* __restrict__ lvl, const uint8_t* __restrict__ sign,
                 const S* s, const float* __restrict__ wscale, S* s_new, Shifts shifts,
                 int nshifts, int m, int kstride, long long groups, long long total) {
  constexpr int PACK = 8 / BITS;
  constexpr uint32_t MAXLVL = (1u << BITS) - 1u;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long per_node = groups * LANES;
  const int node = static_cast<int>(t / per_node);
  const long long within = t % per_node;
  const long long g = within / LANES;
  const int lane = static_cast<int>(within % LANES);

  float acc[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) acc[j] = 0.f;
  for (int k = 0; k < nshifts; ++k) {
    int src = (node - shifts.k[k]) % m;
    if (src < 0) src += m;
    const long long slab = static_cast<long long>(k) * kstride + src;
    const float w = wscale[k * m + node];
    uint32_t bytes[BITS];
#pragma unroll
    for (int b = 0; b < BITS; ++b) bytes[b] = lvl[((slab * groups + g) * BITS + b) * LANES + lane];
    const uint32_t sbyte = sign[(slab * groups + g) * LANES + lane];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const uint32_t l = (bytes[j / PACK] >> ((j % PACK) * BITS)) & MAXLVL;
      const float mag = __fmul_rn(static_cast<float>(l), w);
      acc[j] = __fadd_rn(acc[j], ((sbyte >> j) & 1u) ? -mag : mag);
    }
  }
  const long long base = static_cast<long long>(node) * groups * GROUP * LANES;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const long long idx = base + (g * GROUP + j) * LANES + lane;
    s_new[idx] = from_float<S>(__fadd_rn(to_float(s[idx]), acc[j]));
  }
}

inline unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + THREADS - 1) / THREADS);
}

template <typename T, bool DIGEST>
int encode_bits(int bits, const void* tn, const void* hat, const void* xi, const void* scales,
                void* lvl, void* sign, void* hat_new, void* digest, long long groups,
                long long total, cudaStream_t st) {
#define REPRO_ENCODE(B)                                                                   \
  fused_encode_kernel<T, B, DIGEST><<<blocks_for(total), THREADS, 0, st>>>(              \
      static_cast<const T*>(tn), static_cast<const T*>(hat), static_cast<const float*>(xi), \
      static_cast<const float*>(scales), static_cast<uint8_t*>(lvl),                      \
      static_cast<uint8_t*>(sign), static_cast<T*>(hat_new), static_cast<int32_t*>(digest), \
      groups, total)
  switch (bits) {
    case 1: REPRO_ENCODE(1); break;
    case 2: REPRO_ENCODE(2); break;
    case 4: REPRO_ENCODE(4); break;
    case 8: REPRO_ENCODE(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ENCODE
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int mix_bits(int bits, const void* lvl, const void* sign, const void* s, const void* wscale,
             void* s_new, const Shifts& sh, int nshifts, int m, int kstride, long long groups,
             long long total, cudaStream_t st) {
#define REPRO_MIX(B)                                                                      \
  fused_mix_kernel<S, B><<<blocks_for(total), THREADS, 0, st>>>(                          \
      static_cast<const uint8_t*>(lvl), static_cast<const uint8_t*>(sign),                \
      static_cast<const S*>(s), static_cast<const float*>(wscale), static_cast<S*>(s_new), sh, \
      nshifts, m, kstride, groups, total)
  switch (bits) {
    case 1: REPRO_MIX(1); break;
    case 2: REPRO_MIX(2); break;
    case 4: REPRO_MIX(4); break;
    case 8: REPRO_MIX(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MIX
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// tn, hat, hat_new: [m, rows, 128] (dtype 0 = f32, 1 = bf16); xi: [m, rows,
// 128] f32; scales: [m, 2] f32 (encode, dequant); lvl: [m, rows*bits/8, 128]
// u8; sign: [m, rows/8, 128] u8; digest: [m] int32, zeroed, or null.
extern "C" int repro_fused_encode(const void* tn, const void* hat, const void* xi,
                                  const void* scales, void* lvl, void* sign, void* hat_new,
                                  void* digest, int dtype, int m, long long rows, int bits,
                                  void* stream) {
  using namespace repro;
  if (m <= 0 || rows <= 0 || rows % GROUP != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = rows / GROUP;
  const long long total = static_cast<long long>(m) * groups * LANES;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dig = digest != nullptr;
  if (dtype == DT_F32)
    return dig ? encode_bits<float, true>(bits, tn, hat, xi, scales, lvl, sign, hat_new, digest,
                                          groups, total, st)
               : encode_bits<float, false>(bits, tn, hat, xi, scales, lvl, sign, hat_new,
                                           digest, groups, total, st);
  if (dtype == DT_BF16)
    return dig ? encode_bits<__nv_bfloat16, true>(bits, tn, hat, xi, scales, lvl, sign, hat_new,
                                                  digest, groups, total, st)
               : encode_bits<__nv_bfloat16, false>(bits, tn, hat, xi, scales, lvl, sign,
                                                   hat_new, digest, groups, total, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// lvl: [slabs, rows*bits/8, 128] u8; sign: [slabs, rows/8, 128] u8; s, s_new:
// [m, rows, 128] (dtype 0 = f32, 1 = bf16; may alias); wscale: [nshifts, m]
// f32; shifts: nshifts host ints.  Shift k of node i reads payload slab
// k * kstride + (i - shifts[k]) mod m.
extern "C" int repro_fused_mix(const void* lvl, const void* sign, const void* s,
                               const void* wscale, void* s_new, const int* shifts, int nshifts,
                               int kstride, int dtype, int m, long long rows, int bits,
                               void* stream) {
  using namespace repro;
  if (m <= 0 || rows <= 0 || rows % GROUP != 0 || nshifts < 1 || nshifts > MAX_SHIFTS)
    return static_cast<int>(cudaErrorInvalidValue);
  Shifts sh{};
  for (int k = 0; k < nshifts; ++k) sh.k[k] = shifts[k];
  const long long groups = rows / GROUP;
  const long long total = static_cast<long long>(m) * groups * LANES;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return mix_bits<float>(bits, lvl, sign, s, wscale, s_new, sh, nshifts, m, kstride, groups,
                           total, st);
  if (dtype == DT_BF16)
    return mix_bits<__nv_bfloat16>(bits, lvl, sign, s, wscale, s_new, sh, nshifts, m, kstride,
                                   groups, total, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
