// block_topk: per-row top-k masking by threshold bisection -- the TPU form of
// the paper's top-K compression, kept as the reference computes it.
//
// Replaces repro/kernels/topk.py::block_topk_pallas (_block_topk_kernel).
//
// Each row of x [rows, block] f32 is masked to its k largest magnitudes by
// BISECT rounds of: mid = 0.5 * (lo + hi) on [0, max|x|], count |x| >= mid,
// move lo up when the count exceeds k, else hi down; then keep |x| >= hi and
// write x * (float)keep.  Ties at the threshold are all kept (a row may keep
// more than k), an all-zero row keeps its zeros, and a dropped negative
// element comes out as -0.0, exactly as the reference.
//
// What bounds it on the H100: memory.  One read and one write of 4 bytes per
// element (8 B/element), so the floor is 8 B/element over 3.35 TB/s; 20
// compare-and-count rounds over every element (~2 instructions per element
// each) would cost about that floor again in issue, so the rounds must be
// cheap and run while loads are in flight.  The design:
//   * persistent CTAs (as many as fit on the SMs at once), each warp walking
//     rows warp, warp + W, ... (W warps in the grid); one warp owns one row,
//     held in registers, lane l holding 16-byte chunks l + 32 j (4-byte
//     elements l + 32 j when the row is not a whole number of chunks);
//   * the next two rows stream into a per-warp 2-stage shared-memory ring by
//     cp.async while the current row bisects: each lane copies exactly the
//     elements it will read, so the ring needs no barrier, only
//     cp.async.wait_group; the stage is refilled once its values are in
//     registers;
//   * the max and every round's count are one redux.sync each (max on the
//     bits of |x|, which order as the values); padding lanes hold NaN, which
//     no comparison counts;
//   * after FULL_ROUNDS rounds over the whole row, only elements in the band
//     [lo, hi) can still fall on either side of a later mid (every later mid
//     lies in [lo, hi]): each lane lists its band elements (at most BAND) in
//     shared memory, and the remaining rounds count c_hi = #{|x| >= hi} plus
//     the band's count, a few compares per lane instead of one per element.
//     The counts are the same integers, so lo and hi take the same values.
//     A row whose band is too wide for the lists (many ties) stays on full
//     rounds;
//   * max and integer sums are order-independent, so the threshold -- and
//     the mask -- equal the plain version's bit for bit.  mid is spelled
//     add-then-multiply (__fadd_rn, __fmul_rn) and the file builds with
//     -fmad=false;
//   * the masked row goes out in 16-byte stores.
#include "common.cuh"

namespace repro {
namespace {

constexpr int WARPS = 4;  // warps per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;
constexpr unsigned FULL_MASK = 0xffffffffu;
// rounds over the whole row before the band is listed: enough that a
// Gaussian-like row's band averages under one element per lane
template <int VPL> constexpr int FULL_ROUNDS = VPL > 32 ? 7 : 6;
constexpr int BAND = 4;  // band elements per lane that the later rounds take

// #{|v| >= t} over the warp's row (NaN padding never counts)
template <int VPL>
__device__ __forceinline__ unsigned count_at_least(const float (&v)[VPL], float t) {
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) c += fabsf(v[j]) >= t ? 1u : 0u;
  return __reduce_add_sync(FULL_MASK, c);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// VPL values per lane; V4: 16-byte chunks (block % 4 == 0, x and out 16-byte
// aligned), else 4-byte elements.  Lane l's value (j, e) is element
// 4 * (l + 32 j) + e (V4) or l + 32 j.
template <int VPL, bool V4>
__global__ void __launch_bounds__(THREADS)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                  int block, int k, int iters) {
  constexpr int W = V4 ? 4 : 1;  // floats per copy
  constexpr int NJ = VPL / W;    // copies per lane per row
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  // this lane's slots: [stage][j][lane] in units of W floats
  float* mine = ring + (static_cast<long long>(wib) * STAGES * NJ * 32 + lane) * W;
  // this lane's band list: BAND slots 32 floats apart, after all the rings
  float* band = ring + WARPS * STAGES * VPL * 32 + (wib * BAND) * 32 + lane;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  const float qnan = __int_as_float(0x7fc00000);

  auto issue = [&](long long row, int s) {
    if (row < rows) {
      const float* xr = x + row * block;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int i = (lane + 32 * j) * W;
        float* dst = mine + (s * NJ + j) * 32 * W;
        if (i < block) {
          if constexpr (V4) {
            cp_async16(dst, xr + i);
          } else {
            cp_async4(dst, xr + i);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the last row keeps the count
  };

  long long row = static_cast<long long>(blockIdx.x) * WARPS + wib;
  issue(row, 0);
  issue(row + stride, 1);
  for (int s = 0; row < rows; row += stride, s ^= 1) {
    cp_async_wait_one_pending();  // this row's group has landed
    float v[VPL];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = (lane + 32 * j) * W;
      const float* src = mine + (s * NJ + j) * 32 * W;
      if (i < block) {
        if constexpr (V4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          v[4 * j] = t.x;
          v[4 * j + 1] = t.y;
          v[4 * j + 2] = t.z;
          v[4 * j + 3] = t.w;
        } else {
          v[j] = *src;
        }
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[W * j + e] = qnan;  // never counted, never the max
      }
    }
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) mx = fmaxf(mx, fabsf(v[j]));
    mx = __uint_as_float(__reduce_max_sync(FULL_MASK, __float_as_uint(mx)));
    issue(row + 2 * stride, s);  // the stage's values are in registers now

    float lo = 0.f, hi = mx;
    unsigned c_hi = 0;  // #{|x| >= hi}, once a round has moved hi
    bool hi_moved = false;
    int it = 0;
    for (; it < iters && it < FULL_ROUNDS<VPL>; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const unsigned cnt = count_at_least<VPL>(v, mid);
      if (cnt > static_cast<unsigned>(k)) {
        lo = mid;
      } else {
        hi = mid;
        c_hi = cnt;
        hi_moved = true;
      }
    }
    if (it < iters) {
      // Every later mid lies in [lo, hi]: elements >= hi count in every later
      // round, elements < lo in none, so a count is c_hi plus the count over
      // the band [lo, hi).  Each lane lists its band elements in shared
      // memory; if no lane has more than BAND, the rounds go on over those.
      if (!hi_moved) c_hi = count_at_least<VPL>(v, hi);
      unsigned nb = 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const float a = fabsf(v[j]);
        if (a >= lo && a < hi) {
          if (nb < BAND) band[nb * 32] = a;
          ++nb;
        }
      }
      // (below 1e38, lo + hi cannot overflow, so every later mid is in [lo, hi])
      if (__reduce_max_sync(FULL_MASK, nb) <= BAND && hi < 1e38f) {
        float bv[BAND];
#pragma unroll
        for (int c = 0; c < BAND; ++c) bv[c] = c < static_cast<int>(nb) ? band[c * 32] : -1.f;
        for (; it < iters; ++it) {
          const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
          unsigned cnt = 0;
#pragma unroll
          for (int c = 0; c < BAND; ++c) cnt += bv[c] >= mid ? 1u : 0u;
          cnt = c_hi + __reduce_add_sync(FULL_MASK, cnt);
          if (cnt > static_cast<unsigned>(k)) {
            lo = mid;
          } else {
            hi = mid;
          }
        }
      }
      for (; it < iters; ++it) {  // a band too wide for the lists (many ties)
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        if (count_at_least<VPL>(v, mid) > static_cast<unsigned>(k)) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
    }
    float* orow = out + row * block;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = (lane + 32 * j) * W;
      if (i < block) {
        float r[W];
#pragma unroll
        for (int e = 0; e < W; ++e)
          r[e] = __fmul_rn(v[W * j + e], fabsf(v[W * j + e]) >= hi ? 1.f : 0.f);
        if constexpr (V4) {
          *reinterpret_cast<float4*>(orow + i) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
          orow[i] = r[0];
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int VPL, bool V4>
cudaError_t launch(const float* x, float* out, long long rows, int block, int k, int iters,
                   cudaStream_t st) {
  // resident CTAs per SM and SMs, per device, found once
  static int ctas_per_sm[MAX_DEVICES], sms[MAX_DEVICES];
  const size_t smem = sizeof(float) * WARPS * 32 * (STAGES * VPL + BAND);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ctas_per_sm[dev] == 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(block_topk_kernel<VPL, V4>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, block_topk_kernel<VPL, V4>, THREADS,
                                                        smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    ctas_per_sm[dev] = n > 0 ? n : 1;
  }
  const long long need = (rows + WARPS - 1) / WARPS;
  const long long resident = static_cast<long long>(ctas_per_sm[dev]) * sms[dev];
  const unsigned grid = static_cast<unsigned>(need < resident ? need : resident);
  block_topk_kernel<VPL, V4><<<grid, THREADS, smem, st>>>(x, out, rows, block, k, iters);
  return cudaGetLastError();
}

template <bool V4>
cudaError_t dispatch(const float* x, float* out, long long rows, int block, int k, int iters,
                     cudaStream_t st) {
  if (block <= 128) return launch<4, V4>(x, out, rows, block, k, iters, st);
  if (block <= 256) return launch<8, V4>(x, out, rows, block, k, iters, st);
  if (block <= 512) return launch<16, V4>(x, out, rows, block, k, iters, st);
  if (block <= 1024) return launch<32, V4>(x, out, rows, block, k, iters, st);
  return launch<64, V4>(x, out, rows, block, k, iters, st);
}

}  // namespace
}  // namespace repro

// x, out: [rows, block] f32, contiguous; 1 <= block <= 2048; k >= 1.
extern "C" int repro_block_topk(const void* x, void* out, long long rows, int block, int k,
                                int iters, void* stream) {
  using namespace repro;
  if (rows <= 0 || block < 1 || block > 2048 || k < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const bool v4 = block % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return static_cast<int>(v4 ? dispatch<true>(xp, op, rows, block, k, iters, st)
                             : dispatch<false>(xp, op, rows, block, k, iters, st));
}
