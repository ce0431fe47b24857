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
// element (8 B/element); the 20 compare-and-count rounds run on values held
// in registers, so the floor is 8 B/element over 3.35 TB/s.  The design:
//   * one warp owns one row: lane l holds elements l + 32*j (j < VPL) in
//     registers, so the row is read once (each warp load covers 128
//     consecutive bytes) and written once;
//   * the max and every round's count are warp-shuffle reductions: no shared
//     memory, no block barrier; max and integer sums are order-independent,
//     so the threshold -- and the mask -- equal the plain version's bit for
//     bit.  mid is spelled add-then-multiply (__fadd_rn, __fmul_rn) and the
//     file builds with -fmad=false.
#include "common.cuh"

namespace repro {
namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int VPL>
__global__ void __launch_bounds__(THREADS)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                  int block, int k, int iters) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* xr = x + row * block;
  float v[VPL];
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < block ? xr[i] : 0.f;
    mx = fmaxf(mx, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));

  float lo = 0.f, hi = mx;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VPL; ++j) cnt += (lane + 32 * j < block && fabsf(v[j]) >= mid) ? 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL_MASK, cnt, off);
    if (cnt > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float* orow = out + row * block;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    if (i < block) orow[i] = __fmul_rn(v[j], fabsf(v[j]) >= hi ? 1.f : 0.f);
  }
}

template <int VPL>
cudaError_t launch(const float* x, float* out, long long rows, int block, int k, int iters,
                   cudaStream_t st) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  block_topk_kernel<VPL><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(x, out, rows, block,
                                                                           k, iters);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, out: [rows, block] f32, contiguous; 1 <= block <= 2048; k >= 1.
extern "C" int repro_block_topk(const void* x, void* out, long long rows, int block, int k,
                                int iters, void* stream) {
  using namespace repro;
  if (rows <= 0 || block < 1 || block > 2048 || k < 1 || iters < 0 ||
      (rows + WARPS - 1) / WARPS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (block <= 128) err = launch<4>(xp, op, rows, block, k, iters, st);
  else if (block <= 256) err = launch<8>(xp, op, rows, block, k, iters, st);
  else if (block <= 512) err = launch<16>(xp, op, rows, block, k, iters, st);
  else if (block <= 1024) err = launch<32>(xp, op, rows, block, k, iters, st);
  else err = launch<64>(xp, op, rows, block, k, iters, st);
  return static_cast<int>(err);
}
