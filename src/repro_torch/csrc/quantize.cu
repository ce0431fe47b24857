// quantize / dequantize: stochastic b-bit quantization with bit-packing, and
// its inverse -- the packed wire of a `kq*b` compressor.
//
// Replaces repro/kernels/quantize.py::quantize_pallas (_quantize_kernel) and
// dequantize_pallas (_dequantize_kernel).
//
// What bounds it on the H100: memory.  Each element costs a handful of
// flops; quantize reads x and xi (8 bytes) and writes (b+1)/8 bytes,
// dequantize reads (b+1)/8 bytes and writes 4, so the floor is those bytes
// over 3.35 TB/s.  The design reads every input byte once and keeps the
// unpacked levels in registers:
//   * one thread owns one lane of one 8-row group ([rows, 128] layout): it
//     reads 8 rows of its lane (the 128 threads of a lane row read 512
//     consecutive bytes, so loads coalesce), and writes the group's `b`
//     level bytes (8/b rows fold into one byte, JAX's sublane packing) and
//     its one sign byte;
//   * the per-tensor norm / scale is read from device memory, so no host
//     synchronisation sits between the norm reduction and the kernel.
// Rounding is the reference's, bit for bit: the encode scale is the IEEE
// quotient 2^b / max(norm, 1e-30) and |x| * scale + xi is two rounded
// operations (__fmul_rn / __fadd_rn, and the file builds with -fmad=false),
// so levels at a floor boundary land where the plain version puts them.
#include "common.cuh"

namespace repro {
namespace {

constexpr int LANES = 128;
constexpr int GROUP = 8;    // rows per thread: one sign byte
constexpr int THREADS = 256;

template <int BITS>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ xi,
                const float* __restrict__ norm, uint8_t* __restrict__ lvl,
                uint8_t* __restrict__ sign, long long groups) {
  constexpr int PACK = 8 / BITS;
  constexpr float MAXLVL = static_cast<float>((1 << BITS) - 1);
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= groups * LANES) return;
  const long long g = t / LANES;
  const int lane = static_cast<int>(t % LANES);
  const float scale = static_cast<float>(1 << BITS) / fmaxf(*norm, 1e-30f);

  uint32_t bytes[BITS];
#pragma unroll
  for (int b = 0; b < BITS; ++b) bytes[b] = 0u;
  uint32_t sbyte = 0u;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const long long idx = (g * GROUP + j) * LANES + lane;
    const float v = x[idx];
    const float q = floorf(__fadd_rn(__fmul_rn(fabsf(v), scale), xi[idx]));
    const uint32_t l = static_cast<uint32_t>(fminf(fmaxf(q, 0.f), MAXLVL));
    bytes[j / PACK] |= l << ((j % PACK) * BITS);
    sbyte |= static_cast<uint32_t>(v < 0.f) << j;
  }
#pragma unroll
  for (int b = 0; b < BITS; ++b) lvl[(g * BITS + b) * LANES + lane] = static_cast<uint8_t>(bytes[b]);
  sign[g * LANES + lane] = static_cast<uint8_t>(sbyte);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const uint8_t* __restrict__ lvl, const uint8_t* __restrict__ sign,
                  const float* __restrict__ scale_ptr, float* __restrict__ out,
                  long long groups) {
  constexpr int PACK = 8 / BITS;
  constexpr uint32_t MAXLVL = (1u << BITS) - 1u;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= groups * LANES) return;
  const long long g = t / LANES;
  const int lane = static_cast<int>(t % LANES);
  const float scale = *scale_ptr;

  uint32_t bytes[BITS];
#pragma unroll
  for (int b = 0; b < BITS; ++b) bytes[b] = lvl[(g * BITS + b) * LANES + lane];
  const uint32_t sbyte = sign[g * LANES + lane];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const uint32_t l = (bytes[j / PACK] >> ((j % PACK) * BITS)) & MAXLVL;
    const float mag = __fmul_rn(static_cast<float>(l), scale);
    out[(g * GROUP + j) * LANES + lane] = ((sbyte >> j) & 1u) ? -mag : mag;
  }
}

inline unsigned blocks_for(long long groups) {
  return static_cast<unsigned>((groups * LANES + THREADS - 1) / THREADS);
}

}  // namespace
}  // namespace repro

// x, xi: [rows, 128] f32; norm: one f32 on the device; lvl: [rows*bits/8, 128]
// u8; sign: [rows/8, 128] u8.  rows % (8 * 8/bits) == 0 (the caller pads).
extern "C" int repro_quantize(const void* x, const void* xi, const void* norm, void* lvl,
                              void* sign, long long rows, int bits, void* stream) {
  using namespace repro;
  if (rows <= 0 || rows % GROUP != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = rows / GROUP;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* xip = static_cast<const float*>(xi);
  const float* np_ = static_cast<const float*>(norm);
  uint8_t* lp = static_cast<uint8_t*>(lvl);
  uint8_t* sp = static_cast<uint8_t*>(sign);
  switch (bits) {
    case 1: quantize_kernel<1><<<blocks_for(groups), THREADS, 0, st>>>(xp, xip, np_, lp, sp, groups); break;
    case 2: quantize_kernel<2><<<blocks_for(groups), THREADS, 0, st>>>(xp, xip, np_, lp, sp, groups); break;
    case 4: quantize_kernel<4><<<blocks_for(groups), THREADS, 0, st>>>(xp, xip, np_, lp, sp, groups); break;
    case 8: quantize_kernel<8><<<blocks_for(groups), THREADS, 0, st>>>(xp, xip, np_, lp, sp, groups); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lvl: [rows*bits/8, 128] u8; sign: [rows/8, 128] u8; scale: one f32 on the
// device (norm / (2^b tau)); out: [rows, 128] f32.
extern "C" int repro_dequantize(const void* lvl, const void* sign, const void* scale, void* out,
                                long long rows, int bits, void* stream) {
  using namespace repro;
  if (rows <= 0 || rows % GROUP != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = rows / GROUP;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* lp = static_cast<const uint8_t*>(lvl);
  const uint8_t* sp = static_cast<const uint8_t*>(sign);
  const float* scp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  switch (bits) {
    case 1: dequantize_kernel<1><<<blocks_for(groups), THREADS, 0, st>>>(lp, sp, scp, op, groups); break;
    case 2: dequantize_kernel<2><<<blocks_for(groups), THREADS, 0, st>>>(lp, sp, scp, op, groups); break;
    case 4: dequantize_kernel<4><<<blocks_for(groups), THREADS, 0, st>>>(lp, sp, scp, op, groups); break;
    case 8: dequantize_kernel<8><<<blocks_for(groups), THREADS, 0, st>>>(lp, sp, scp, op, groups); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
