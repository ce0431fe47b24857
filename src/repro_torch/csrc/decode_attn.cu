// decode_attn: one-token grouped-query decode attention over the KV cache.
//
// Replaces repro/kernels/decode.py::decode_attention_pallas (_decode_kernel).
//
// What bounds it on the H100: memory.  One query token per head attends the
// live rows of its kv head's [L, hd] K and V, ~1 FLOP per cache byte, so the
// floor is (live K + V bytes) / 3.35 TB/s -- a few microseconds at serving
// shapes, where latency, not bandwidth, is what a naive kernel pays.  The
// design (split-L):
//   * the grid is (splits, KV, B): each block owns one chunk of `chunk` cache
//     positions (a whole number of 64-row tiles; the host's plan,
//     kernels/decode.py::split_plan, sizes chunks so the grid covers the 132
//     SMs several times over) and keeps its G query heads (pre-scaled, f32)
//     in shared memory, so grouped heads share one pass over K/V;
//   * each thread reads the `valid` bytes of its rows first; a tile with no
//     live row is skipped (no K/V load, no barrier work), and a dead row in a
//     live tile loads nothing: its probability is exactly 0 once the tile's
//     live scores set the max, so only live rows are read;
//   * K and V are read with 16-byte vector loads (4 f32, 8 bf16 or 16 int8 per
//     lane), TPR = hd / (16 / sizeof) lanes per row; the V loads of a tile are
//     issued with its K loads, before the softmax barriers;
//   * per tile: scores (a TPR-lane shuffle reduction), an f32 online softmax
//     over the tile by one warp per head, then P.V into per-thread registers;
//     at the end the row groups' accumulators are summed (shuffles, then
//     shared memory) into an f32 partial (m, l, acc[G][hd]) per chunk;
//   * the last of a cache row's blocks to finish (an atomic count per
//     (batch, kv head), behind __threadfence) combines the partials of each
//     query head: out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s,
//     1e-30), and sets the count back to 0.  A pass in the same kernel rather
//     than a second kernel: the combine then costs no launch (the decode tick
//     is host-bound) and no kernel's ramp on the device; the counts live in
//     the wrapper's scratch for the stream, whose calls run in order;
//   * the reference's semantics: the finite -1e30 sentinel for masked rows,
//     -inf past L, k_scale on the scores after QK, v_scale on p before PV
//     with the softmax sum over the unscaled p; the int8 scales of a tile's
//     live rows are loaded with its K/V;
//   * a batch row with no live position at all gets the reference's answer
//     for a softmax over equal sentinels: the uniform mean of V (times
//     v_scale) over all L rows, computed by the combining block, which finds
//     every partial of that row empty.
#include "common.cuh"

namespace repro {
namespace {

constexpr int TILE = 64;  // cache rows per tile; a chunk is a whole number of tiles
constexpr int NT = 128;   // threads per split block
constexpr int NW = NT / 32;
constexpr int MAXG = 8;   // query heads per kv head
constexpr int MAX_SPLITS = 256;  // chunks per cache row (kernels/decode.py::MAX_SPLITS)
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the VEC values of KT packed in a 16-byte register vector, widened to float
template <typename KT, int VEC>
__device__ __forceinline__ void widen(const uint4& raw, float* out) {
  load_as_float<KT, VEC>(reinterpret_cast<const KT*>(&raw), out);
}

// GM: a power of two >= G (register arrays are sized by it)
template <typename T, typename KT, int HD, int GM, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                    const uint8_t* __restrict__ valid, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int L, int KV, int G, int chunk, float scale) {
  constexpr int VEC = 16 / sizeof(KT);  // elements per 16-byte load
  constexpr int TPR = HD / VEC;         // lanes per cache row
  constexpr int RG = NT / TPR;          // rows in flight across the block
  constexpr int RPT = TILE / RG;        // rows per thread per tile
  constexpr int RB = RPT < 8 ? RPT : 8; // rows loaded at once
  static_assert(TPR <= 32 && RG * TPR == NT && RPT * RG == TILE && RPT % RB == 0, "layout");
  __shared__ __align__(16) float qs[GM * HD];  // [G][HD], pre-scaled
  __shared__ float ps[GM][TILE];               // scores, then probabilities
  __shared__ float ms[GM], ls[GM], as[GM];     // running max, sum, this tile's rescale
  __shared__ __align__(16) float red[NW][GM * HD];
  __shared__ float wsm[GM][MAX_SPLITS];        // the combine's weight per split

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = tid % TPR, rg = tid / TPR;
  const int col = tr * VEC;
  const long long rs = (long long)KV * HD;  // elements between cache rows
  const KT* kb = k + (long long)b * L * rs + (long long)h * HD + col;
  const KT* vb = v + (long long)b * L * rs + (long long)h * HD + col;
  const uint8_t* validb = valid + (long long)b * L;
  const long long sc0 = (long long)b * L * KV + h;  // scale of position l: sc0 + l * KV
  const int c0 = split * chunk, c1 = min(c0 + chunk, L);
  const long long pbase = (((long long)b * KV + h) * S + split) * G;  // partial (.., g = 0)

  const T* qb = q + ((long long)b * KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += NT) qs[i] = to_float(qb[i]) * scale;
  if (tid < GM) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  float acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;

  bool any_live = false;  // block-uniform
  for (int l0 = c0; l0 < c1; l0 += TILE) {
    bool fl[RPT];
    int mine = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int l = l0 + rg + RG * i;
      fl[i] = l < L && validb[l];
      mine |= fl[i];
    }
    // also the barrier between the last tile's P.V and this tile's scores
    if (!__syncthreads_or(mine)) continue;
    any_live = true;

    uint4 vr[RB];
    float vsc[RPT];  // v_scale of this thread's rows (int8 only)
#pragma unroll
    for (int i0 = 0; i0 < RPT; i0 += RB) {
      uint4 kr[RB];
      float ksc[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const long long l = l0 + rg + RG * (i0 + i);
        kr[i] = fl[i0 + i] ? ldg16(kb + l * rs) : make_uint4(0u, 0u, 0u, 0u);
        if (i0 == 0) vr[i] = fl[i] ? ldg16(vb + l * rs) : make_uint4(0u, 0u, 0u, 0u);
        if (QUANT) {  // issued with the K/V loads, not after the scores
          ksc[i] = fl[i0 + i] && tr == 0 ? __ldg(k_scale + sc0 + l * KV) : 0.f;
          vsc[i0 + i] = fl[i0 + i] ? __ldg(v_scale + sc0 + l * KV) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float kf[VEC];
        widen<KT, VEC>(kr[i], kf);
        const int r = rg + RG * (i0 + i), l = l0 + r;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4* qg = reinterpret_cast<const float4*>(qs + g * HD + col);
            float s = 0.f;
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 qv = qg[e4];
              s = fmaf(qv.x, kf[4 * e4 + 0], s);
              s = fmaf(qv.y, kf[4 * e4 + 1], s);
              s = fmaf(qv.z, kf[4 * e4 + 2], s);
              s = fmaf(qv.w, kf[4 * e4 + 3], s);
            }
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
            if (tr == 0) {
              if (l >= L) {
                s = -INFINITY;
              } else if (!fl[i0 + i]) {
                s = NEG_INF;
              } else if (QUANT) {
                s *= ksc[i];
              }
              ps[g][r] = s;
            }
          }
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float x0 = ps[g][lane], x1 = ps[g][lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
      ps[g][lane] = p0;
      ps[g][lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float a = as[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < RPT; i0 += RB) {
      if (i0 > 0) {
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const long long l = l0 + rg + RG * (i0 + i);
          vr[i] = fl[i0 + i] ? ldg16(vb + l * rs) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (!fl[i0 + i]) continue;
        float vf[VEC];
        widen<KT, VEC>(vr[i], vf);
        const int r = rg + RG * (i0 + i);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = QUANT ? ps[g][r] * vsc[i0 + i] : ps[g][r];  // v_scale on p
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
    }
  }

  if (any_live) {
    // sum the row groups: first those sharing a warp, then the warps
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
#pragma unroll
          for (int off = TPR; off < 32; off <<= 1)
            acc[g][e] += __shfl_xor_sync(FULL_MASK, acc[g][e], off);
        }
      }
    }
    if (lane < TPR) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) red[warp][g * HD + col + e] = acc[g][e];
        }
      }
    }
    __syncthreads();
    float* pa = part_acc + pbase * HD;
    for (int i = tid; i < G * HD; i += NT) {
      float s = red[0][i];
#pragma unroll
      for (int w = 1; w < NW; ++w) s += red[w][i];
      pa[i] = s;
    }
  }
  if (tid < G) {  // an empty chunk's partial is m = -inf: the combine skips it
    part_ml[2 * (pbase + tid)] = any_live ? ms[tid] : -INFINITY;
    part_ml[2 * (pbase + tid) + 1] = any_live ? ls[tid] : 0.f;
  }

  // The last of the S blocks of (b, h) to finish combines their partials.
  __shared__ int last;
  __threadfence();  // this thread's partials are visible before the count moves
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + (long long)b * KV + h, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long e0 = ((long long)b * KV + h) * S * G;  // partial (s, g): e0 + s * G + g
  for (int g = warp; g < G; g += NW) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, __ldcg(part_ml + 2 * (e0 + s * G + g)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    float lsum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float m = __ldcg(part_ml + 2 * (e0 + s * G + g));
      const float w = m == -INFINITY ? 0.f : expf(m - mx);
      wsm[g][s] = w;
      lsum = fmaf(w, __ldcg(part_ml + 2 * (e0 + s * G + g) + 1), lsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(FULL_MASK, lsum, off);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = lsum;
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, c = i % HD;
    float a = 0.f;
    if (ms[g] == -INFINITY) {
      // no live row in the whole cache row: every score is the sentinel and
      // the softmax is uniform, so the result is the mean of V over all L
      const KT* vc = v + (long long)b * L * rs + (long long)h * HD + c;
      for (int l = 0; l < L; ++l) {
        float x = to_float(vc[l * rs]);
        if (QUANT) x *= v_scale[sc0 + (long long)l * KV];
        a += x;
      }
      ob[i] = from_float<T>(a / static_cast<float>(L));
    } else {
      const float* pa = part_acc + (e0 + g) * HD + c;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float w = wsm[g][s];
        if (w != 0.f) a = fmaf(w, __ldcg(pa + (long long)s * G * HD), a);
      }
      ob[i] = from_float<T>(a / fmaxf(ls[g], 1e-30f));
    }
  }
  if (tid == 0) counters[(long long)b * KV + h] = 0;  // ready for the next call on this stream
}

struct Args {
  const void *q, *k, *v, *valid, *k_scale, *v_scale;
  void* out;
  float *part_acc, *part_ml;
  int* counters;
  int B, L, KV, G, chunk, S;
  float scale;
  cudaStream_t st;
};

template <typename T, typename KT, int HD, int GM, bool QUANT>
cudaError_t launch(const Args& a) {
  decode_split_kernel<T, KT, HD, GM, QUANT><<<dim3(a.S, a.KV, a.B), NT, 0, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      static_cast<const uint8_t*>(a.valid), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<T*>(a.out), a.part_acc, a.part_ml,
      a.counters, a.L, a.KV, a.G, a.chunk, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KT, int HD, bool QUANT>
cudaError_t dispatch_group(const Args& a) {
  if (a.G <= 2) return launch<T, KT, HD, 2, QUANT>(a);
  if (a.G <= 4) return launch<T, KT, HD, 4, QUANT>(a);
  return launch<T, KT, HD, MAXG, QUANT>(a);
}

template <typename T, int HD>
cudaError_t dispatch_quant(int quantized, const Args& a) {
  if (quantized) return dispatch_group<T, int8_t, HD, true>(a);
  return dispatch_group<T, T, HD, false>(a);
}

}  // namespace
}  // namespace repro

// q, out: [B, KV, G, hd] contiguous; k, v: [B, L, KV, hd] contiguous (dtype of
// q, or int8 when quantized); valid: [B, L] bytes; k_scale, v_scale:
// [B, L, KV] f32 (quantized only).  Scratch: part_acc B*KV*S*G*hd f32,
// part_ml B*KV*S*G*2 f32, S = ceil(L / chunk) <= 256, and counters B*KV int32
// that are zero on entry and left zero; chunk a positive multiple of 64.
// dtype: 0 = f32, 1 = bf16.  One kernel launch on `stream`.
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v, const void* valid,
                                 const void* k_scale, const void* v_scale, void* out,
                                 void* part_acc, void* part_ml, void* counters, int dtype,
                                 int quantized, int B, int L, int KV, int G, int hd, int chunk,
                                 float scale, void* stream) {
  using namespace repro;
  const int S = chunk > 0 ? (L + chunk - 1) / chunk : 0;
  if (G < 1 || G > MAXG || B < 1 || B > 65535 || KV < 1 || KV > 65535 || L < 1 ||
      chunk < TILE || chunk % TILE != 0 || S > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, valid, k_scale, v_scale, out, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counters), B, L, KV, G, chunk, S,
         scale, static_cast<cudaStream_t>(stream)};
  if (dtype == DT_F32 && hd == 128) return dispatch_quant<float, 128>(quantized, a);
  if (dtype == DT_F32 && hd == 64) return dispatch_quant<float, 64>(quantized, a);
  if (dtype == DT_BF16 && hd == 128) return dispatch_quant<__nv_bfloat16, 128>(quantized, a);
  if (dtype == DT_BF16 && hd == 64) return dispatch_quant<__nv_bfloat16, 64>(quantized, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
