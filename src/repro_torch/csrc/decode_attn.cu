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
// Wider groups and head dim 256 (decode_wide_kernel): the per-thread
// registers and the static shared memory above grow with G x hd (the row
// groups' reduction alone would need 128 KB at G 64, hd 128), and each of
// its threads walks all G heads' scores, so shapes past G 2 or hd 128 take a
// second body over the same split plan, the same partials and the same
// combine (on the H100 it is slower at G 1-2 and as fast or faster from
// G 4: PERF.md):
//   * 256 threads; each 64-row tile's live K and V rows are staged in
//     dynamic shared memory in the cache's own type (rows padded by 16
//     bytes, so lanes reading different rows hit different banks; dead rows
//     zero-filled), with the pre-scaled f32 queries beside them;
//   * warp w owns query heads w, w + 8, ... (at most 8 of G 64): for scores
//     its lanes own rows (lane, lane + 32) and read the queries as
//     broadcasts, the online softmax runs on those registers, and for P.V
//     its lanes own hd / 32 columns each, so no head's sum crosses warps and
//     the partial (m, l, acc) is written straight from registers;
//   * grouped heads still share one pass over K/V: the tile is read from
//     device memory once for all G heads.
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int TILE = 64;  // cache rows per tile; a chunk is a whole number of tiles
constexpr int NT = 128;   // threads per split block
constexpr int NW = NT / 32;
constexpr int MAXG = 2;   // query heads per kv head of the split kernel (more: the wide body)
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

// GM: the most query heads per kv head (register arrays are sized by it)
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

// ------------------------------------------------------------ wide groups
constexpr int WNT = 256;  // threads per block of the wide body
constexpr int WNW = WNT / 32;
constexpr int MAX_GROUP = 64;  // query heads per kv head (kernels/decode.py::_MAX_GROUP)

// N consecutive KT values at p (aligned to N * sizeof(KT), or 16 bytes),
// widened to float; p may point to shared or device memory
template <typename KT, int N>
__device__ __forceinline__ void ld_as_float(const void* p, float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(KT));
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / sizeof(KT);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) out[i * PER + j] = to_float(e[j]);
    }
  } else {
    using R = std::conditional_t<BYTES == 8, uint2,
                                 std::conditional_t<BYTES == 4, uint32_t, uint16_t>>;
    const R raw = *reinterpret_cast<const R*>(p);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_float(e[j]);
  }
}

// N floats at p (8-byte aligned), through L2 only (partials of other blocks)
template <int N>
__device__ __forceinline__ void ldcg_floats(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p) + i);
      out[4 * i] = x.x, out[4 * i + 1] = x.y, out[4 * i + 2] = x.z, out[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(p) + i);
      out[2 * i] = x.x, out[2 * i + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void st_floats(float* p, const float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(x[2 * i], x[2 * i + 1]);
  }
}

// shared-memory bytes per staged cache row: hd values, padded by 16 bytes
template <typename KT, int HD>
__host__ __device__ constexpr int wide_row_bytes() { return HD * static_cast<int>(sizeof(KT)) + 16; }

// dynamic shared memory of the wide body: staged K and V tiles, the queries
// [G][HD] and each warp's probabilities [GPW][TILE]
template <typename KT, int HD, int GPW>
constexpr size_t wide_smem(int G) {
  return 2 * TILE * wide_row_bytes<KT, HD>() + sizeof(float) * (G * HD + WNW * GPW * TILE);
}

// GPW: query heads per warp, >= ceil(G / 8) (register arrays are sized by it)
template <typename T, typename KT, int HD, int GPW, bool QUANT>
__global__ void __launch_bounds__(WNT)
decode_wide_kernel(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                   const uint8_t* __restrict__ valid, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, T* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int* __restrict__ counters, int L, int KV, int G, int chunk, float scale) {
  constexpr int VEC = 16 / sizeof(KT);  // elements per 16-byte chunk of a row
  constexpr int CPR = HD / VEC;         // 16-byte chunks per row
  constexpr int CV = HD / 32;           // columns per lane in P.V and the combine
  constexpr int RS = wide_row_bytes<KT, HD>();
  constexpr int NIT = TILE * CPR / WNT;  // 16-byte chunks per thread per tile, K and V each
  constexpr int NB = NIT < 4 ? NIT : 4;  // chunks in flight per thread
  static_assert(NIT >= 1 && NIT * WNT == TILE * CPR && NIT % NB == 0 && CV >= 2, "layout");
  extern __shared__ __align__(16) uint8_t dsm[];
  uint8_t* ks = dsm;                                       // [TILE][RS]
  uint8_t* vs = ks + TILE * RS;                            // [TILE][RS]
  float* qs = reinterpret_cast<float*>(vs + TILE * RS);    // [G][HD], pre-scaled
  __shared__ float ksc[TILE], vsc[TILE];                   // int8 scales of the tile's rows
  __shared__ float wsm[WNW][MAX_SPLITS];                   // the combine's weight per split

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pw = qs + G * HD + warp * GPW * TILE;  // this warp's [GPW][TILE] probabilities
  const long long rs = (long long)KV * HD;
  const KT* kb = k + (long long)b * L * rs + (long long)h * HD;
  const KT* vb = v + (long long)b * L * rs + (long long)h * HD;
  const uint8_t* validb = valid + (long long)b * L;
  const long long sc0 = (long long)b * L * KV + h;
  const int c0 = split * chunk, c1 = min(c0 + chunk, L);
  const long long pbase = (((long long)b * KV + h) * S + split) * G;
  const int col = lane * CV;

  const T* qb = q + ((long long)b * KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += WNT) qs[i] = to_float(qb[i]) * scale;

  float m[GPW], l[GPW], acc[GPW][CV];
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CV; ++e) acc[i][e] = 0.f;
  }

  bool any_live = false;  // block-uniform
  for (int l0 = c0; l0 < c1; l0 += TILE) {
    // the tile's live rows as a 64-bit mask, the same in every warp
    const int la = l0 + lane, lb = l0 + 32 + lane;
    const unsigned lo = __ballot_sync(FULL_MASK, la < L && validb[la]);
    const unsigned hi = __ballot_sync(FULL_MASK, lb < L && validb[lb]);
    const unsigned long long live = (static_cast<unsigned long long>(hi) << 32) | lo;
    __syncthreads();  // every warp is done with the last tile's staged rows
    if (live == 0ull) continue;
    any_live = true;

    if (QUANT && tid < TILE) {
      const bool f = (live >> tid) & 1ull;
      ksc[tid] = f ? __ldg(k_scale + sc0 + (long long)(l0 + tid) * KV) : 0.f;
      vsc[tid] = f ? __ldg(v_scale + sc0 + (long long)(l0 + tid) * KV) : 0.f;
    }
#pragma unroll
    for (int i0 = 0; i0 < NIT; i0 += NB) {
      uint4 kr[NB], vr[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int i = tid + WNT * (i0 + j);
        const int r = i / CPR, c = (i % CPR) * VEC;
        const bool f = (live >> r) & 1ull;
        const long long off = (long long)(l0 + r) * rs + c;
        kr[j] = f ? ldg16(kb + off) : make_uint4(0u, 0u, 0u, 0u);
        vr[j] = f ? ldg16(vb + off) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int i = tid + WNT * (i0 + j);
        const int r = i / CPR, c = (i % CPR) * 16;
        *reinterpret_cast<uint4*>(ks + r * RS + c) = kr[j];
        *reinterpret_cast<uint4*>(vs + r * RS + c) = vr[j];
      }
    }
    __syncthreads();

    // scores of rows (lane, lane + 32) for this warp's heads
    float s[GPW][2];
#pragma unroll
    for (int i = 0; i < GPW; ++i) s[i][0] = s[i][1] = 0.f;
    const uint8_t* k0 = ks + lane * RS;
    const uint8_t* k1 = ks + (lane + 32) * RS;
#pragma unroll 2
    for (int c = 0; c < HD; c += VEC) {
      float ka[VEC], kc[VEC];
      ld_as_float<KT, VEC>(k0 + c * sizeof(KT), ka);
      ld_as_float<KT, VEC>(k1 + c * sizeof(KT), kc);
#pragma unroll
      for (int i = 0; i < GPW; ++i) {
        if (warp + WNW * i < G) {  // warp-uniform
          const float4* qg = reinterpret_cast<const float4*>(qs + (warp + WNW * i) * HD + c);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = qg[e4];
            s[i][0] = fmaf(qv.x, ka[4 * e4 + 0], s[i][0]);
            s[i][0] = fmaf(qv.y, ka[4 * e4 + 1], s[i][0]);
            s[i][0] = fmaf(qv.z, ka[4 * e4 + 2], s[i][0]);
            s[i][0] = fmaf(qv.w, ka[4 * e4 + 3], s[i][0]);
            s[i][1] = fmaf(qv.x, kc[4 * e4 + 0], s[i][1]);
            s[i][1] = fmaf(qv.y, kc[4 * e4 + 1], s[i][1]);
            s[i][1] = fmaf(qv.z, kc[4 * e4 + 2], s[i][1]);
            s[i][1] = fmaf(qv.w, kc[4 * e4 + 3], s[i][1]);
          }
        }
      }
    }

    // mask, online softmax per head on the registers, probabilities to shared
    const bool fa = (live >> lane) & 1ull, fb = (live >> (lane + 32)) & 1ull;
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      if (warp + WNW * i < G) {
        float x0 = la >= L ? -INFINITY : !fa ? NEG_INF : QUANT ? s[i][0] * ksc[lane] : s[i][0];
        float x1 = lb >= L ? -INFINITY : !fb ? NEG_INF : QUANT ? s[i][1] * ksc[lane + 32]
                                                               : s[i][1];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[i][e] *= alpha;
        pw[i * TILE + lane] = QUANT ? p0 * vsc[lane] : p0;  // v_scale on p
        pw[i * TILE + lane + 32] = QUANT ? p1 * vsc[lane + 32] : p1;
      }
    }
    __syncwarp();

    // P.V: lanes own columns col .. col + CV; groups of 4 dead rows skipped
#pragma unroll 2
    for (int r = 0; r < TILE; r += 4) {
      if (((live >> r) & 0xFull) == 0ull) continue;  // warp-uniform
      float vf[4][CV];
#pragma unroll
      for (int j = 0; j < 4; ++j) ld_as_float<KT, CV>(vs + (r + j) * RS + col * sizeof(KT), vf[j]);
#pragma unroll
      for (int i = 0; i < GPW; ++i) {
        if (warp + WNW * i < G) {
          const float4 p = *reinterpret_cast<const float4*>(pw + i * TILE + r);
#pragma unroll
          for (int e = 0; e < CV; ++e) {
            float a = acc[i][e];
            a = fmaf(p.x, vf[0][e], a);
            a = fmaf(p.y, vf[1][e], a);
            a = fmaf(p.z, vf[2][e], a);
            acc[i][e] = fmaf(p.w, vf[3][e], a);
          }
        }
      }
    }
  }

  // this chunk's partial; an empty chunk leaves m = -inf and no acc
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int g = warp + WNW * i;
    if (g < G) {
      if (any_live) st_floats<CV>(part_acc + (pbase + g) * HD + col, acc[i]);
      if (lane == 0) {
        part_ml[2 * (pbase + g)] = m[i];
        part_ml[2 * (pbase + g) + 1] = l[i];
      }
    }
  }

  // The last of the S blocks of (b, h) to finish combines their partials.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + (long long)b * KV + h, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long e0 = ((long long)b * KV + h) * S * G;  // partial (s, g): e0 + s * G + g
  T* ob = out + ((long long)b * KV + h) * G * HD;
  float* wv = wsm[warp];
  for (int g = warp; g < G; g += WNW) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, __ldcg(part_ml + 2 * (e0 + s * G + g)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    float lsum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ms_ = __ldcg(part_ml + 2 * (e0 + s * G + g));
      const float w = ms_ == -INFINITY ? 0.f : expf(ms_ - mx);
      wv[s] = w;
      lsum = fmaf(w, __ldcg(part_ml + 2 * (e0 + s * G + g) + 1), lsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(FULL_MASK, lsum, off);
    __syncwarp();
    float a[CV];
#pragma unroll
    for (int e = 0; e < CV; ++e) a[e] = 0.f;
    float den;
    if (mx == -INFINITY) {
      // no live row in the whole cache row: the uniform mean of V over all L
      for (int r = 0; r < L; ++r) {
        float x[CV];
        ld_as_float<KT, CV>(vb + (long long)r * rs + col, x);
        const float vsl = QUANT ? v_scale[sc0 + (long long)r * KV] : 1.f;
#pragma unroll
        for (int e = 0; e < CV; ++e) a[e] += QUANT ? x[e] * vsl : x[e];
      }
      den = static_cast<float>(L);
    } else {
      for (int s = 0; s < S; ++s) {
        const float w = wv[s];
        if (w != 0.f) {
          float x[CV];
          ldcg_floats<CV>(part_acc + (e0 + (long long)s * G + g) * HD + col, x);
#pragma unroll
          for (int e = 0; e < CV; ++e) a[e] = fmaf(w, x[e], a[e]);
        }
      }
      den = fmaxf(lsum, 1e-30f);
    }
#pragma unroll
    for (int e = 0; e < CV; ++e) ob[g * HD + col + e] = from_float<T>(a[e] / den);
    __syncwarp();  // wv is read before the next head overwrites it
  }
  if (tid == 0) counters[(long long)b * KV + h] = 0;
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

template <typename T, typename KT, int HD, int GPW, bool QUANT>
cudaError_t launch_wide(const Args& a) {
  auto kern = decode_wide_kernel<T, KT, HD, GPW, QUANT>;
  // opt in to the most this variant can ask for (G = 8 * GPW)
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)wide_smem<KT, HD, GPW>(GPW * WNW));
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.S, a.KV, a.B), WNT, wide_smem<KT, HD, GPW>(a.G), a.st>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      static_cast<const uint8_t*>(a.valid), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<T*>(a.out), a.part_acc, a.part_ml,
      a.counters, a.L, a.KV, a.G, a.chunk, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KT, int HD, bool QUANT>
cudaError_t dispatch_wide(const Args& a) {
  if (a.G <= WNW) return launch_wide<T, KT, HD, 1, QUANT>(a);
  if (a.G <= 2 * WNW) return launch_wide<T, KT, HD, 2, QUANT>(a);
  if (a.G <= 4 * WNW) return launch_wide<T, KT, HD, 4, QUANT>(a);
  return launch_wide<T, KT, HD, 8, QUANT>(a);
}

// hd 64 / 128 with G <= 2 keep the split kernel (faster there; from G 4 the
// wide body is as fast or faster: PERF.md); wider groups and hd 256 take the
// wide body, as every shape does with `wide`
template <typename T, int HD>
cudaError_t dispatch_quant(int quantized, bool wide, const Args& a) {
  if constexpr (HD == 256) {
    if (quantized) return dispatch_wide<T, int8_t, HD, true>(a);
    return dispatch_wide<T, T, HD, false>(a);
  } else {
    if (wide || a.G > MAXG) {
      if (quantized) return dispatch_wide<T, int8_t, HD, true>(a);
      return dispatch_wide<T, T, HD, false>(a);
    }
    if (quantized) return launch<T, int8_t, HD, MAXG, true>(a);
    return launch<T, T, HD, MAXG, false>(a);
  }
}

}  // namespace
}  // namespace repro

// q, out: [B, KV, G, hd] contiguous; k, v: [B, L, KV, hd] contiguous (dtype of
// q, or int8 when quantized); valid: [B, L] bytes; k_scale, v_scale:
// [B, L, KV] f32 (quantized only).  Scratch: part_acc B*KV*S*G*hd f32,
// part_ml B*KV*S*G*2 f32, S = ceil(L / chunk) <= 256, and counters B*KV int32
// that are zero on entry and left zero; chunk a positive multiple of 64;
// hd 64, 128 or 256 and 1 <= G <= 64.
// dtype: 0 = f32, 1 = bf16.  One kernel launch on `stream`.
static int decode_attn(const void* q, const void* k, const void* v, const void* valid,
                       const void* k_scale, const void* v_scale, void* out, void* part_acc,
                       void* part_ml, void* counters, int dtype, int quantized, int B, int L,
                       int KV, int G, int hd, int chunk, float scale, void* stream, bool wide) {
  using namespace repro;
  const int S = chunk > 0 ? (L + chunk - 1) / chunk : 0;
  if (G < 1 || G > MAX_GROUP || B < 1 || B > 65535 || KV < 1 || KV > 65535 || L < 1 ||
      chunk < TILE || chunk % TILE != 0 || S > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, valid, k_scale, v_scale, out, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counters), B, L, KV, G, chunk, S,
         scale, static_cast<cudaStream_t>(stream)};
  if (dtype == DT_F32 && hd == 128) return dispatch_quant<float, 128>(quantized, wide, a);
  if (dtype == DT_F32 && hd == 64) return dispatch_quant<float, 64>(quantized, wide, a);
  if (dtype == DT_F32 && hd == 256) return dispatch_quant<float, 256>(quantized, wide, a);
  if (dtype == DT_BF16 && hd == 128) return dispatch_quant<__nv_bfloat16, 128>(quantized, wide, a);
  if (dtype == DT_BF16 && hd == 64) return dispatch_quant<__nv_bfloat16, 64>(quantized, wide, a);
  if (dtype == DT_BF16 && hd == 256) return dispatch_quant<__nv_bfloat16, 256>(quantized, wide, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_decode_attn(const void* q, const void* k, const void* v, const void* valid,
                                 const void* k_scale, const void* v_scale, void* out,
                                 void* part_acc, void* part_ml, void* counters, int dtype,
                                 int quantized, int B, int L, int KV, int G, int hd, int chunk,
                                 float scale, void* stream) {
  return decode_attn(q, k, v, valid, k_scale, v_scale, out, part_acc, part_ml, counters, dtype,
                     quantized, B, L, KV, G, hd, chunk, scale, stream, false);
}

// The same call on the wide body at every shape, also where the split kernel
// runs (G <= 2, hd 64 / 128): for timing the two bodies on the same inputs.
extern "C" int repro_decode_attn_wide(const void* q, const void* k, const void* v,
                                      const void* valid, const void* k_scale,
                                      const void* v_scale, void* out, void* part_acc,
                                      void* part_ml, void* counters, int dtype, int quantized,
                                      int B, int L, int KV, int G, int hd, int chunk, float scale,
                                      void* stream) {
  return decode_attn(q, k, v, valid, k_scale, v_scale, out, part_acc, part_ml, counters, dtype,
                     quantized, B, L, KV, G, hd, chunk, scale, stream, true);
}
