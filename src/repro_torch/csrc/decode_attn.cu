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
// Wider groups and head dim 256: the per-thread registers and the static
// shared memory above grow with G x hd (the row groups' reduction alone would
// need 128 KB at G 64, hd 128), so shapes past G 2 or hd 128 take one of two
// wider bodies over the same split plan, partials and count (the plan gives a
// chunk at least 4 rows per query head, so the f32 partials stay small beside
// the K/V they summarize):
//   * bf16 queries (bf16 or int8 K/V): decode_mma_kernel, both products on
//     the tensor cores (described there);
//   * f32 queries: decode_wide_kernel on the CUDA cores (TF32 would not meet
//     the f32 bound): 256 threads; each 64-row tile's live K and V rows are
//     staged in dynamic shared memory in the cache's own type (rows padded by
//     16 bytes, so lanes reading different rows hit different banks; dead
//     rows zero-filled), with the pre-scaled f32 queries beside them; warp w
//     owns query heads w, w + 8, ... (at most 8 of G 64): for scores its
//     lanes own rows (lane, lane + 32) and read the queries as broadcasts,
//     the online softmax runs on those registers, and for P.V its lanes own
//     hd / 32 columns each, so no head's sum crosses warps and the partial
//     (m, l, acc) is written straight from registers.
// Either way grouped heads share one pass over K/V: a tile is read from
// device memory once for all G heads.
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
constexpr int WNT = 256;  // threads per block of the wide bodies
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

// ------------------------------------------------- wide groups, bf16 queries
// The tensor-core body: bf16 queries with bf16 or int8 K/V, every shape past
// the split kernel's (G > 2, or hd 256).  Same plan, partials and count as
// the bodies above; per 64-row tile, 8 warps:
//   * the tile's live rows arrive by cp.async in a 2-stage ring (dead rows
//     and rows past L zero-filled, never read), the next live tile's copies
//     in flight while this one is computed; int8 rows are widened to bf16 in
//     shared memory (exact: |x| <= 127 fits bf16's 8 significant bits);
//   * S = Q.K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate): the G query
//     heads padded to MT tiles of 16 rows are M, warp w owns keys 8w .. 8w+7;
//     the raw bf16 queries go in and the scale (and k_scale) multiplies the
//     f32 scores, so no pre-scaled query is rounded;
//   * the online softmax in f32 with 4 threads per score row (its latency
//     one row's, not G rows' one after another); p (times v_scale) is split
//     into hi = bf16(p) and lo = bf16(p - hi), so P.V keeps about 16 bits of
//     p: O += P_hi.V + P_lo.V, V read through ldmatrix.trans, warp w owning
//     hd / 8 columns of every head; S = Q.K^T, the softmax and P.V each take
//     a whole tile between block barriers;
//   * the live-row masks of a window of 64 tiles are read in one round, so
//     no tile waits on its `valid` bytes;
//   * a cache row of at most 8 chunks (the plan's choice up to 32 tiles) is
//     one thread-block cluster: each block keeps its partial in shared
//     memory and, after a cluster barrier, combines a share of the (head,
//     4 columns) items from every block's partial through distributed
//     shared memory (on the H100 the one combining block of the combine
//     through device memory took 7-9 us of granite-20b's decode); longer
//     rows keep that combine, its (m, l) pairs read at once and each thread's
//     items summed with several splits' loads in flight.
namespace mma {

constexpr int NST = 2;         // ring stages
constexpr int SLD = TILE + 8;  // f32 scores per row in shared memory
constexpr int PLD = TILE + 8;  // bf16 probabilities per row (144 bytes: ldmatrix without conflicts)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool take) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(take ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool take) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(take ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// distributed shared memory: `addr` of this block's shared memory in block
// `rank` of the cluster, and loads from there
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
// every block of the cluster has arrived, its shared-memory writes visible
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&x);
}
// 4 consecutive K/V values (8-byte aligned bf16, 4-byte aligned int8) as
// float, unpacked with shifts (no local copy in memory)
template <typename KT>
__device__ __forceinline__ void ld4_as_float(const KT* p, float (&o)[4]) {
  if constexpr (sizeof(KT) == 1) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(w.x << 16);
    o[1] = __uint_as_float(w.x & 0xffff0000u);
    o[2] = __uint_as_float(w.y << 16);
    o[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}
// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory plan: Q [16 MT][HD + 8] bf16; the bf16 K and V tiles
// [TILE][HD + 8] (a stage each for bf16 K/V; one for int8, whose ring holds
// the raw [TILE][HD] bytes and the scales); scores [16 MT][SLD] f32; P hi and
// lo [16 MT][PLD] bf16.  The combine's weights reuse the K/V tiles.
template <typename KT, int HD, int MT>
struct Plan {
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int GP = 16 * MT;
  static constexpr int LD = HD + 8;  // bf16 per staged row (row stride = 16 mod 128 bytes)
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = Q_OFF + GP * LD * 2;
  static constexpr int TILE_BYTES = TILE * LD * 2;          // one bf16 K or V tile
  static constexpr int BF_TILES = QUANT ? 2 : 2 * NST;      // bf16 K/V tiles
  static constexpr int RAW_OFF = KV_OFF + BF_TILES * TILE_BYTES;
  static constexpr int RAW_BYTES = QUANT ? NST * 2 * TILE * HD : 0;  // int8 ring
  static constexpr int SC_OFF = RAW_OFF + RAW_BYTES;
  static constexpr int SC_BYTES = QUANT ? NST * 2 * TILE * 4 : 0;   // k / v scales ring
  static constexpr int S_OFF = SC_OFF + SC_BYTES;
  static constexpr int P_OFF = S_OFF + GP * SLD * 4;
  static constexpr int SMEM = P_OFF + 2 * GP * PLD * 2;
  static constexpr int COMBINE_FLOATS = BF_TILES * TILE_BYTES / 4;  // the combine's [S][G] m, l
};

}  // namespace mma

// the most splits x query heads the mma body's combine keeps (m, l) for
// (kernels/decode.py::MAX_PARTIALS); its K/V tiles hold twice this many floats
constexpr int MAX_PARTIALS = 2048;
constexpr int MASK_TILES = 64;  // tiles whose live-row masks are read at once
// a cache row of at most this many chunks is one thread-block cluster, which
// combines its partials through distributed shared memory
// (kernels/decode.py::CLUSTER)
constexpr int MAX_CLUSTER = 8;

// CLUSTER: the grid's S chunks of a cache row are one cluster (S <= 8).
// One block per SM is all the bounds promise: without it ptxas stops at 64,
// 80 or 128 registers (4, 3 or 2 blocks of 256 threads) and spills a few.
template <typename KT, int HD, int MT, bool CLUSTER>
__global__ void __launch_bounds__(WNT, 1)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const uint8_t* __restrict__ valid,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counters, int L, int KV, int G,
                  int chunk, float scale) {
  using namespace mma;
  using P = Plan<KT, HD, MT>;
  constexpr bool QUANT = P::QUANT;
  constexpr int LD = P::LD;
  constexpr int NPW = HD / 64;       // 8-column n-tiles per warp in P.V
  constexpr int RCH = HD * sizeof(KT) / 16;  // 16-byte chunks per cache row
  static_assert(MT * 16 <= MAX_GROUP && NPW >= 1 && (NPW == 1 || NPW % 2 == 0), "layout");
  static_assert(P::COMBINE_FLOATS >= 2 * MAX_PARTIALS && P::SMEM <= 227 * 1024, "shared memory");
  extern __shared__ __align__(16) uint8_t dsm[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dsm + P::Q_OFF);
  float* ss = reinterpret_cast<float*>(dsm + P::S_OFF);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(dsm + P::P_OFF);
  __nv_bfloat16* pl = ph + P::GP * PLD;
  __shared__ float alpha_s[MAX_GROUP];
  __shared__ float m_s[MAX_GROUP], l_s[MAX_GROUP];
  __shared__ unsigned long long tmask[MASK_TILES];  // live rows of a window of tiles
  __shared__ float cm[MAX_GROUP], cl[MAX_GROUP];    // this chunk's (m, l) (cluster)
  __shared__ float cw[MAX_CLUSTER][MAX_GROUP];      // the cluster combine's weights

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rs = (long long)KV * HD;
  const KT* kb = k + (long long)b * L * rs + (long long)h * HD;
  const KT* vb = v + (long long)b * L * rs + (long long)h * HD;
  const uint8_t* validb = valid + (long long)b * L;
  const long long sc0 = (long long)b * L * KV + h;
  const int c0 = split * chunk, c1 = min(c0 + chunk, L);
  const long long pbase = (((long long)b * KV + h) * S + split) * G;
  // stage st's bf16 K / V tiles (int8: the one widened pair), raw int8 rows, scales
  auto kt_bf = [&](int st) { return dsm + P::KV_OFF + (QUANT ? 0 : 2 * st) * P::TILE_BYTES; };
  auto vt_bf = [&](int st) { return kt_bf(st) + P::TILE_BYTES; };
  auto raw = [&](int st) { return dsm + P::RAW_OFF + st * 2 * TILE * HD; };
  auto ksc = [&](int st) { return reinterpret_cast<float*>(dsm + P::SC_OFF) + st * 2 * TILE; };
  auto vsc = [&](int st) { return ksc(st) + TILE; };

  // queries as bf16 rows (by cp.async, with the first tile, when 16-byte
  // aligned), the padding rows zero; P's padding rows zero for good
  const __nv_bfloat16* qb = q + ((long long)b * KV + h) * G * HD;
  if ((reinterpret_cast<uintptr_t>(qb) & 15) == 0) {
    for (int i = tid; i < P::GP * (HD / 8); i += WNT) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      cp_async16(smem_u32(qs + r * LD + c), qb + (r < G ? r * HD + c : 0), r < G);
    }
  } else {
    for (int i = tid; i < P::GP * HD; i += WNT) {
      const int r = i / HD, c = i % HD;
      qs[r * LD + c] = r < G ? qb[r * HD + c] : __float2bfloat16(0.f);
    }
  }
  for (int i = G * PLD + tid; i < P::GP * PLD; i += WNT) {
    ph[i] = __float2bfloat16(0.f);
    pl[i] = __float2bfloat16(0.f);
  }
  if (tid < MAX_GROUP) alpha_s[tid] = 1.f;

  // the live rows of tiles w0 .. w0 + MASK_TILES - 1 as 64-bit masks, all
  // their `valid` bytes loaded at once (warp w: tiles w, w + 8, ...)
  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  auto masks = [&](int w0) {
    constexpr int PER = MASK_TILES / WNW;
    bool fa[PER], fb[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int l0 = c0 + (w0 + warp + WNW * j) * TILE;
      const int la = l0 + lane, lb = l0 + 32 + lane;
      fa[j] = la < c1 && validb[la];
      fb[j] = lb < c1 && validb[lb];
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const unsigned lo = __ballot_sync(FULL_MASK, fa[j]);
      const unsigned hi = __ballot_sync(FULL_MASK, fb[j]);
      if (lane == 0) tmask[warp + WNW * j] = (static_cast<unsigned long long>(hi) << 32) | lo;
    }
    __syncthreads();
  };
  int w0 = -MASK_TILES;  // first tile of the window in tmask (none read yet)
  // the first live tile at or after t (ntiles if none) and its mask; a new
  // window is read when t leaves this one (block-uniform)
  struct Tile {
    int t;
    unsigned long long live;
  };
  auto next_live = [&](int t) {
    for (; t < ntiles; ++t) {
      if (t >= w0 + MASK_TILES) {
        __syncthreads();  // every thread is done with this window
        w0 = t;
        masks(w0);
      }
      const unsigned long long mk = tmask[t - w0];
      if (mk != 0ull) return Tile{t, mk};
    }
    return Tile{ntiles, 0ull};
  };
  // copies of a live tile's rows (and scales) into stage st; dead rows zero-filled
  auto fetch = [&](int l0, unsigned long long live, int st) {
    uint8_t* kd_ = QUANT ? raw(st) : kt_bf(st);
    uint8_t* vd_ = QUANT ? raw(st) + TILE * HD : vt_bf(st);
    constexpr int DST_LD = QUANT ? HD : LD * 2;  // bytes between staged rows
#pragma unroll 4
    for (int i = tid; i < TILE * RCH; i += WNT) {
      const int r = i / RCH, c = i % RCH;
      const bool f = (live >> r) & 1ull;
      const long long off = f ? (long long)(l0 + r) * rs + c * (16 / sizeof(KT)) : 0;
      cp_async16(smem_u32(kd_ + r * DST_LD + 16 * c), kb + off, f);
      cp_async16(smem_u32(vd_ + r * DST_LD + 16 * c), vb + off, f);
    }
    if (QUANT && tid < TILE) {
      const bool f = (live >> tid) & 1ull;
      const long long off = f ? (long long)(l0 + tid) * KV : 0;
      cp_async4(smem_u32(ksc(st) + tid), k_scale + sc0 + off, f);
      cp_async4(smem_u32(vsc(st) + tid), v_scale + sc0 + off, f);
    }
    cp_commit();
  };

  float m_r = -INFINITY, l_r = 0.f;  // running max and sum of score row tid / 4
  float acc[MT][NPW][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  // each pass starts the next live tile's copies into stage st ^ 1, then
  // computes the tile in stage st (none on the first pass); one call site
  // per helper keeps them inline
  bool any_live = false;  // block-uniform
  Tile cur{ntiles, 0ull};
  int st = 1;
  for (int from = 0;;) {
    const Tile next = next_live(from);
    if (next.t < ntiles) fetch(c0 + next.t * TILE, next.live, st ^ 1);
    if (cur.t < ntiles) {
      const int l0 = c0 + cur.t * TILE;
      if (next.t < ntiles) {
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // stage st has landed for every thread (and Q, P's padding)
      if constexpr (QUANT) {  // widen the raw rows to the bf16 tiles
        const uint8_t* src = raw(st);
        for (int i = tid; i < 2 * TILE * (HD / 16); i += WNT) {
          const int kv = i / (TILE * (HD / 16)), j = i % (TILE * (HD / 16));
          const int r = j / (HD / 16), c = (j % (HD / 16)) * 16;
          const uint4 x = *reinterpret_cast<const uint4*>(src + kv * TILE * HD + r * HD + c);
          const uint32_t words[4] = {x.x, x.y, x.z, x.w};
          uint32_t w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const uint32_t word = words[u / 2] >> (16 * (u % 2));
            w[u] = pack_bf16(static_cast<float>(static_cast<int8_t>(word)),
                             static_cast<float>(static_cast<int8_t>(word >> 8)));
          }
          uint8_t* dst = (kv ? vt_bf(0) : kt_bf(0)) + (r * LD + c) * 2;
          reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
          reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        __syncthreads();
      }

      // S = Q K^T: warp w, keys 8w .. 8w+7, every query tile
      {
        const uint32_t kbase = smem_u32(kt_bf(st));
        const uint32_t qbase = smem_u32(qs);
        float sacc[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mi][e] = 0.f;
        // K rows 8w + lane % 8, columns 8 (lane / 8) of each 32: b0, b1 of two k-steps
        const uint32_t ka = kbase + ((8 * warp + (lane & 7)) * LD + 8 * (lane >> 3)) * 2;
        // Q rows lane % 16, columns 8 (lane / 16): an m16k16 A fragment
        const uint32_t qa = qbase + ((lane & 15) * LD + 8 * (lane >> 4)) * 2;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 32) {
          uint32_t bk[4];
          ldsm_x4(ka + kk * 2, bk);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            uint32_t a0[4], a1[4];
            ldsm_x4(qa + (16 * mi * LD + kk) * 2, a0);
            ldsm_x4(qa + (16 * mi * LD + kk + 16) * 2, a1);
            mma16816(sacc[mi], a0, bk[0], bk[1]);
            mma16816(sacc[mi], a1, bk[2], bk[3]);
          }
        }
        // scale (and k_scale) in f32, the reference's masks; to shared memory
        const int key = 8 * warp + 2 * (lane & 3);
        float f0 = scale, f1 = scale;
        if constexpr (QUANT) {
          f0 *= ksc(st)[key];
          f1 *= ksc(st)[key + 1];
        }
        const float x0 = l0 + key >= L ? -INFINITY : ((cur.live >> key) & 1ull) ? 0.f : NEG_INF;
        const float x1 =
            l0 + key + 1 >= L ? -INFINITY : ((cur.live >> (key + 1)) & 1ull) ? 0.f : NEG_INF;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = 16 * mi + (lane >> 2) + 8 * hh;
            const float s0 = x0 == 0.f ? sacc[mi][2 * hh] * f0 : x0;
            const float s1 = x1 == 0.f ? sacc[mi][2 * hh + 1] * f1 : x1;
            *reinterpret_cast<float2*>(ss + row * SLD + key) = make_float2(s0, s1);
          }
        }
      }
      __syncthreads();

      // online softmax: 4 threads per score row, 16 keys each (whole warps
      // idle past the padded rows); P = p (times v_scale) as hi + lo
      {
        const int r = tid >> 2, k0 = 16 * (tid & 3);
        if (r < P::GP) {  // warp-uniform: GP is a multiple of 16
          float x[16];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 f = *reinterpret_cast<const float4*>(ss + r * SLD + k0 + 4 * j);
            x[4 * j] = f.x, x[4 * j + 1] = f.y, x[4 * j + 2] = f.z, x[4 * j + 3] = f.w;
          }
          float mx = x[0];
#pragma unroll
          for (int j = 1; j < 16; ++j) mx = fmaxf(mx, x[j]);
          mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
          const float m_new = fmaxf(m_r, mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            x[j] = expf(x[j] - m_new);
            sum += x[j];
          }
          sum += __shfl_xor_sync(FULL_MASK, sum, 1);
          sum += __shfl_xor_sync(FULL_MASK, sum, 2);
          const float alpha = expf(m_r - m_new);
          l_r = l_r * alpha + sum;
          m_r = m_new;
          if (r < G) {  // P's padding rows stay zero
            if ((tid & 3) == 0) alpha_s[r] = alpha;
            uint32_t hw[8], lw[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float p0 = x[2 * j], p1 = x[2 * j + 1];
              if constexpr (QUANT) {
                p0 *= vsc(st)[k0 + 2 * j];
                p1 *= vsc(st)[k0 + 2 * j + 1];
              }
              const __nv_bfloat16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
              hw[j] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
              lw[j] = pack_bf16(p0 - __bfloat162float(h0), p1 - __bfloat162float(h1));
            }
            uint4* hp = reinterpret_cast<uint4*>(ph + r * PLD + k0);
            uint4* lp = reinterpret_cast<uint4*>(pl + r * PLD + k0);
            hp[0] = make_uint4(hw[0], hw[1], hw[2], hw[3]);
            hp[1] = make_uint4(hw[4], hw[5], hw[6], hw[7]);
            lp[0] = make_uint4(lw[0], lw[1], lw[2], lw[3]);
            lp[1] = make_uint4(lw[4], lw[5], lw[6], lw[7]);
          }
        }
      }
      __syncthreads();

      // O = alpha O + P_hi V + P_lo V: warp w, columns (HD / 8) w .. + HD / 8
      {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float a0 = alpha_s[16 * mi + (lane >> 2)], a1 = alpha_s[16 * mi + (lane >> 2) + 8];
#pragma unroll
          for (int n = 0; n < NPW; ++n) {
            acc[mi][n][0] *= a0;
            acc[mi][n][1] *= a0;
            acc[mi][n][2] *= a1;
            acc[mi][n][3] *= a1;
          }
        }
        const uint32_t vbase = smem_u32(vt_bf(st));
        // V rows lane % 8 + 8 ((lane / 8) % 2), columns + 8 (lane / 16): b0, b1 of two n-tiles
        const uint32_t va =
            vbase + (((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + (HD / 8) * warp + 8 * (lane >> 4)) * 2;
        const uint32_t pa = smem_u32(ph) + ((lane & 15) * PLD + 8 * (lane >> 4)) * 2;
        const uint32_t pla = smem_u32(pl) + ((lane & 15) * PLD + 8 * (lane >> 4)) * 2;
#pragma unroll
        for (int kk = 0; kk < TILE; kk += 16) {
          if (((cur.live >> kk) & 0xFFFFull) == 0ull) continue;  // 16 dead rows: p = 0 (warp-uniform)
          uint32_t bv[NPW][2];
          if constexpr (NPW == 1) {
            ldsm_x2_t(va + kk * LD * 2, bv[0][0], bv[0][1]);
          } else {
#pragma unroll
            for (int n = 0; n < NPW; n += 2) {
              uint32_t r4[4];
              ldsm_x4_t(va + (kk * LD + 16 * (n / 2)) * 2, r4);
              bv[n][0] = r4[0];
              bv[n][1] = r4[1];
              bv[n + 1][0] = r4[2];
              bv[n + 1][1] = r4[3];
            }
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            uint32_t ah[4], al[4];
            ldsm_x4(pa + (16 * mi * PLD + kk) * 2, ah);
            ldsm_x4(pla + (16 * mi * PLD + kk) * 2, al);
#pragma unroll
            for (int n = 0; n < NPW; ++n) {
              mma16816(acc[mi][n], ah, bv[n][0], bv[n][1]);
              mma16816(acc[mi][n], al, bv[n][0], bv[n][1]);
            }
          }
        }
      }
      __syncthreads();  // stage st and the scores / P are free for the next tile
      any_live = true;
    }
    if (next.t >= ntiles) break;
    cur = next;
    from = next.t + 1;
    st ^= 1;
  }
  if (!any_live) asm volatile("cp.async.wait_all;\n" ::: "memory");  // the queries' copies

  if constexpr (CLUSTER) {
    // this chunk's partial stays in shared memory (acc [G][HD] over the free
    // K/V tiles; an empty chunk leaves m = -inf and no acc)
    float* pacc = reinterpret_cast<float*>(dsm + P::KV_OFF);
    if (any_live) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int g = 16 * mi + (lane >> 2) + 8 * hh;
          if (g < G) {
#pragma unroll
            for (int n = 0; n < NPW; ++n) {
              const int c = (HD / 8) * warp + 8 * n + 2 * (lane & 3);
              *reinterpret_cast<float2*>(pacc + g * HD + c) =
                  make_float2(acc[mi][n][2 * hh], acc[mi][n][2 * hh + 1]);
            }
          }
        }
    }
    if ((tid & 3) == 0 && (tid >> 2) < G) {
      cm[tid >> 2] = m_r;
      cl[tid >> 2] = l_r;
    }
    cluster_sync();  // every chunk of the row has its partial in place
    // the weights of every chunk for each head, read from the other blocks
    if (tid < G) {  // every block's (m, l) of head tid, all loads in flight together
      float mv[MAX_CLUSTER], lv[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        mv[r] = -INFINITY;
        lv[r] = 0.f;
        if (r < S) {
          mv[r] = ld_cluster(mapa(smem_u32(cm + tid), r));
          lv[r] = ld_cluster(mapa(smem_u32(cl + tid), r));
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) mx = fmaxf(mx, mv[r]);
      float lsum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        const float w = mv[r] == -INFINITY ? 0.f : expf(mv[r] - mx);
        cw[r][tid] = w;
        lsum = fmaf(w, lv[r], lsum);  // an empty chunk's l is 0
      }
      m_s[tid] = mx;
      l_s[tid] = lsum;
    }
    __syncthreads();
    // out = sum_r w[r][g] acc_r / l: the (head, 4 columns) items spread over
    // the cluster's blocks, every chunk's load of an item in flight together
    __nv_bfloat16* ob = out + ((long long)b * KV + h) * G * HD;
    constexpr int C4 = HD / 4;
    for (int i = split * WNT + tid; i < G * C4; i += S * WNT) {
      const int g = i / C4, c = (i % C4) * 4;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      float den = fmaxf(l_s[g], 1e-30f);
      if (m_s[g] == -INFINITY) {
        // no live row in the whole cache row: the uniform mean of V over all L
        for (int r = 0; r < L; ++r) {
          float x[4];
          mma::ld4_as_float(vb + (long long)r * rs + c, x);
          const float vsl = QUANT ? v_scale[sc0 + (long long)r * KV] : 1.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] += QUANT ? x[e] * vsl : x[e];
        }
        den = static_cast<float>(L);
      } else {
        float4 x[MAX_CLUSTER];
        const uint32_t addr = smem_u32(pacc + g * HD + c);
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < S) x[r] = ld_cluster4(mapa(addr, r));
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r) {
          const float w = cw[r][g];
          if (w != 0.f) {  // an empty chunk wrote no acc
            a[0] = fmaf(w, x[r].x, a[0]);
            a[1] = fmaf(w, x[r].y, a[1]);
            a[2] = fmaf(w, x[r].z, a[2]);
            a[3] = fmaf(w, x[r].w, a[3]);
          }
        }
      }
      const __nv_bfloat162 o01 = __floats2bfloat162_rn(a[0] / den, a[1] / den);
      const __nv_bfloat162 o23 = __floats2bfloat162_rn(a[2] / den, a[3] / den);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&o01);
      packed.y = *reinterpret_cast<const uint32_t*>(&o23);
      *reinterpret_cast<uint2*>(ob + g * HD + c) = packed;
    }
    cluster_sync();  // no block leaves while another may still read its partial
    return;
  }

  // this chunk's partial; an empty chunk leaves m = -inf and no acc
  if (any_live) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int g = 16 * mi + (lane >> 2) + 8 * hh;
        if (g < G) {
#pragma unroll
          for (int n = 0; n < NPW; ++n) {
            const int c = (HD / 8) * warp + 8 * n + 2 * (lane & 3);
            *reinterpret_cast<float2*>(part_acc + (pbase + g) * HD + c) =
                make_float2(acc[mi][n][2 * hh], acc[mi][n][2 * hh + 1]);
          }
        }
      }
    }
  }
  if ((tid & 3) == 0 && (tid >> 2) < G) {
    part_ml[2 * (pbase + (tid >> 2))] = m_r;
    part_ml[2 * (pbase + (tid >> 2)) + 1] = l_r;
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
  // every (m, l) of the row at once, into [S][G] arrays over the free K/V
  // tiles; then one thread per head turns its m's into weights
  float* wsm = reinterpret_cast<float*>(dsm + P::KV_OFF);  // m, then the weight
  float* lsm = wsm + S * G;                                // l
#pragma unroll 4
  for (int i = tid; i < S * G; i += WNT) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + e0 + i);
    wsm[i] = ml.x;
    lsm[i] = ml.y;
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, wsm[s * G + tid]);
    float lsum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms_ = wsm[s * G + tid];
      const float w = ms_ == -INFINITY ? 0.f : expf(ms_ - mx);
      wsm[s * G + tid] = w;
      lsum = fmaf(w, lsm[s * G + tid], lsum);
    }
    m_s[tid] = mx;
    l_s[tid] = lsum;
  }
  __syncthreads();
  // out = sum_s w[s][g] acc_s / l: thread tid owns the 4-column items tid,
  // tid + WNT, ... (head i / (HD / 4)) and sums them over the splits with
  // U splits' loads of every item in flight together
  __nv_bfloat16* ob = out + ((long long)b * KV + h) * G * HD;
  constexpr int C4 = HD / 4;                     // 4-column items per head
  constexpr int NI = (16 * MT * C4 + WNT - 1) / WNT;  // items per thread, at most
  constexpr int U = NI >= 8 ? 1 : NI >= 4 ? 2 : 4;  // splits in flight
  float a[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
  const float* pa = part_acc + e0 * HD;
  for (int s0 = 0; s0 < S; s0 += U) {
    float4 x[U][NI];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int i = tid + WNT * j;
        if (s0 + u < S && i < G * C4)
          x[u][j] = __ldcg(reinterpret_cast<const float4*>(pa + (long long)(s0 + u) * G * HD) + i);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int i = tid + WNT * j;
        if (s0 + u < S && i < G * C4) {
          const float w = wsm[(s0 + u) * G + i / C4];
          if (w != 0.f) {  // an empty chunk wrote no acc
            a[j][0] = fmaf(w, x[u][j].x, a[j][0]);
            a[j][1] = fmaf(w, x[u][j].y, a[j][1]);
            a[j][2] = fmaf(w, x[u][j].z, a[j][2]);
            a[j][3] = fmaf(w, x[u][j].w, a[j][3]);
          }
        }
      }
  }
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int i = tid + WNT * j;
    if (i >= G * C4) continue;
    const int g = i / C4, c = (i % C4) * 4;
    float den = fmaxf(l_s[g], 1e-30f);
    if (m_s[g] == -INFINITY) {
      // no live row in the whole cache row: the uniform mean of V over all L
      a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
      for (int r = 0; r < L; ++r) {
        float x[4];
        mma::ld4_as_float(vb + (long long)r * rs + c, x);
        const float vsl = QUANT ? v_scale[sc0 + (long long)r * KV] : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) a[j][e] += QUANT ? x[e] * vsl : x[e];
      }
      den = static_cast<float>(L);
    }
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(a[j][0] / den, a[j][1] / den);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(a[j][2] / den, a[j][3] / den);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&o01);
    packed.y = *reinterpret_cast<const uint32_t*>(&o23);
    *reinterpret_cast<uint2*>(ob + g * HD + c) = packed;
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

template <typename KT, int HD, int MT, bool CLUSTER>
cudaError_t launch_mma_as(const Args& a) {
  using P = mma::Plan<KT, HD, MT>;
  auto kern = decode_mma_kernel<KT, HD, MT, CLUSTER>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.KV, a.B);
  cfg.blockDim = dim3(WNT);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;  // a cache row's chunks
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const __nv_bfloat16*>(a.q),
                           static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
                           static_cast<const uint8_t*>(a.valid),
                           static_cast<const float*>(a.k_scale),
                           static_cast<const float*>(a.v_scale),
                           static_cast<__nv_bfloat16*>(a.out), a.part_acc, a.part_ml, a.counters,
                           a.L, a.KV, a.G, a.chunk, a.scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// a row of at most MAX_CLUSTER chunks combines in its cluster, a longer one
// through the partials in device memory and the last block's count
template <typename KT, int HD, int MT>
cudaError_t launch_mma(const Args& a) {
  if (a.S <= MAX_CLUSTER) return launch_mma_as<KT, HD, MT, true>(a);
  return launch_mma_as<KT, HD, MT, false>(a);
}

// the wide shapes: bf16 queries on the tensor cores (G padded to 16-row
// tiles), f32 queries on the CUDA-core body (TF32 would not meet the f32 bound)
template <typename T, typename KT, int HD, bool QUANT>
cudaError_t dispatch_wide(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (a.S * a.G > MAX_PARTIALS) return cudaErrorInvalidValue;
    if (a.G <= 16) return launch_mma<KT, HD, 1>(a);
    if (a.G <= 32) return launch_mma<KT, HD, 2>(a);
    if (a.G <= 48) return launch_mma<KT, HD, 3>(a);
    return launch_mma<KT, HD, 4>(a);
  } else {
    if (a.G <= WNW) return launch_wide<T, KT, HD, 1, QUANT>(a);
    if (a.G <= 2 * WNW) return launch_wide<T, KT, HD, 2, QUANT>(a);
    if (a.G <= 4 * WNW) return launch_wide<T, KT, HD, 4, QUANT>(a);
    return launch_wide<T, KT, HD, 8, QUANT>(a);
  }
}

// hd 64 / 128 with G <= 2 keep the split kernel (faster there: PERF.md);
// wider groups and hd 256 take the wide bodies, as every shape does with `wide`
template <typename T, int HD>
cudaError_t dispatch_quant(int quantized, bool wide, const Args& a) {
  if (HD == 256 || wide || a.G > MAXG) {
    if (quantized) return dispatch_wide<T, int8_t, HD, true>(a);
    return dispatch_wide<T, T, HD, false>(a);
  }
  if constexpr (HD != 256) {
    if (quantized) return launch<T, int8_t, HD, MAXG, true>(a);
    return launch<T, T, HD, MAXG, false>(a);
  }
  return cudaErrorInvalidValue;
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
