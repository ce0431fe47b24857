// decode_attn: one-token grouped-query decode attention over the KV cache.
//
// Replaces repro/kernels/decode.py::decode_attention_pallas (_decode_kernel).
//
// What bounds it on the H100: memory.  One query token per head attends the
// whole [L, hd] K and V of its kv head, ~1 FLOP per cache byte, so the
// floor is (K + V bytes) / 3.35 TB/s.  The design reads each cache byte
// exactly once:
//   * one block owns one (batch, kv-head) pair and keeps its G query heads
//     (pre-scaled, f32) in shared memory, so grouped heads share one pass
//     over K/V -- no repeat_kv copy;
//   * K is scored 8 lanes per position (16-byte vector loads along hd, a
//     3-step shuffle reduction), V is accumulated one hd column per thread
//     (coalesced rows); slabs of 64 positions run an f32 online softmax;
//   * the `valid` row mask (linear cache or wrapped ring buffer) uses the
//     finite -1e30 sentinel of the reference; positions past L use -inf so
//     they weigh exactly zero;
//   * QUANT (template flag): K/V are int8 with per-(slot, kv-head) f32
//     scales, applied exactly where the reference applies them -- k_scale
//     on the scores after QK, v_scale on p before PV (the softmax sum uses
//     the unscaled p) -- so the cache is read at one byte per element.
// Known limit: B * KV blocks (32 at 4 slots x 8 kv heads) fill a quarter of
// the 132 SMs; splitting L across blocks is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int TL = 64;   // cache positions per slab
constexpr int LPP = 8;   // lanes per position in the score pass
constexpr int MAXG = 8;  // query heads per kv head

template <typename T, typename KT, int HD, bool QUANT>
__global__ void __launch_bounds__(HD)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
              const uint8_t* __restrict__ valid, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, T* __restrict__ out, int L, int KV, int G,
              float scale) {
  constexpr int NT = HD;           // one thread per hd column in the PV pass
  constexpr int EPL = HD / LPP;    // elements per lane in the score pass
  constexpr int NPG = NT / LPP;    // positions scored at once
  constexpr int NW = NT / 32;
  extern __shared__ float sm[];
  float* qs = sm;                  // [G][HD], pre-scaled
  float* ps = qs + G * HD;         // [G][TL] scores, then probabilities
  float* ms = ps + G * TL;         // [G] running max
  float* ls = ms + G;              // [G] running sum
  float* as = ls + G;              // [G] this slab's rescale

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane32 = tid % 32;
  const int grp = tid / LPP, lane = tid % LPP;

  const T* qb = q + (long long)(b * KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += NT) qs[i] = to_float(qb[i]) * scale;
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const long long row = (long long)KV * HD;  // elements between positions
  const KT* kb = k + (long long)b * L * row + (long long)h * HD;
  const KT* vb = v + (long long)b * L * row + (long long)h * HD;
  const uint8_t* validb = valid + (long long)b * L;
  const long long sc0 = (long long)b * L * KV + h;  // scale of position l: sc0 + l * KV

  for (int l0 = 0; l0 < L; l0 += TL) {
    __syncthreads();  // q staged / previous slab's probabilities consumed
    for (int lp = grp; lp < TL; lp += NPG) {
      const int l = l0 + lp;
      const bool in_range = l < L;
      float kf[EPL];
      if (in_range) {
        load_as_float<KT, EPL>(kb + l * row + lane * EPL, kf);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float* qg = qs + g * HD + lane * EPL;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qg[e], kf[e], s);
#pragma unroll
          for (int off = LPP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) {
            if (!in_range) {
              s = -INFINITY;
            } else {
              if (QUANT) s *= k_scale[sc0 + (long long)l * KV];
              if (!validb[l]) s = NEG_INF;
            }
            ps[g * TL + lp] = s;
          }
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      float mx = -INFINITY;
      for (int lp = lane32; lp < TL; lp += 32) mx = fmaxf(mx, ps[g * TL + lp]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int lp = lane32; lp < TL; lp += 32) {
        float p = expf(ps[g * TL + lp] - m_new);
        sum += p;
        if (QUANT && l0 + lp < L) p *= v_scale[sc0 + (long long)(l0 + lp) * KV];
        ps[g * TL + lp] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane32 == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= as[g];
    const int n = min(TL, L - l0);
    for (int lp = 0; lp < n; ++lp) {
      const float vv = to_float(vb[(l0 + lp) * row + tid]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = fmaf(ps[g * TL + lp], vv, acc[g]);
    }
  }

  T* ob = out + (long long)(b * KV + h) * G * HD;
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) ob[g * HD + tid] = from_float<T>(acc[g] / fmaxf(ls[g], 1e-30f));
}

template <typename T, typename KT, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid,
                   const void* k_scale, const void* v_scale, void* out, int B, int L, int KV,
                   int G, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * HD + G * TL + 3 * G);
  const dim3 grid(KV, B);
  decode_kernel<T, KT, HD, QUANT><<<grid, HD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<T*>(out), L, KV, G, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_quant(int quantized, const void* q, const void* k, const void* v,
                           const void* valid, const void* ks, const void* vs, void* out, int B,
                           int L, int KV, int G, float scale, cudaStream_t st) {
  if (quantized)
    return launch<T, int8_t, HD, true>(q, k, v, valid, ks, vs, out, B, L, KV, G, scale, st);
  return launch<T, T, HD, false>(q, k, v, valid, ks, vs, out, B, L, KV, G, scale, st);
}

}  // namespace
}  // namespace repro

// q, out: [B, KV, G, hd] contiguous; k, v: [B, L, KV, hd] contiguous (dtype of
// q, or int8 when quantized); valid: [B, L] bytes; k_scale, v_scale:
// [B, L, KV] f32 (quantized only).  dtype: 0 = f32, 1 = bf16.
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v, const void* valid,
                                 const void* k_scale, const void* v_scale, void* out, int dtype,
                                 int quantized, int B, int L, int KV, int G, int hd, float scale,
                                 void* stream) {
  using namespace repro;
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && hd == 128)
    return dispatch_quant<float, 128>(quantized, q, k, v, valid, k_scale, v_scale, out, B, L, KV,
                                      G, scale, st);
  if (dtype == DT_F32 && hd == 64)
    return dispatch_quant<float, 64>(quantized, q, k, v, valid, k_scale, v_scale, out, B, L, KV,
                                     G, scale, st);
  if (dtype == DT_BF16 && hd == 128)
    return dispatch_quant<__nv_bfloat16, 128>(quantized, q, k, v, valid, k_scale, v_scale, out,
                                              B, L, KV, G, scale, st);
  if (dtype == DT_BF16 && hd == 64)
    return dispatch_quant<__nv_bfloat16, 64>(quantized, q, k, v, valid, k_scale, v_scale, out, B,
                                             L, KV, G, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
