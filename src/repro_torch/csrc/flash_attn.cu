// flash_attn_fwd: causal / windowed online-softmax attention for Hopper.
//
// Replaces two TPU kernels of the reference:
//   * repro/kernels/flash_attention.py::flash_attention_pallas (_flash_kernel)
//   * repro/kernels/sliding_window.py::sliding_window_attention_pallas
//     (_sliding_window_kernel)
// On the TPU the sliding-window kernel exists because the flash kernel kept
// the whole key sequence resident in VMEM; here the kv loop inside a block
// already loads only the live band, so one kernel serves both wrappers
// (kernels/flash_attention.py and kernels/sliding_window.py, each with its
// own launch counter).
//
// What bounds it on the H100: at prefill shapes attention is compute-bound
// (2 * BH * pairs * hd FLOPs for each of QK and PV against q/k/v/o bytes
// once).  This first version multiplies in f32 on the CUDA cores (no wgmma,
// no TMA), so it sits far below the 989 TFLOP/s bf16 tensor-core roof; the
// design keeps it correct and never worse than O(live pairs):
//   * one block owns one (batch*head, 64-query tile); the kv loop runs only
//     from the first to the last live 32-key tile (causal: last_q / BK,
//     window: (first_q - window + 1) / BK), so fully masked tiles are never
//     loaded -- the band of a sliding window costs O(window), not O(S);
//   * Q, K, V tiles are staged in shared memory as f32 with padded rows so
//     the 4x2 score and 4x8 output register tiles read without bank
//     conflicts; the running max / sum / accumulator stay in registers;
//   * ragged Sq / Sk are masked in-kernel (no padding copies in the wrapper);
//   * inputs are addressed through their [B, S, H, hd] strides, so the
//     model's layout is read in place (no fold / transpose copies).
// Later work: wgmma on bf16 tiles with TMA-fed double buffering.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 32;        // keys per kv tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal, int window) {
  constexpr int LDQ = HD + 4;  // float4 reads of Q/K rows stay conflict-free
  constexpr int LDV = HD;
  constexpr int LDP = BK + 4;
  constexpr int NJ = BK / 16;  // score columns per thread
  constexpr int NO = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LDQ], pre-scaled
  float* Ks = Qs + BQ * LDQ;   // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;   // [BK][LDV]
  float* Ps = Vs + BK * LDV;   // [BQ][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows 4*rg .. 4*rg+3 of the q tile
  const int cg = tid % 16;  // columns cg + 16*j

  load_tile<T, HD, LDQ, THREADS>(Qs, qb, qs.s, q0, Sq, BQ, scale);

  // live kv tiles: [kv_begin, kv_end)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kv = (Sk + BK - 1) / BK;
  const int kv_end = causal ? min(q_last / BK + 1, n_kv) : n_kv;
  int kv_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_begin = first > 0 ? first / BK : 0;
  }

  float acc[4][NO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kv_begin; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed (and Q staged)
    load_tile<T, HD, LDQ, THREADS>(Ks, kb, ks.s, k0, Sk, BK, 1.f);
    load_tile<T, HD, LDV, THREADS>(Vs, vb, vs.s, k0, Sk, BK, 1.f);
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * rg + i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(cg + 16 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask + online softmax; the 16 lanes of a row group share its 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + cg + 16 * j;
        const bool live = kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        if (!live) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_cur);
        Ps[(4 * rg + i) * LDP + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row group's P rows are written and read by its own warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float vv = Vs[kk * LDV + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * rg + i;
    if (qp < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = ob + (long long)qp * os.s;
#pragma unroll
      for (int j = 0; j < NO; ++j) orow[cg + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int LDQ = HD + 4;
  const size_t smem =
      sizeof(float) * (BQ * LDQ + BK * LDQ + BK * HD + BQ * (BK + 4));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk,
                                        qs, ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, k, v, o: [B, S, H, hd] addressed by (batch, seq, head) strides in
// elements; the head dim is contiguous and rows are 16-byte aligned.
// dtype: 0 = f32, 1 = bf16.  window <= 0 means no window.
extern "C" int repro_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int H, int Sq, int Sk, int hd,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long o_sb, long long o_ss, long long o_sh, float scale,
                                    int causal, int window, void* stream) {
  using namespace repro;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, window, st);
  if (dtype == DT_F32 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, window, st);
  if (dtype == DT_BF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                                      window, st);
  if (dtype == DT_BF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                                     window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
