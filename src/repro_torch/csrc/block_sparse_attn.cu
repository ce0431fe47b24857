// block_sparse_attn_fwd: attention over a SKIP / PARTIAL / FULL block bitmap.
//
// Replaces repro/kernels/block_sparse.py::block_sparse_attention_pallas
// (_block_sparse_kernel).
//
// The pattern (kernels/block_sparse.py::BlockSparsePattern) is compacted on
// the host into per-q-block lists: kv_index[qb, j] and kv_state[qb, j] for
// j < count[qb], the live kv blocks in ascending order.  A q block visits
// only those: a PARTIAL block gets the causal / window element mask, a FULL
// block none, and a SKIP block is never loaded.  So the work is
// O(density * S^2), as on the TPU.
//
// What bounds it on the H100: at prefill shapes, operations (2 * hd FLOPs
// per live (q, k) pair for each of QK and PV against q/k/v/o bytes once).
// This first version is the flash kernel's tiling (csrc/flash_attn.cu),
// walking a list instead of a range: f32 math on the CUDA cores, far below
// the bf16 tensor-core roof; wgmma / TMA are later work.
//   * one block owns TQ query rows inside one q block (TQ = 64, or the q
//     block's size when it is 8, 16 or 32; 4 * TQ threads, 4 rows per 16
//     lanes) and reads its q block's list from device memory;
//   * each live kv block is swept in 32-key sub-tiles staged in shared
//     memory as f32; keys past the kv block's end are masked, so any block
//     size from 8 to 128 (and beyond) works;
//   * the online softmax keeps the reference's finite -1e30 sentinel (a row
//     whose first visited keys are all masked gathers a bogus uniform sum
//     that exp(m_prev - m_cur) = 0 wipes out at its first live key) and the
//     max(l, 1e-30) clamp;
//   * q, k, v, o are read and written through their [B, S, H, hd] strides,
//     as flash_attn_fwd does: no fold or transpose copies.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BK = 32;       // keys per sub-tile
constexpr int ST_FULL = 2;   // kv_state value of a FULL block (SKIP 0, PARTIAL 1)

template <typename T, int HD, int TQ>
__global__ void __launch_bounds__(4 * TQ)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ kv_index, const int* __restrict__ kv_state,
                        const int* __restrict__ count, int width, int H, int Sq, int Sk,
                        int block_q, int block_k, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, int causal, int window) {
  constexpr int THREADS = 4 * TQ;
  constexpr int LDQ = HD + 4;  // float4 reads of Q/K rows stay conflict-free
  constexpr int LDV = HD;
  constexpr int LDP = BK + 4;
  constexpr int NJ = BK / 16;  // score columns per thread
  constexpr int NO = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [TQ][LDQ], pre-scaled
  float* Ks = Qs + TQ * LDQ;   // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;   // [BK][LDV]
  float* Ps = Vs + BK * LDV;   // [TQ][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TQ;  // block_q % TQ == 0
  const int qb = q0 / block_q;
  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  T* obase = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows 4*rg .. 4*rg+3 of the q tile
  const int cg = tid % 16;  // columns cg + 16*j

  load_tile<T, HD, LDQ, THREADS>(Qs, qbase, qs.s, q0, Sq, TQ, scale);

  float acc[4][NO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  const int n_live = count[qb];
  const int* idx_row = kv_index + static_cast<long long>(qb) * width;
  const int* st_row = kv_state + static_cast<long long>(qb) * width;
  for (int jb = 0; jb < n_live; ++jb) {
    const int kb = idx_row[jb];
    const bool full = st_row[jb] == ST_FULL;
    const int kb_end = min((kb + 1) * block_k, Sk);
    for (int k0 = kb * block_k; k0 < kb_end; k0 += BK) {
      const int k_end = min(k0 + BK, kb_end);  // keys of this kv block only
      __syncthreads();  // previous sub-tile fully consumed (and Q staged)
      load_tile<T, HD, LDQ, THREADS>(Ks, kbase, ks.s, k0, k_end, BK, 1.f);
      load_tile<T, HD, LDV, THREADS>(Vs, vbase, vs.s, k0, k_end, BK, 1.f);
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
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * rg + i) * LDQ + d]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          kv[j] = *reinterpret_cast<const float4*>(&Ks[(cg + 16 * j) * LDQ + d]);
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
          const bool live = kp < k_end &&
                            (full || ((!causal || kp <= qp) && (window <= 0 || qp - kp < window)));
          if (!live) s[i][j] = NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_cur = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_cur);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // keys past the kv block's end are not part of it: they add nothing
          const float p = (k0 + cg + 16 * j < k_end) ? expf(s[i][j] - m_cur) : 0.f;
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

      // keys past k_end have p = 0 and zero-filled V rows: they add nothing
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * rg + i;
    if (qp < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = obase + (long long)qp * os.s;
#pragma unroll
      for (int j = 0; j < NO; ++j) orow[cg + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD, int TQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* idx,
                   const int* state, const int* cnt, int width, int B, int H, int Sq, int Sk,
                   int block_q, int block_k, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr int LDQ = HD + 4;
  const size_t smem = sizeof(float) * (TQ * LDQ + BK * LDQ + BK * HD + TQ * (BK + 4));
  auto kern = block_sparse_fwd_kernel<T, HD, TQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / TQ, B * H);
  kern<<<grid, 4 * TQ, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), idx, state,
                                       cnt, width, H, Sq, Sk, block_q, block_k, qs, ks, vs, os,
                                       scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_tq(int tq, const void* q, const void* k, const void* v, void* o,
                      const int* idx, const int* state, const int* cnt, int width, int B, int H,
                      int Sq, int Sk, int block_q, int block_k, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, int causal, int window,
                      cudaStream_t st) {
  switch (tq) {
    case 64: return launch<T, HD, 64>(q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                                      block_k, qs, ks, vs, os, scale, causal, window, st);
    case 32: return launch<T, HD, 32>(q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                                      block_k, qs, ks, vs, os, scale, causal, window, st);
    case 16: return launch<T, HD, 16>(q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                                      block_k, qs, ks, vs, os, scale, causal, window, st);
    case 8: return launch<T, HD, 8>(q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                                    block_k, qs, ks, vs, os, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, o: [B, Sq, H, hd]; k, v: [B, Sk, H, hd], addressed by (batch, seq, head)
// strides in elements (head dim contiguous, rows 16-byte aligned).
// kv_index, kv_state: [Sq / block_q, width] int32; count: [Sq / block_q]
// int32 (the pattern's compact()).  Sq % block_q == 0, block_q % 8 == 0;
// each block covers min(64, largest power of two dividing block_q) rows.
// dtype: 0 = f32, 1 = bf16.  window <= 0 means no window.
extern "C" int repro_block_sparse_attn_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_index,
    const void* kv_state, const void* count, int width, int dtype, int B, int H, int Sq, int Sk,
    int hd, int block_q, int block_k, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    int window, void* stream) {
  using namespace repro;
  if (block_q < 8 || block_q % 8 != 0 || Sq % block_q != 0 || block_k < 1 || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tq = block_q % 64 == 0 ? 64 : block_q % 32 == 0 ? 32 : block_q % 16 == 0 ? 16 : 8;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const int* idx = static_cast<const int*>(kv_index);
  const int* state = static_cast<const int*>(kv_state);
  const int* cnt = static_cast<const int*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_F32 && hd == 128)
    err = launch_tq<float, 128>(tq, q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                                block_k, qs, ks, vs, os, scale, causal, window, st);
  else if (dtype == DT_F32 && hd == 64)
    err = launch_tq<float, 64>(tq, q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk, block_q,
                               block_k, qs, ks, vs, os, scale, causal, window, st);
  else if (dtype == DT_BF16 && hd == 128)
    err = launch_tq<__nv_bfloat16, 128>(tq, q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk,
                                        block_q, block_k, qs, ks, vs, os, scale, causal, window,
                                        st);
  else if (dtype == DT_BF16 && hd == 64)
    err = launch_tq<__nv_bfloat16, 64>(tq, q, k, v, o, idx, state, cnt, width, B, H, Sq, Sk,
                                       block_q, block_k, qs, ks, vs, os, scale, causal, window,
                                       st);
  return static_cast<int>(err);
}
