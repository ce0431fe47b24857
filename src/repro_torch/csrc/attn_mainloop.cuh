// attn_mainloop.cuh: the one attention mainloop behind flash_attn_fwd
// (csrc/flash_attn.cu) and block_sparse_attn_fwd (csrc/block_sparse_attn.cu).
//
// Replaces three TPU kernels of the reference:
//   * repro/kernels/flash_attention.py::flash_attention_pallas (_flash_kernel)
//   * repro/kernels/sliding_window.py::sliding_window_attention_pallas
//     (_sliding_window_kernel)
//   * repro/kernels/block_sparse.py::block_sparse_attention_pallas
//     (_block_sparse_kernel)
// They differ only in which kv tiles a query tile visits, so one loop body
// serves all three, over a schedule:
//   * RangeSchedule (flash, sliding window): kv tiles [first, last] from the
//     causal and window limits, computed in-kernel;
//   * ListSchedule (block-sparse): per query tile, the sorted kv tiles that
//     hold a live pair of the pattern, re-tiled on the host
//     (kernels/block_sparse.py::BlockSparsePattern.kernel_tiles), each
//     flagged FULL (no mask), ELEM (the causal / window rule alone decides)
//     or BLOCKS (liveness from the block bitmap and the causal / window
//     rule, as ref.block_sparse_mask: only patterns that skip blocks the
//     rule would keep, such as strided ones, need it).
//
// What bounds it on the H100: at prefill shapes, operations -- 4 * hd FLOPs
// per live (q, k) pair against q/k/v/o bytes read once (B1 S8448 window
// 8192: 2.9e11 FLOPs, 0.295 ms at the 989 TFLOP/s bf16 tensor-core peak;
// the f32 CUDA cores could not go below 4.4 ms).  What the design does:
//   * bf16 on the tensor cores: a CTA owns 128 query rows of one (batch,
//     head) as two consumer warpgroups of 64 rows (64 rows, one warpgroup,
//     when Sq <= 64); S = Q.K^T and O += P.V are wgmma.m64nNk16 with bf16
//     operands and f32 accumulators (Q, K, V from shared memory, P from
//     registers); kv tiles are 128 keys; at hd 256 each kv tile arrives as
//     two 64-key stages (S = Q.K^T on wgmma.m64n64k16, O += P.V on
//     m64n256k16) that both consumer warpgroups read, so Q (64 KB) and a
//     2-stage ring (128 KB) fit in 192 KB, each stage is loaded once per
//     128 query rows, and the f32 output (128 registers a thread) fits in
//     the 232 registers that setmaxnreg gives a consumer;
//   * the softmax runs on the S accumulator in registers: the scale is
//     applied in f32 to the scores (with log2(e) folded in, for exp2f),
//     row max and sum by quad shuffles, P rounded once to bf16 for the PV
//     product (the one rounding the plain version does not make: at most
//     2^-8 * (plain attention of |v|) per output element);
//   * one producer warp feeds a 2-stage K/V ring with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, as wgmma's descriptors read
//     it) over the strided [B, S, H, hd] view, and mbarriers hand stages to
//     the consumers and back; out-of-range rows arrive zero-filled;
//   * the element mask runs only on tiles that need it (the causal
//     diagonal, the window's edges, a ragged tail, block-sparse tiles not
//     FULL), and reads the bitmap only on BLOCKS tiles; a SKIP-only tile is
//     never scheduled, so never loaded;
//   * the reference's finite -1e30 sentinel and max(l, 1e-30) clamp: a row
//     whose first visited keys are all masked gathers a bogus uniform sum
//     that exp2(m_prev - m_cur) = 0 wipes out at its first live key; once
//     a row has a live key, a masked pair adds exactly 0;
//   * the heaviest query tiles (most kv tiles) launch first.
// f32 inputs do not go to the tensor cores (TF32 would not meet the f32
// bound): they take the CUDA-core body below (64-row blocks, f32 tiles in
// shared memory, 32-key sub-tiles), over the same schedules.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "common.cuh"

namespace repro {

constexpr int TILE_K = 128;                // keys per kv tile (both bodies)
constexpr int STAGES = 2;                  // K/V ring depth of the bf16 body
constexpr float LOG2E = 1.4426950408889634f;

// Query rows per tile: 128 (two consumer warpgroups), or 64 for Sq <= 64.
// kernels/flash_attention.py::tile_q mirrors this rule.
inline int tile_q_for(int Sq) { return Sq <= 64 ? 64 : 128; }

// how a kv tile is masked (kernels/flash_attention.py: MASK_*)
constexpr int MASK_NONE = 0;    // every (q, k) pair of the tile is live
constexpr int MASK_ELEM = 1;    // live: k < Sk and the causal / window rule
constexpr int MASK_BLOCKS = 2;  // live: the schedule's own rule (block bitmap)

struct KvTile {
  int index;  // kv tile: keys [index * TILE_K, (index + 1) * TILE_K)
  int mask;   // MASK_*
};

__device__ __forceinline__ bool elem_live(int q, int k, int Sk, int causal, int window) {
  return k < Sk && (!causal || k <= q) && (window <= 0 || q - k < window);
}

// Flash and sliding window: the live kv tiles of query tile qt are a range.
struct RangeSchedule {
  int Sq, Sk, causal, window, tile_q;

  __device__ __forceinline__ int first(int qt) const {
    const int f = qt * tile_q - window + 1;
    return window > 0 && f > 0 ? f / TILE_K : 0;
  }
  __device__ __forceinline__ int count(int qt) const {
    const int n_kv = (Sk + TILE_K - 1) / TILE_K;
    const int q_last = min((qt + 1) * tile_q, Sq) - 1;
    const int end = causal ? min(q_last / TILE_K + 1, n_kv) : n_kv;
    return max(end - first(qt), 0);
  }
  __device__ __forceinline__ KvTile tile(int qt, int i) const {
    const int kt = first(qt) + i;
    const int q0 = qt * tile_q, q_last = min(q0 + tile_q, Sq) - 1;
    const int k0 = kt * TILE_K, k_last = k0 + TILE_K - 1;
    const bool full =
        k_last < Sk && (!causal || k_last <= q0) && (window <= 0 || q_last - k0 < window);
    return {kt, full ? MASK_NONE : MASK_ELEM};
  }
  __device__ __forceinline__ bool live(int q, int k) const {
    return elem_live(q, k, Sk, causal, window);
  }
};

// Block-sparse: the host's re-tiled lists and the block bitmap.
struct ListSchedule {
  const int* entries;  // [n_q_tiles, width]: kv tile << 2 | MASK_*, ascending
  const int* counts;   // [n_q_tiles]
  const int* bitmap;   // [Sq / block_q, n_kb]: SKIP 0, PARTIAL 1, FULL 2
  int width, n_kb, block_q, block_k;
  int Sq, Sk, causal, window, tile_q;

  __device__ __forceinline__ int count(int qt) const { return counts[qt]; }
  __device__ __forceinline__ KvTile tile(int qt, int i) const {
    const int e = entries[static_cast<long long>(qt) * width + i];
    return {e >> 2, e & 3};
  }
  // the reference's rule: block_live & (block_full | elem)
  __device__ __forceinline__ bool live(int q, int k) const {
    if (q >= Sq || k >= Sk) return false;
    const int st = bitmap[(q / block_q) * n_kb + k / block_k];
    return st == 2 || (st == 1 && elem_live(q, k, Sk, causal, window));
  }
};

// ------------------------------------------------------------ f32 body
// One block owns 64 query rows (half of a 128-row tile, or a 64-row tile)
// of one (batch, head) and walks its tile's schedule in 32-key sub-tiles
// staged in shared memory as f32; 16 row groups x 16 column lanes, 4x2
// score and 4x8 output register tiles.
namespace f32body {
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * (BK + 4));
}
}  // namespace f32body

template <int HD, typename Sched>
__global__ void __launch_bounds__(f32body::THREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, Sched sched) {
  using namespace f32body;
  constexpr int LDQ = HD + 4;  // float4 reads of Q/K rows stay conflict-free
  constexpr int LDV = HD;
  constexpr int LDP = BK + 4;
  constexpr int NJ = BK / 16;  // score columns per thread
  constexpr int NO = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LDQ], pre-scaled (exact in f32 as the plain version)
  float* Ks = Qs + BQ * LDQ;   // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;   // [BK][LDV]
  float* Ps = Vs + BK * LDV;   // [BQ][LDP]

  const int parts = sched.tile_q / BQ;
  const int qt = gridDim.y / parts - 1 - blockIdx.y / parts;  // heaviest tiles first
  const int q0 = qt * sched.tile_q + (blockIdx.y % parts) * BQ;
  if (q0 >= sched.Sq) return;
  const int Sk = sched.Sk;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows 4*rg .. 4*rg+3 of the block
  const int cg = tid % 16;  // columns cg + 16*j

  load_tile<float, HD, LDQ, THREADS>(Qs, qb, qs.s, q0, sched.Sq, BQ, scale);

  float acc[4][NO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  const int n = sched.count(qt);
  for (int it = 0; it < n; ++it) {
    const KvTile t = sched.tile(qt, it);
    const int k_end = min((t.index + 1) * TILE_K, Sk);
    for (int k0 = t.index * TILE_K; k0 < k_end; k0 += BK) {
      __syncthreads();  // previous sub-tile fully consumed (and Q staged)
      load_tile<float, HD, LDQ, THREADS>(Ks, kb, ks.s, k0, Sk, BK, 1.f);
      load_tile<float, HD, LDV, THREADS>(Vs, vb, vs.s, k0, Sk, BK, 1.f);
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
          if (t.mask == MASK_ELEM ? !elem_live(qp, kp, Sk, sched.causal, sched.window)
                                  : t.mask == MASK_BLOCKS && !sched.live(qp, kp))
            s[i][j] = NEG_INF;
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * rg + i;
    if (qp < sched.Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* orow = ob + (long long)qp * os.s;
#pragma unroll
      for (int j = 0; j < NO; ++j) orow[cg + 16 * j] = acc[i][j] / denom;
    }
  }
}

template <int HD, typename Sched>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       const Sched& sched, cudaStream_t stream) {
  constexpr size_t smem = f32body::smem_bytes<HD>();
  auto kern = attn_fwd_f32<HD, Sched>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sched.Sq + sched.tile_q - 1) / sched.tile_q;
  const dim3 grid(B * H, n_qt * (sched.tile_q / f32body::BQ));
  kern<<<grid, f32body::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, qs, ks, vs, os, scale, sched);
  return cudaGetLastError();
}

// ----------------------------------------------------------- bf16 body
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a [B, S, H, hd] tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes); offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads / writes across the
// asynchronous wgmma boundaries
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// eight accumulator registers d[i .. i+7] as read-write asm operands
#define ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], A in registers (bf16 pairs), B N-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88),
        ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (bf16 pairs), B N-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B N-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 256) wgmma_rs_n256(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// S (+)= Q K^T over 16 of the head dim, for a stage of KT keys
template <int KT>
__device__ __forceinline__ void wgmma_qk(float (&s)[KT / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (KT == 128) wgmma_ss_n128(s, da, db, accumulate);
  else wgmma_ss_n64(s, da, db, accumulate);
}

}  // namespace sm90

// Shared-memory plan of the bf16 body: Q [HD/64][BM][64], then STAGES x
// (K [HD/64][KT][64], V [HD/64][KT][64]), each 64-column half a run of
// 128-byte swizzled rows; then the mbarriers.  A stage holds KT keys: the
// whole 128-key tile, or at hd 256 half of it (a 128-key stage would need
// 384 KB with a 128-row Q; a third 64-key stage 256 KB), so the schedule's
// tiles stay 128 keys wide on every head dim.
template <int HD, int NWG>
struct Bf16Plan {
  static constexpr int BM = 64 * NWG;
  static constexpr int KT = HD == 256 ? 64 : TILE_K;  // keys per stage
  static constexpr int SUBS = TILE_K / KT;            // stages per kv tile
  static constexpr int HALVES = HD / 64;
  static constexpr uint32_t Q_BYTES = HALVES * BM * 128;
  static constexpr uint32_t KV_BYTES = HALVES * KT * 128;  // K or V, one stage
  static constexpr uint32_t BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // mbarriers: Q, then per stage K (K and V below hd 256), empty, and V at hd 256
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + (HD == 256 ? 3 : 2) * STAGES) + 1024;
  static constexpr int THREADS = 128 * (NWG + 1);
};

// A CTA owns BM query rows: a whole query tile of the schedule (tile_q ==
// BM), or one of the tile_q / BM parts of it, which all walk the tile's kv
// schedule.
template <int HD, int NWG, typename Sched>
__global__ void __launch_bounds__(Bf16Plan<HD, NWG>::THREADS, 1)
attn_fwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int H,
              Strides os, float scale_log2, Sched sched) {
  using namespace sm90;
  using P = Bf16Plan<HD, NWG>;
  constexpr int BM = P::BM;
  constexpr int KT = P::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar_q = base + P::BAR_OFF;
  auto sK = [&](int st) { return base + P::Q_BYTES + st * 2 * P::KV_BYTES; };
  auto sV = [&](int st) { return sK(st) + P::KV_BYTES; };
  // at hd 256 a stage's K and V land on barriers of their own, so S = Q K^T
  // starts while V is still in flight; hd 64 / 128 keep one barrier and no
  // stage skipping (with both, the hd-128 sliding window ran ~9% slower on
  // the H100: PERF.md)
  constexpr bool SPLIT_KV = HD == 256;
  auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_v = [&](int st) { return SPLIT_KV ? bar_q + 8 * (1 + 2 * STAGES + st) : bar_k(st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + STAGES + st); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // tile_q / BM parts per tile, 1 on every path today; kept general: with q0
  // a known multiple of BM nvcc laid out the hd-128 masks in 14% more
  // instructions and flash at S 512 ran 8% slower on the H100 (PERF.md)
  const int parts = sched.tile_q / BM;
  const int qt = gridDim.y / parts - 1 - blockIdx.y / parts;  // heaviest tiles first
  const int q0 = qt * sched.tile_q + (blockIdx.y % parts) * BM;
  if (q0 >= sched.Sq) return;
  const int n = sched.count(qt) * P::SUBS;  // stages to walk
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k(st), 1);
      if (SPLIT_KV) mbar_init(bar_v(st), 1);
      mbar_init(bar_empty(st), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread issues every TMA load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(bar_q, P::Q_BYTES);
#pragma unroll
      for (int hh = 0; hh < P::HALVES; ++hh)
        tma_load(sQ + hh * BM * 128, &qmap, bar_q, 64 * hh, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        // read before the wait hides it
        const int k0 = sched.tile(qt, i / P::SUBS).index * TILE_K + (i % P::SUBS) * KT;
        if (i >= STAGES) mbar_wait(bar_empty(st), ((i / STAGES) - 1) & 1);
        if constexpr (SPLIT_KV) {
          mbar_expect_tx(bar_k(st), P::KV_BYTES);
#pragma unroll
          for (int hh = 0; hh < P::HALVES; ++hh)
            tma_load(sK(st) + hh * KT * 128, &kmap, bar_k(st), 64 * hh, h, k0, b);
          mbar_expect_tx(bar_v(st), P::KV_BYTES);
#pragma unroll
          for (int hh = 0; hh < P::HALVES; ++hh)
            tma_load(sV(st) + hh * KT * 128, &vmap, bar_v(st), 64 * hh, h, k0, b);
        } else {
          mbar_expect_tx(bar_k(st), 2 * P::KV_BYTES);
#pragma unroll
          for (int hh = 0; hh < P::HALVES; ++hh) {
            tma_load(sK(st) + hh * KT * 128, &kmap, bar_k(st), 64 * hh, h, k0, b);
            tma_load(sV(st) + hh * KT * 128, &vmap, bar_k(st), 64 * hh, h, k0, b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout: thread holds rows r_a = 16*warp + lane/4 and
    // r_a + 8 of its warpgroup's 64, columns 8*j + 2*(lane%4) + {0, 1}
    const int q_a = q0 + 64 * wg + 16 * warp + lane / 4;
    const int q_b = q_a + 8;
    const int col = 2 * (lane % 4);
    const uint32_t q_wg = sQ + wg * 64 * 128;

    float acc[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) acc[r] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

    // the first and last query rows of this warpgroup that exist
    const int q_first = q0 + 64 * wg, q_last = min(q_first + 63, sched.Sq - 1);
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const KvTile t = sched.tile(qt, i / P::SUBS);
      const int k_first = t.index * TILE_K + (i % P::SUBS) * KT, k_last = k_first + KT - 1;
      mbar_wait(bar_k(st), (i / STAGES) & 1);
      // at hd 256 (64-key stages, two per kv tile) a warpgroup skips a stage
      // none of its (row, key) pairs attends, which adds exactly 0: its keys
      // past Sk, or (where the causal / window rule alone decides) above
      // every row's diagonal or before every row's window.  Each row has a
      // live key in a stage it does visit, so skipping changes nothing.
      const bool dead =
          HD == 256 &&
          (q_first > q_last || k_first >= sched.Sk ||
           (t.mask == MASK_ELEM && ((sched.causal && k_first > q_last) ||
                                    (sched.window > 0 && q_first - k_last >= sched.window))));
      if (dead) {
        mbar_wait(bar_v(st), (i / STAGES) & 1);  // a stage is freed once all of it landed
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(st));
        continue;
      }

      // S = Q K^T over the head dim, 16 at a time
      float s[KT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the half
        const uint64_t da = smem_desc(q_wg + (kk / 4) * BM * 128 + off, 16, 1024);
        const uint64_t db = smem_desc(sK(st) + (kk / 4) * KT * 128 + off, 16, 1024);
        wgmma_qk<KT>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // scale in f32 (log2 units), mask where the tile needs it
#pragma unroll
      for (int r = 0; r < KT / 2; ++r) s[r] *= scale_log2;
      const int k_base = t.index * TILE_K + (i % P::SUBS) * KT + col;
      if (t.mask == MASK_ELEM) {
#pragma unroll
        for (int r = 0; r < KT / 2; ++r) {
          const int kp = k_base + 8 * (r / 4) + (r % 2);
          if (!elem_live((r % 4) < 2 ? q_a : q_b, kp, sched.Sk, sched.causal, sched.window))
            s[r] = NEG_INF;
        }
      } else if (t.mask == MASK_BLOCKS) {
#pragma unroll
        for (int r = 0; r < KT / 2; ++r) {
          const int kp = k_base + 8 * (r / 4) + (r % 2);
          if (!sched.live((r % 4) < 2 ? q_a : q_b, kp)) s[r] = NEG_INF;
        }
      }

      // online softmax: rows a (r % 4 < 2) and b, each spread over a quad
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int r = 0; r < KT / 2; r += 4) {
        mx_a = fmaxf(mx_a, fmaxf(s[r], s[r + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[r + 2], s[r + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      uint32_t p[KT / 4];  // P in bf16 pairs: the A operand of the PV product
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int r = 0; r < KT / 2; r += 4) {
        const float e0 = exp2f(s[r] - m_a), e1 = exp2f(s[r + 1] - m_a);
        const float e2 = exp2f(s[r + 2] - m_b), e3 = exp2f(s[r + 3] - m_b);
        rs_a += e0 + e1;
        rs_b += e2 + e3;
        p[r / 2] = pack_bf16(e0, e1);
        p[r / 2 + 1] = pack_bf16(e2, e3);
      }
      l_a = l_a * alpha_a + rs_a;  // per-thread partial sums: the quad adds them at the end
      l_b = l_b * alpha_b + rs_b;
#pragma unroll
      for (int r = 0; r < HD / 2; ++r) acc[r] *= (r % 4) < 2 ? alpha_a : alpha_b;

      // O += P V, 16 keys at a time; V is read N-major (transposed)
      if (SPLIT_KV) mbar_wait(bar_v(st), (i / STAGES) & 1);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint64_t db = smem_desc(sV(st) + kk * 16 * 128, KT * 128, 1024);
        wgmma_pv<HD>(acc, a, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(st));  // this warp is done with the stage
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + col;
      if (q_a < sched.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)q_a * os.s + c) =
            __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (q_b < sched.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)q_b * os.s + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against libcudart only
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map over a bf16 [B, S, H, hd] view (strides in elements, each a
// multiple of 8): boxes of 64 head-dim columns x `rows` positions of one
// (batch, head), 128-byte swizzled, out-of-range rows zero-filled
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, Strides st,
                     int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NWG, typename Sched>
cudaError_t launch_bf16_wg(const void* q, const void* k, const void* v, void* o, int B, int H,
                           Strides qs, Strides ks, Strides vs, Strides os, float scale,
                           const Sched& sched, cudaStream_t stream) {
  using P = Bf16Plan<HD, NWG>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, sched.Sq, H, HD, qs, P::BM) ||
      !make_map(&km, k, B, sched.Sk, H, HD, ks, P::KT) ||
      !make_map(&vm, v, B, sched.Sk, H, HD, vs, P::KT))
    return cudaErrorInvalidValue;
  auto kern = attn_fwd_bf16<HD, NWG, Sched>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qt = (sched.Sq + sched.tile_q - 1) / sched.tile_q;
  const dim3 grid(B * H, n_qt * (sched.tile_q / P::BM));
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), H, os,
                                              scale * LOG2E, sched);
  return cudaGetLastError();
}

template <int HD, typename Sched>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        Strides qs, Strides ks, Strides vs, Strides os, float scale,
                        const Sched& sched, cudaStream_t stream) {
  if (sched.tile_q == 64)
    return launch_bf16_wg<HD, 1>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, stream);
  return launch_bf16_wg<HD, 2>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, stream);
}

// dtype (DT_F32 / DT_BF16) and head dim dispatch of both bodies
template <typename Sched>
cudaError_t launch_attention(int dtype, int hd, const void* q, const void* k, const void* v,
                             void* o, int B, int H, Strides qs, Strides ks, Strides vs,
                             Strides os, float scale, const Sched& sched, cudaStream_t st) {
  if (dtype == DT_F32 && hd == 128)
    return launch_f32<128>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  if (dtype == DT_F32 && hd == 64)
    return launch_f32<64>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  if (dtype == DT_BF16 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  if (dtype == DT_BF16 && hd == 64)
    return launch_bf16<64>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  if (dtype == DT_F32 && hd == 256)
    return launch_f32<256>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  if (dtype == DT_BF16 && hd == 256)
    return launch_bf16<256>(q, k, v, o, B, H, qs, ks, vs, os, scale, sched, st);
  return cudaErrorInvalidValue;
}

}  // namespace repro
