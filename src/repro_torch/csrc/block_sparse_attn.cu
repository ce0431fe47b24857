// block_sparse_attn_fwd: attention over a SKIP / PARTIAL / FULL block
// bitmap, the shared mainloop of attn_mainloop.cuh over a ListSchedule.
//
// Replaces repro/kernels/block_sparse.py::block_sparse_attention_pallas
// (_block_sparse_kernel).
//
// The host (kernels/block_sparse.py::BlockSparsePattern.kernel_tiles)
// re-tiles the pattern to the kernel's (tile_q x 128) tiles: for each query
// tile, the ascending kv tiles holding a live pair of any of its q blocks,
// each flagged FULL (every pair live: no mask), ELEM (the causal / window
// rule alone decides, as for flash) or BLOCKS (an element is live by the
// reference's rule, block_live & (block_full | causal/window), read from the
// block bitmap uploaded beside the lists).  A
// tile with only SKIP blocks is never scheduled, so never loaded: the work
// is O(density * S^2), as on the TPU.  Re-tiling lets one 128-row CTA serve
// any block size (8 to 128, block_q != block_k, sizes that do not divide
// the tile) with wgmma's 64-row M.  What bounds it and what the design does
// about it: see attn_mainloop.cuh.
#include "attn_mainloop.cuh"

// q, o: [B, Sq, H, hd]; k, v: [B, Sk, H, hd], addressed by (batch, seq, head)
// strides in elements (head dim contiguous, rows 16-byte aligned).
// kv_index: [ceil(Sq / tile_q), width] int32 kernel tile entries (kv tile
// << 2 | MASK_*), tile_q = 64 if Sq <= 64 else 128 (tile_q_for); count:
// entries per query tile; kv_state: the pattern's [Sq / block_q,
// ceil(Sk / block_k)] int32 block bitmap.  Sq % block_q == 0, block_q % 8
// == 0.  dtype: 0 = f32, 1 = bf16.  window <= 0 means no window.
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
  const ListSchedule sched{static_cast<const int*>(kv_index), static_cast<const int*>(count),
                           static_cast<const int*>(kv_state), width, (Sk + block_k - 1) / block_k,
                           block_q, block_k, Sq, Sk, causal, window, tile_q_for(Sq)};
  return static_cast<int>(launch_attention(
      dtype, hd, q, k, v, o, B, H, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, scale, sched,
      static_cast<cudaStream_t>(stream)));
}
