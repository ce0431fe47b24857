// flash_attn_fwd: causal / windowed / non-causal attention, the shared
// mainloop of attn_mainloop.cuh over a RangeSchedule.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas and
// repro/kernels/sliding_window.py::sliding_window_attention_pallas.  On the
// TPU the sliding-window kernel exists because the flash kernel kept the
// whole key sequence resident in VMEM; here a query tile visits only its
// live kv tiles, [first_live, last_live] from causal and window, so one
// kernel serves both wrappers (kernels/flash_attention.py and
// kernels/sliding_window.py, each with its own launch counter): the band of
// a sliding window costs O(window), not O(S).  What bounds it and what the
// design does about it: see attn_mainloop.cuh.
#include "attn_mainloop.cuh"

// q, k, v, o: [B, S, H, hd] addressed by (batch, seq, head) strides in
// elements; the head dim is contiguous and rows are 16-byte aligned.
// dtype: 0 = f32 (CUDA cores), 1 = bf16 (tensor cores, TMA).  window <= 0
// means no window.
extern "C" int repro_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int H, int Sq, int Sk, int hd,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long o_sb, long long o_ss, long long o_sh, float scale,
                                    int causal, int window, void* stream) {
  using namespace repro;
  const RangeSchedule sched{Sq, Sk, causal, window, tile_q_for(Sq)};
  return static_cast<int>(launch_attention(
      dtype, hd, q, k, v, o, B, H, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, scale, sched,
      static_cast<cudaStream_t>(stream)));
}
