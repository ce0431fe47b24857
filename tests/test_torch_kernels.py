"""repro_torch attention kernels: plain versions against the JAX oracles on
the CPU (the CUDA kernels against their plain versions: test_torch_cuda.py).

Oracles: ``repro.kernels.ref`` (flash, decode, int8 KV quantization) and the
sliding-window Pallas kernel in interpret mode.  The reference flash and
decode Pallas kernels cannot run on this JAX (no ``pallas.load``), so their
pure-jnp oracles stand in.  Tolerances: f32 ``atol 2e-5, rtol 1e-4`` (the
same math in another summation order); int8 values exactly, scales to 1e-7
relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.ref import decode_attention_ref, flash_attention_ref, quantize_kv_ref
from repro.kernels.sliding_window import sliding_window_attention_pallas
from repro_torch.kernels import decode as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.kernels import sliding_window as ksw
from repro_torch.kernels.ref import quantize_kv_ref as quantize_kv_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32 = dict(atol=2e-5, rtol=1e-4)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _fold(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _unfold(x, B, H):
    BH, S, hd = x.shape
    return x.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("S,window", [(64, None), (64, 16), (50, None), (50, 7), (37, 100)])
def test_flash_plain_matches_jax_ref(S, window):
    rng = np.random.default_rng(S + (window or 0))
    B, H, hd = 2, 3, 32
    q, k, v = (_randn(rng, B, S, H, hd) for _ in range(3))
    ref = _unfold(np.asarray(flash_attention_ref(
        jnp.asarray(_fold(q)), jnp.asarray(_fold(k)), jnp.asarray(_fold(v)),
        causal=True, window=window)), B, H)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def test_flash_ragged_equals_padded():
    """A ragged S through the ops wrapper equals the reference wrapper's
    pad-to-block / unpad result (padded keys are causally masked)."""
    rng = np.random.default_rng(3)
    B, S, H, hd, pad = 1, 45, 2, 16, 19
    q, k, v = (_randn(rng, B, S, H, hd) for _ in range(3))
    padded = [np.concatenate([x, np.zeros((B, pad, H, hd), np.float32)], 1) for x in (q, k, v)]
    ref = _unfold(np.asarray(flash_attention_ref(*(jnp.asarray(_fold(x)) for x in padded),
                                                 causal=True)), B, H)[:, :S]
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


@pytest.mark.parametrize("S,window", [(64, 16), (64, 40), (128, 100)])
def test_sliding_window_plain_matches_pallas_interpret(S, window):
    rng = np.random.default_rng(window)
    B, H, hd = 1, 2, 32
    q, k, v = (_randn(rng, B, S, H, hd) for _ in range(3))
    ref = _unfold(np.asarray(sliding_window_attention_pallas(
        *(jnp.asarray(_fold(x)) for x in (q, k, v)), window=window, block_q=16, block_k=16,
        interpret=True)), B, H)
    out = ops.sliding_window_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


@pytest.mark.parametrize("S,window", [(64, 24), (96, 40)])
def test_sliding_window_plain_hd256_matches_pallas_interpret(S, window):
    """recurrentgemma-2b's head dim (256), 10 heads."""
    rng = np.random.default_rng(S + window)
    B, H, hd = 1, 10, 256
    q, k, v = (_randn(rng, B, S, H, hd) for _ in range(3))
    ref = _unfold(np.asarray(sliding_window_attention_pallas(
        *(jnp.asarray(_fold(x)) for x in (q, k, v)), window=window, block_q=16, block_k=16,
        interpret=True)), B, H)
    out = ops.sliding_window_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def _decode_inputs(rng, B=3, L=40, KV=2, G=2, hd=32):
    q = _randn(rng, B, KV, G, hd)
    k = _randn(rng, B, L, KV, hd)
    v = _randn(rng, B, L, KV, hd)
    # a linear cache, a wrapped ring buffer, and a single live slot
    pos = np.array([17, 95, 0])
    slot = pos % L
    age = (slot[:, None] - np.arange(L)[None]) % L
    valid = age < np.minimum(pos + 1, L)[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_plain_matches_jax_ref(quantized):
    rng = np.random.default_rng(11 + quantized)
    q, k, v, valid = _decode_inputs(rng)
    kw_j, kw_t = {}, {}
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv_ref(jnp.asarray(k)), quantize_kv_ref(jnp.asarray(v))
        k, v = np.array(kq), np.array(vq)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    ref = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(valid), **kw_j))
    out = kd.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(valid), **kw_t)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G,hd,L", [(48, 128, 70), (10, 256, 40)])
def test_decode_plain_zoo_groups_match_jax_ref(G, hd, L, quantized):
    """granite-20b's 48 query heads on one kv head, recurrentgemma-2b's 10 at
    hd 256, over a linear cache, a wrapped ring and a single live slot."""
    rng = np.random.default_rng(G + hd + quantized)
    q, k, v, valid = _decode_inputs(rng, L=L, KV=1, G=G, hd=hd)
    kw_j, kw_t = {}, {}
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv_ref(jnp.asarray(k)), quantize_kv_ref(jnp.asarray(v))
        k, v = np.array(kq), np.array(vq)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    ref = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(valid), **kw_j))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(valid))
    np.testing.assert_allclose(kd.decode_attention(*args, **kw_t).numpy(), ref, **F32)
    # the kernel's split plan, written out on the host, agrees too
    np.testing.assert_allclose(kd.decode_attention_split(*args, **kw_t).numpy(), ref, **F32)


def test_decode_ops_wrapper_kv_major_heads():
    """[B, 1, H, hd] queries regroup kv-major: head j*G+g reads kv head j."""
    rng = np.random.default_rng(5)
    q, k, v, valid = _decode_inputs(rng)
    B, KV, G, hd = q.shape
    out = ops.decode_attention_kernel(torch.from_numpy(q.reshape(B, 1, KV * G, hd)),
                                      torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(valid))
    ref = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(valid)))
    np.testing.assert_allclose(out.numpy().reshape(B, KV, G, hd), ref, **F32)


@pytest.mark.parametrize("shape", [(4, 9, 2, 32), (2, 3, 1, 8)])
def test_quantize_kv_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = _randn(rng, *shape) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row keeps scale 0
    # exact halves exercise round-half-to-even
    x[-1, -1, -1, :4] = np.array([0.5, 1.5, 2.5, -127.0], np.float32)
    qj, sj = quantize_kv_ref(jnp.asarray(x))
    qt, st = quantize_kv_torch(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7, atol=0)


def test_wrappers_take_plain_version_only_on_cpu():
    """A tensor on neither the CPU nor CUDA reaches the kernel path, which
    refuses it: there is no silent fallback to the plain version."""
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ksw.sliding_window_attention(q, q, q, window=4)
    qd = torch.zeros(1, 2, 1, 64, device="meta")
    kc = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kd.decode_attention(qd, kc, kc, torch.ones(1, 8, dtype=torch.bool, device="meta"))


def test_decode_wide_body_entry_takes_cuda_tensors_only():
    """The entry that forces the decode kernel's wide body (for timing it
    against the split body) has no plain version: CPU tensors are refused."""
    q = torch.zeros(1, 2, 2, 64)
    kc = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kd.decode_attention_wide_body(q, kc, kc, torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="come together"):
        kd.decode_attention_wide_body(q, kc, kc, torch.ones(1, 8, dtype=torch.bool),
                                      k_scale=torch.ones(1, 8, 2))
