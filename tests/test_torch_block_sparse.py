"""repro_torch block-sparse attention against the JAX package, on the CPU:
``BlockSparsePattern`` (bitmaps, compacted lists, density, ``from_bitmap``'s
checks) for the causal, windowed and strided layouts; the plain attention
against ``repro.kernels.ref.block_sparse_attention_ref``; the reduced model
and ``ServeEngine`` with ``attn_kernel="block_sparse"`` against the JAX model
and engine with the knob off (the CUDA kernel against its plain version:
test_torch_cuda.py).

The reference's Pallas kernel needs ``pallas.load``, which ``jax 0.9.0``
lacks, so it raises even in interpret mode: the port is held against the
reference's oracle, which the Pallas kernel's own tests hold it to.

Tolerances: patterns equal exactly (integer arrays).  Attention: f32 within
1e-5 (same materialized softmax, other summation order); bf16 within one bf16
step (both compute in f32 and round once).  Model logits: 1e-4, as the
knob-off model tests (the block-sparse knob computes every live pair, so it
is the plain attention up to summation order); engine tokens and tick stamps
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import block_sparse as jbs
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import block_sparse as kbs
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServeEngine

LOGITS = dict(atol=1e-4, rtol=1e-4)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=(4,))

# (layout, constructor keyword arguments)
PATTERNS = [
    ("causal", dict(seq_q=64, seq_k=64, block_q=16, block_k=16)),
    ("causal", dict(seq_q=96, seq_k=96, block_q=32, block_k=8)),
    ("windowed", dict(seq_q=96, seq_k=96, window=40, block_q=16, block_k=16)),
    ("windowed", dict(seq_q=128, seq_k=128, window=33, block_q=8, block_k=32)),
    ("strided", dict(seq_q=128, seq_k=128, local_blocks=2, stride=3, block_q=16, block_k=16)),
    ("strided", dict(seq_q=64, seq_k=64, local_blocks=1, stride=2, block_q=8, block_k=8)),
]
_CTOR = {"causal": "causal_pattern", "windowed": "windowed", "strided": "strided"}


def _patterns(layout, kw):
    return (getattr(jbs.BlockSparsePattern, _CTOR[layout])(**kw),
            getattr(kbs.BlockSparsePattern, _CTOR[layout])(**kw))


def _ids(cases):
    return [f"{layout}-" + "-".join(f"{k}{v}" for k, v in kw.items()) for layout, kw in cases]


@pytest.mark.parametrize("layout,kw", PATTERNS, ids=_ids(PATTERNS))
def test_patterns_match_reference(layout, kw):
    jp, tp = _patterns(layout, kw)
    np.testing.assert_array_equal(tp.bitmap, jp.bitmap)
    assert (tp.seq_q, tp.seq_k, tp.block_q, tp.block_k, tp.causal, tp.window) == (
        jp.seq_q, jp.seq_k, jp.block_q, jp.block_k, jp.causal, jp.window)
    assert tp.density() == jp.density()
    for a, b in zip(tp.compact(), jp.compact()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a bitmap the reference accepts round-trips through from_bitmap
    again = kbs.BlockSparsePattern.from_bitmap(tp.bitmap, block_q=tp.block_q, block_k=tp.block_k,
                                               causal=tp.causal, window=tp.window)
    np.testing.assert_array_equal(again.bitmap, tp.bitmap)


@pytest.mark.parametrize("bitmap,match", [
    ([[1, 1], [1, 1]], "fully excludes"),   # block (0, 1) lies above the diagonal
    ([[1, 0], [1, 0]], "diagonal block"),   # q block 1 drops its diagonal
], ids=["live_above_the_mask", "dead_diagonal"])
def test_from_bitmap_errors_match_reference(bitmap, match):
    for cls in (jbs.BlockSparsePattern, kbs.BlockSparsePattern):
        with pytest.raises(ValueError, match=match):
            cls.from_bitmap(np.array(bitmap), block_q=8, block_k=8)


def _qkv(BH, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BH, S, hd)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,kw", PATTERNS, ids=_ids(PATTERNS))
def test_plain_attention_matches_reference_oracle(layout, kw, dtype):
    jp, tp = _patterns(layout, kw)
    q, k, v = _qkv(3, kw["seq_q"], 32, kw["seq_q"] + kw["block_q"])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jref.block_sparse_attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)), jp)
    got = ops.block_sparse_attention(
        *(torch.from_numpy(a).to(tdt).reshape(1, 3, -1, 32).permute(0, 2, 1, 3) for a in (q, k, v)),
        tp)
    got = got.permute(0, 2, 1, 3).reshape(3, -1, 32).float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:  # one bf16 rounding step of the larger value
        step = 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= step + 1e-6).all()


def test_plain_attention_skips_the_skipped_blocks():
    """A strided pattern differs from causal attention exactly where it skips."""
    _, tp = _patterns("strided", dict(seq_q=64, seq_k=64, local_blocks=1, stride=4,
                                     block_q=16, block_k=16))
    causal = kbs.BlockSparsePattern.causal_pattern(64, 64, 16, 16)
    q, k, v = (torch.from_numpy(a).reshape(1, 64, 1, 32) for a in _qkv(1, 64, 32, 0))
    a, b = ops.block_sparse_attention(q, k, v, tp), ops.block_sparse_attention(q, k, v, causal)
    rows_same = (tp.bitmap == causal.bitmap).all(1).repeat(16)
    assert torch.equal(a[0, rows_same], b[0, rows_same])
    assert not torch.allclose(a[0, ~rows_same], b[0, ~rows_same])


def test_wrapper_checks_the_pattern_length():
    q = torch.zeros(1, 32, 2, 16)
    with pytest.raises(ValueError, match="pattern"):
        ops.block_sparse_attention(q, q, q, kbs.BlockSparsePattern.causal_pattern(64, 64, 16, 16))


def _cfgs(**kw):
    j = dataclasses.replace(jax_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    t = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    return j, t


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("S,cache_len", [(16, 24), (24, 40), (12, 24), (9, 16)],
                         ids=["block16", "windowed_block8", "no_block_divides", "odd"])
def test_block_sparse_knob_matches_jax_plain_model(weights, S, cache_len):
    """Prefill through the block-sparse path (S % 8 == 0) or the plain path
    (no block of 128/64/32/16/8 divides S), then greedy decode; cache_len 40
    exceeds the reduced window (16), so that prefill runs windowed."""
    jp, tp = weights
    jcfg, _ = _cfgs()
    _, tcfg = _cfgs(attn_kernel="block_sparse")
    toks = np.random.default_rng(S).integers(0, 512, (2, S)).astype(np.int32)
    TL._sparse_pattern.cache_clear()
    jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_len)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    # one pattern per shape, built only where a block divides S
    assert TL._sparse_pattern.cache_info().currsize == (1 if S % 8 == 0 else 0)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for i in range(4):
        jl, jc = J_DECODE(jp, jnp.asarray(tok), jc, S + i, jcfg)
        tl, tc = TT.decode_step(tp, torch.from_numpy(tok), tc, S + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


def test_engine_with_block_sparse_matches_the_plain_engines(weights):
    """Tokens and tick stamps equal to the JAX engine's and the port's own
    plain engine's; prompts bucket to multiples of 8, so every prefill runs
    through the block-sparse path."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(long_context_window=None)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 9, 13, 7, 5, 17)]
    kw = dict(max_slots=3, cache_len=48, prompt_bucket=8)
    runs = {}
    jreqs = [JRequest(prompt=list(p), max_new_tokens=4) for p in prompts]
    JEngine(jcfg, jp, **kw).run(jreqs)
    for knob in (None, "block_sparse"):
        reqs = [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
        ServeEngine(dataclasses.replace(tcfg, attn_kernel=knob), tp, device="cpu", **kw).run(reqs)
        runs[knob] = reqs
    for j, a, b in zip(jreqs, runs[None], runs["block_sparse"]):
        assert b.done and b.output == a.output == j.output
        assert (b.admit_tick, b.finish_tick) == (a.admit_tick, a.finish_tick) == (
            j.admit_tick, j.finish_tick)
