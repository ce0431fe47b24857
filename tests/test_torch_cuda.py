"""repro_torch on the card: each CUDA kernel against its plain version, the
reduced model and engine with the kernels against the plain path, the
gossip kernels (quantize, dequantize, fused encode, fused mix, block top-k)
against their plain versions bit for bit, alone and inside a trainer round,
and the serving fleet on the kernels (its --no-fastpath twin, a hot
reload, the classifier engine).

Every test here needs a CUDA card and skips without one.  The file imports
no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 with TF32 off ``atol 2e-5, rtol 1e-4`` for kernels (same
math, other summation order), ``atol 2e-4, rtol 1e-3`` for model logits (as
the reference's kernel-flag test); bf16 ``atol 1e-4, rtol 1e-2`` (both sides
reduce in f32 and round once to bf16: at most one rounding step, 2**-7 of
the value, apart), plus, for the flash, sliding-window and block-sparse
kernels, ``2**-8 * plain(|v|)``: those round P to bf16 once before the PV
product on the tensor cores (``ref.p_rounding_bound``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import gossip
from repro_torch.core.topology import ring
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse as kbs
from repro_torch.kernels import choco_fused as kc
from repro_torch.kernels import quantize as kq
from repro_torch.kernels import ops
from repro_torch.kernels import topk as ktopk
from repro_torch.kernels.ops import KernelBlockTopK, KernelQuantization
from repro_torch.kernels import decode as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import sliding_window as ksw
from repro_torch.kernels.ref import (encode_scale, f32_full, p_rounding_bound, quantize_kv_ref,
                                     tau_for)
from repro_torch.checkpoint import save, step_path
from repro_torch.launch import serve, train, train_serve
from repro_torch.models import transformer as T
from repro_torch.serving import (BatchedProbe, ClassifierEngine, EvalRequest, FleetNode,
                                 HotReloader, Request, ServeEngine)

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=1e-4, rtol=1e-2)
LOGITS = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine, see the module docstring)")
    from repro_torch import resolve_device

    return resolve_device("cuda")  # also pins TF32 off for the f32 references


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def _assert_attention_close(out, ref, attend, v):
    """A flash / sliding-window / block-sparse kernel's output against its
    plain version: F32 for f32; for bf16, BF16 plus the bound on rounding P
    to bf16 (``attend``: the plain version with q, k bound, taking v)."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, **F32)
        return
    out, ref = out.float(), ref.float()
    limit = BF16["atol"] + BF16["rtol"] * ref.abs() + p_rounding_bound(attend, v)
    err = (out - ref).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= limit).all()), (
        f"{int((err > limit).sum())} elements out of bound; max err / limit "
        f"{float((err / limit).max()):.3f}, max err {float(err.max()):.3e}")


@pytest.mark.parametrize("dtype,S,window,hd", [
    (torch.float32, 200, None, 128), (torch.bfloat16, 512, None, 128),
    (torch.bfloat16, 300, 100, 128), (torch.float32, 77, 13, 64),
    (torch.bfloat16, 77, 13, 64), (torch.bfloat16, 40, None, 128), (torch.bfloat16, 1, None, 64),
    (torch.bfloat16, 300, 100, 256), (torch.float32, 200, None, 256), (torch.bfloat16, 40, None, 256),
    (torch.bfloat16, 129, None, 256),
])
def test_flash_kernel_matches_plain(cuda, dtype, S, window, hd):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (_randn(g, 2, S, 4, hd, dtype=dtype, device=cuda) for _ in range(3))
    before = kf.launches.count
    out = kf.flash_attention(q, k, v, causal=True, window=window)
    assert kf.launches.count == before + 1
    ref = kf.flash_attention_plain(q, k, v, causal=True, window=window)
    _assert_attention_close(
        out, ref, lambda v_: kf.flash_attention_plain(q, k, v_, causal=True, window=window), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(96, 96), (40, 100), (200, 300)])
def test_flash_kernel_non_causal(cuda, Sq, Sk, dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q = _randn(g, 2, Sq, 4, 64, dtype=dtype, device=cuda)
    k, v = (_randn(g, 2, Sk, 4, 64, dtype=dtype, device=cuda) for _ in range(2))
    out = kf.flash_attention(q, k, v, causal=False)
    _assert_attention_close(out, kf.flash_attention_plain(q, k, v, causal=False),
                            lambda v_: kf.flash_attention_plain(q, k, v_, causal=False), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q/k/v as head slices of one fused [B, S, 3H, hd] tensor (non-contiguous
    rows; bf16: TMA maps over the strided view) give the same result as
    contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = _randn(g, 2, 150, 12, 64, dtype=dtype, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    out = kf.flash_attention(q, k, v, causal=True)
    ref = kf.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(640, 256), (333, 50), (1100, 300)])
def test_sliding_window_kernel_matches_plain(cuda, S, window, dtype):
    """The band: its two edges masked, interior kv tiles not, a ragged tail;
    bf16 runs the tensor-core body."""
    g = torch.Generator(device=cuda).manual_seed(window)
    q, k, v = (_randn(g, 1, S, 4, 128, dtype=dtype, device=cuda) for _ in range(3))
    before = ksw.launches.count
    out = ksw.sliding_window_attention(q, k, v, window=window)
    assert ksw.launches.count == before + 1
    _assert_attention_close(
        out, ksw.sliding_window_attention_plain(q, k, v, window=window),
        lambda v_: ksw.sliding_window_attention_plain(q, k, v_, window=window), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(640, 256), (1100, 300)])
def test_sliding_window_kernel_hd256(cuda, S, window, dtype):
    """recurrentgemma-2b's head dim: each 128-key tile as two 64-key stages
    (bf16), the f32 body at hd 256."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (_randn(g, 1, S, 2, 256, dtype=dtype, device=cuda) for _ in range(3))
    out = ksw.sliding_window_attention(q, k, v, window=window)
    _assert_attention_close(
        out, ksw.sliding_window_attention_plain(q, k, v, window=window),
        lambda v_: ksw.sliding_window_attention_plain(q, k, v_, window=window), v)


def _decode_inputs(device, B=3, L=200, KV=2, G=4, hd=128):
    rng = np.random.default_rng(L)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
               for s in ((B, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd)))
    pos = torch.tensor([17, 3 * L + 5, 0], device=device)  # linear, wrapped ring, one slot
    slot = torch.remainder(pos, L)
    age = torch.remainder(slot[:, None] - torch.arange(L, device=device)[None], L)
    return q, k, v, age < torch.clamp(pos + 1, max=L)[:, None]


@pytest.mark.parametrize("quantized,hd", [(False, 128), (True, 128), (False, 64), (True, 64)])
def test_decode_kernel_matches_plain(cuda, quantized, hd):
    q, k, v, valid = _decode_inputs(cuda, hd=hd)
    kw = {}
    if quantized:
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    counter = kd.launches_int8 if quantized else kd.launches
    before = counter.count
    out = kd.decode_attention(q, k, v, valid, **kw)
    assert counter.count == before + 1
    torch.testing.assert_close(out, kd.decode_attention_plain(q, k, v, valid, **kw), **F32)


def _decode_case(case, dtype, device):
    """(q, k, v, valid, kwargs) of one split-decode edge case: an all-masked
    row, L below one 64-row tile, L not a multiple of it, G = 1 and G = 8."""
    B, L, KV, G, hd = {"all_masked": (3, 200, 2, 2, 128), "L37": (3, 37, 2, 2, 64),
                       "L1000": (3, 1000, 8, 2, 128), "G1": (3, 300, 4, 1, 128),
                       "G8": (3, 500, 2, 8, 64)}[case]
    q, k, v, valid = _decode_inputs(device, B=B, L=L, KV=KV, G=G, hd=hd)
    if case == "all_masked":
        valid[1] = False
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    elif dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    return q, k, v, valid, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["all_masked", "L37", "L1000", "G1", "G8"])
def test_decode_split_kernel_edge_cases(cuda, case, dtype):
    q, k, v, valid, kw = _decode_case(case, dtype, cuda)
    counter = kd.launches_int8 if kw else kd.launches
    before = counter.count
    out = kd.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1  # one count per call: split and combine together
    ref = kd.decode_attention_plain(q, k, v, valid, **kw)
    tol = BF16 if dtype == "bfloat16" else F32
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    if case == "all_masked":  # the uniform mean of V over all L
        vf = v.float() * (kw["v_scale"][..., None] if kw else 1.0)
        mean = vf[1].mean(0)[:, None, :].expand_as(out[1])
        torch.testing.assert_close(out[1].float(), mean.to(out.dtype).float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,L,KV,G,hd", [(3, 1000, 1, 48, 128), (3, 2047, 1, 10, 256),
                                         (3, 300, 2, 64, 256), (3, 37, 2, 9, 64),
                                         (3, 130, 4, 1, 256), (3, 200, 1, 16, 128)])
def test_decode_wide_kernel_matches_plain(cuda, B, L, KV, G, hd, dtype):
    """Groups past 2 and hd 256 (the wide body): granite-20b's G 48,
    recurrentgemma-2b's G 10 at hd 256 over a 2047-row ring, the G 64 and
    G 1 corners, a row with no live position."""
    q, k, v, valid = _decode_inputs(cuda, B=B, L=L, KV=KV, G=G, hd=hd)
    valid[-1] = False
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    elif dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    counter = kd.launches_int8 if kw else kd.launches
    before = counter.count
    out = kd.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    tol = BF16 if dtype == "bfloat16" else F32
    torch.testing.assert_close(out.float(), kd.decode_attention_plain(q, k, v, valid, **kw).float(),
                               **tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("L", [37, 300])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [3, 4, 8, 9, 10, 16, 17, 33, 48, 64])
def test_decode_tensor_core_body_matches_plain(cuda, G, hd, L, dtype):
    """The tensor-core body (bf16 queries, bf16 or int8 K/V) at every 16-row
    padding of the group, each head dim, L under one tile and a 300-row
    cache: a linear row, a wrapped ring and an all-masked row, within the
    decode bound (no slack: P keeps about 16 bits)."""
    q, k, v, valid = _decode_inputs(cuda, B=3, L=L, KV=1 if G > 16 else 2, G=G, hd=hd)
    valid[2] = False
    q = q.to(torch.bfloat16)
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    counter = kd.launches_int8 if kw else kd.launches
    before = counter.count
    out = kd.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    torch.testing.assert_close(out.float(), kd.decode_attention_plain(q, k, v, valid, **kw).float(),
                               **BF16)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("L,G,hd", [(4100, 10, 256), (200_000, 48, 128)])
def test_decode_tensor_core_body_long_caches(cuda, L, G, hd, dtype):
    """Caches past 32 tiles: the partials combine through device memory
    (more than 8 chunks a row), and at L 200000 a chunk's 75 tiles cross the
    kernel's 64-tile window of live-row masks."""
    q, k, v, valid = _decode_inputs(cuda, L=L, KV=1, G=G, hd=hd)
    valid[1, 3000:150_000] = False  # whole dead windows of tiles in a wrapped ring
    q = q.to(torch.bfloat16)
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    assert kd.split_plan(3, 1, L, G)[1] > kd.CLUSTER
    out = kd.decode_attention(q, k, v, valid, **kw)
    torch.testing.assert_close(out.float(), kd.decode_attention_plain(q, k, v, valid, **kw).float(),
                               **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,L,KV,G,hd", [(3, 1000, 8, 2, 128), (4, 272, 8, 4, 128),
                                         (2, 272, 8, 8, 128), (3, 1000, 1, 48, 128),
                                         (3, 2047, 1, 10, 256), (2, 500, 1, 64, 256)])
def test_decode_kernel_repeats_exactly_across_interleaved_inputs(cuda, B, L, KV, G, hd, dtype):
    """The combine reads the partials that its own call's blocks wrote: two
    inputs of one shape alternate (so the scratch holds the other input's
    partials when a call starts), and every result equals that input's first
    bit for bit; the first ones agree with the plain version."""
    runs = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
                   for s in ((B, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd)))
        valid = torch.from_numpy(rng.random((B, L)) < 0.9).to(cuda)
        kw = {}
        if dtype == "int8":
            (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
            kw = dict(k_scale=ks, v_scale=vs)
        elif dtype == "bfloat16":
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        first = kd.decode_attention(q, k, v, valid, **kw)
        tol = BF16 if dtype == "bfloat16" else F32
        torch.testing.assert_close(first.float(),
                                   kd.decode_attention_plain(q, k, v, valid, **kw).float(), **tol)
        runs.append(((q, k, v, valid), kw, first))
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(300):
        for args, kw, first in runs:
            differ += (kd.decode_attention(*args, **kw) != first).sum()
    assert int(differ) == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_wide_body_matches_plain_where_the_split_body_runs(cuda, hd, dtype):
    """The wide body forced at G 2 (timed against the split body in
    chip_smoke.py's phase 2) gives the plain version's answer there too."""
    q, k, v, valid = _decode_inputs(cuda, B=3, L=1024, KV=8, G=2, hd=hd)
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = kd.decode_attention_wide_body(q, k, v, valid, **kw)
    tol = BF16 if dtype == "bfloat16" else F32
    torch.testing.assert_close(out.float(), kd.decode_attention_plain(q, k, v, valid, **kw).float(),
                               **tol)


def test_decode_split_kernel_matches_its_cpu_twin(cuda):
    """The f32 kernel against its plan run on the CPU in float64.  The
    twin's own f32 einsums were the unsteady side: in 1 of 30 processes on
    the card's host its first call came out up to 7.5e-5 off (41 of 6144
    elements past the bound) while the kernel's output was the same bit for
    bit in every run and within 2e-7 of the float64 twin."""
    q, k, v, valid, _ = _decode_case("L1000", "float32", cuda)
    valid[0, 100:700] = False  # whole dead tiles in a live row
    out = kd.decode_attention(q, k, v, valid)
    twin = kd.decode_attention_split(*(t.cpu().double() for t in (q, k, v)), valid.cpu())
    assert twin.dtype == torch.float64
    torch.testing.assert_close(out.cpu(), twin.float(), **F32)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kf.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        kf.flash_attention(q.half(), q.half(), q.half())
    qd = torch.zeros(1, 2, 1, 64, device=cuda)
    kc = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kd.decode_attention(qd, kc.transpose(1, 2).contiguous().transpose(1, 2), kc,
                            torch.ones(1, 8, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 200, 257])
def test_flash_kernel_hd256_two_warpgroups(cuda, S, window):
    """hd 256 bf16: a CTA owns a 128-row query tile as two 64-row consumer
    warpgroups reading one K/V stage (64 rows, one warpgroup, at S <= 64):
    the tile's two halves, ragged tails, causal and windowed."""
    g = torch.Generator(device=cuda).manual_seed(S + (window or 0))
    q, k, v = (_randn(g, 2, S, 3, 256, dtype=torch.bfloat16, device=cuda) for _ in range(3))
    before = kf.launches.count
    out = kf.flash_attention(q, k, v, causal=True, window=window)
    assert kf.launches.count == before + 1
    _assert_attention_close(
        out, kf.flash_attention_plain(q, k, v, causal=True, window=window),
        lambda v_: kf.flash_attention_plain(q, k, v_, causal=True, window=window), v)


def _pattern(layout, S, block, block_k=None):
    bk = block_k or block
    if layout == "causal":
        return kbs.BlockSparsePattern.causal_pattern(S, S, block, bk)
    if layout == "windowed":
        return kbs.BlockSparsePattern.windowed(S, S, 3 * block // 2 + 5, block, bk)
    return kbs.BlockSparsePattern.strided(S, S, local_blocks=2, stride=3, block_q=block,
                                          block_k=bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 64, 16])
@pytest.mark.parametrize("layout", ["causal", "windowed", "strided"])
def test_block_sparse_kernel_matches_plain(cuda, layout, block, dtype):
    S = 8 * block if block < 128 else 512
    g = torch.Generator(device=cuda).manual_seed(block)
    q, k, v = (_randn(g, 2, S, 4, 128, dtype=dtype, device=cuda) for _ in range(3))
    pattern = _pattern(layout, S, block)
    before = kbs.launches.count
    out = kbs.block_sparse_attention(q, k, v, pattern)
    assert kbs.launches.count == before + 1
    ref = kbs.block_sparse_attention_plain(q, k, v, pattern)
    _assert_attention_close(
        out, ref, lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_q,block_k,hd", [(8, 8, 64), (32, 8, 128), (8, 32, 64),
                                                (128, 32, 128), (24, 40, 64), (64, 64, 256),
                                                (24, 40, 256)])
def test_block_sparse_kernel_uneven_blocks(cuda, block_q, block_k, hd, dtype):
    """block_q != block_k, blocks of 8, a head dim of 64, and blocks that are
    no power of two (24 rows, 40 keys: blocks straddling the kernel's 128-row
    and 128-key tiles)."""
    S = 240 if block_q == 24 else 256
    g = torch.Generator(device=cuda).manual_seed(block_q + block_k)
    q, k, v = (_randn(g, 1, S, 3, hd, dtype=dtype, device=cuda) for _ in range(3))
    for layout in ("causal", "windowed", "strided"):
        pattern = _pattern(layout, S, block_q, block_k)
        _assert_attention_close(
            kbs.block_sparse_attention(q, k, v, pattern),
            kbs.block_sparse_attention_plain(q, k, v, pattern),
            lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)


@pytest.mark.parametrize("layout,S,block", [("strided", 512, 64), ("windowed", 512, 128),
                                            ("strided", 320, 32), ("windowed", 208, 16)])
def test_block_sparse_kernel_hd256_two_warpgroups(cuda, layout, S, block):
    """Block-sparse attention at hd 256 on the two-warpgroup bf16 body:
    strided and windowed patterns, lengths that end mid-tile."""
    g = torch.Generator(device=cuda).manual_seed(S + block)
    q, k, v = (_randn(g, 2, S, 2, 256, dtype=torch.bfloat16, device=cuda) for _ in range(3))
    pattern = _pattern(layout, S, block)
    _assert_attention_close(
        kbs.block_sparse_attention(q, k, v, pattern),
        kbs.block_sparse_attention_plain(q, k, v, pattern),
        lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)


def test_block_sparse_kernel_reads_strided_views(cuda):
    """The model's layout: k and v with kv heads repeated (a strided view)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = _randn(g, 2, 256, 8, 128, dtype=torch.bfloat16, device=cuda)
    kv = _randn(g, 2, 256, 4, 128, dtype=torch.bfloat16, device=cuda)
    k = kv[:, :, :, None].expand(2, 256, 4, 2, 128).reshape(2, 256, 8, 128)
    v = torch.flip(k, dims=[2])
    pattern = _pattern("windowed", 256, 64)
    _assert_attention_close(
        kbs.block_sparse_attention(q, k, v, pattern),
        kbs.block_sparse_attention_plain(q, k, v, pattern),
        lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)


def _reduced(**kw):
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(layers=2), **kw)


@pytest.mark.parametrize("cache_len", [64, 12])
def test_model_kernels_match_plain_path(cuda, cache_len):
    """Reduced qwen3 in f32 (hd 64): prefill + decode with the kernels
    against the plain path; cache_len 12 < 16 keeps a linear cache, 64 runs
    the windowed prefill and a wrapping ring buffer."""
    cfg = _reduced()
    params = T.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 10), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    outs = {}
    _build.reset_launch_counts()
    for knob in (None, "flash"):
        c = dataclasses.replace(cfg, attn_kernel=knob)
        logits, cache = T.prefill(params, {"tokens": toks}, c, cache_len)
        seq = [logits]
        tok = torch.argmax(logits[:, -1:], -1)
        for i in range(min(cache_len - 10, 20)):
            logits, cache = T.decode_step(params, tok, cache, 10 + i, c)
            seq.append(logits)
            tok = torch.argmax(logits, -1)
        outs[knob] = seq
    for a, b in zip(outs["flash"], outs[None]):
        torch.testing.assert_close(a, b, **LOGITS)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers and counts["decode_attention"] > 0


@pytest.mark.parametrize("S,cache_len", [(16, 64), (24, 40), (10, 24)])
def test_model_block_sparse_matches_plain_path(cuda, S, cache_len):
    """Reduced qwen3 in f32: prefill through the block-sparse kernel (S of
    16 and 24: blocks 16 and 8, windowed where cache_len exceeds 16) or, with
    no block dividing S, the plain path; then decode through the kernel."""
    cfg = _reduced()
    params = T.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, S), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(S))
    outs = {}
    for knob in (None, "block_sparse"):
        _build.reset_launch_counts()
        c = dataclasses.replace(cfg, attn_kernel=knob)
        logits, cache = T.prefill(params, {"tokens": toks}, c, cache_len)
        seq = [logits]
        tok = torch.argmax(logits[:, -1:], -1)
        for i in range(6):
            logits, cache = T.decode_step(params, tok, cache, S + i, c)
            seq.append(logits)
            tok = torch.argmax(logits, -1)
        outs[knob] = seq
    for a, b in zip(outs["block_sparse"], outs[None]):
        torch.testing.assert_close(a, b, **LOGITS)
    counts = _build.launch_counts()
    assert counts["block_sparse_attention"] == (cfg.num_layers if S % 8 == 0 else 0)
    assert counts["decode_attention"] > 0


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_engine_kernels_match_plain_engine(cuda, quantized_kv):
    cfg = _reduced(long_context_window=None, quantized_kv=quantized_kv)
    params = T.init_model(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 9, 5, 13, 7)]
    prompts[4] = prompts[0]  # admitted after the tick-0 burst: a prefix-cache hit
    runs = {}
    for knob in (None, "flash", "block_sparse"):
        reqs = [Request(prompt=list(p), max_new_tokens=5) for p in prompts]
        eng = ServeEngine(dataclasses.replace(cfg, attn_kernel=knob), params, max_slots=3,
                          cache_len=32, prompt_bucket=8, device=cuda)
        eng.run(reqs)
        assert all(r.done for r in reqs) and eng.prefix_hits == 1
        runs[knob] = [(r.output, r.admit_tick, r.finish_tick) for r in reqs]
    assert runs["flash"] == runs[None] == runs["block_sparse"]


def _zoo_reduced(arch):
    """Reduced zoo configs in f32 at the kernels' new shapes: granite-20b with
    12 query heads on its one kv head (the wide decode body at hd 64), the
    hybrid at hd 256 (the hd-256 attention bodies and wide decode)."""
    cfg = get_config(arch)
    if arch == "granite-20b":
        return dataclasses.replace(cfg.reduced(layers=2), num_heads=12, head_dim=64)
    return dataclasses.replace(cfg.reduced(layers=3), num_heads=2, head_dim=256)


@pytest.mark.parametrize("arch", ["granite-20b", "recurrentgemma-2b"])
def test_zoo_model_and_engine_kernels_match_plain(cuda, arch):
    """Prefill (a ring that wraps for the hybrid's 16-row local window) and 8
    decode steps with the kernels against the plain path, then the engine
    with flash and block-sparse prefill against the plain engine."""
    cfg = _zoo_reduced(arch)
    params = T.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    outs = {}
    _build.reset_launch_counts()
    for knob in (None, "flash"):
        c = dataclasses.replace(cfg, attn_kernel=knob)
        logits, cache = T.prefill(params, {"tokens": toks}, c, 48)
        seq = [logits]
        tok = torch.argmax(logits[:, -1:], -1)
        for i in range(8):
            logits, cache = T.decode_step(params, tok, cache, 24 + i, c)
            seq.append(logits)
            tok = torch.argmax(logits, -1)
        outs[knob] = seq
    for a, b in zip(outs["flash"], outs[None]):
        torch.testing.assert_close(a, b, **LOGITS)
    layers = sum(cfg.mixer_for_layer(i) != "rglru" for i in range(cfg.num_layers))
    counts = _build.launch_counts()
    assert counts["flash_attention"] == layers and counts["decode_attention"] == 8 * layers
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (8, 24, 8, 16, 40)]
    runs = {}
    for knob in (None, "flash", "block_sparse"):
        reqs = [Request(prompt=list(p), max_new_tokens=5) for p in prompts]
        ServeEngine(dataclasses.replace(cfg, attn_kernel=knob), params, max_slots=3,
                    cache_len=64, prompt_bucket=8, device=cuda).run(reqs)
        runs[knob] = [(r.output, r.admit_tick, r.finish_tick) for r in reqs]
    assert runs["flash"] == runs[None] == runs["block_sparse"]


# ------------------------------------------------------------ gossip kernels
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_kernels_match_plain_bit_for_bit(cuda, bits):
    g = torch.Generator(device=cuda).manual_seed(bits)
    x = torch.randn(1024, 128, generator=g, device=cuda)
    xi = torch.rand(1024, 128, generator=g, device=cuda)
    norm = torch.linalg.vector_norm(x).reshape(1)
    before = (kq.quantize_launches.count, kq.dequantize_launches.count)
    lvl, sign = kq.quantize(x, xi, norm, bits)
    plvl, psign = kq.quantize_plain(x, xi, norm, bits)
    assert torch.equal(lvl, plvl) and torch.equal(sign, psign)
    scale = norm / f32_full(norm, (1 << bits) * tau_for(x.numel(), bits))
    assert torch.equal(kq.dequantize(lvl, sign, scale, bits),
                       kq.dequantize_plain(lvl, sign, scale, bits))
    assert (kq.quantize_launches.count, kq.dequantize_launches.count) == (before[0] + 1,
                                                                          before[1] + 1)


@pytest.mark.parametrize("dtype,digest", [(torch.float32, False), (torch.bfloat16, True)])
def test_fused_encode_kernel_matches_plain_bit_for_bit(cuda, dtype, digest):
    g = torch.Generator(device=cuda).manual_seed(3)
    m, R = 4, 512
    tn, hat = (torch.randn(m, R, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    xi = torch.rand(m, R, 128, generator=g, device=cuda)
    norms = torch.linalg.vector_norm((tn - hat).float().reshape(m, -1), dim=1)
    scales = torch.stack([encode_scale(norms, 4),
                          norms / f32_full(norms, 16 * tau_for(R * 128, 4))], 1)
    out = kc.fused_encode(tn, hat, xi, scales, 4, with_digest=digest)
    for a, b in zip(out, kc.fused_encode_plain(tn, hat, xi, scales, 4, with_digest=digest)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [1, 3, 8])
def test_fused_mix_kernel_matches_plain_bit_for_bit(cuda, K):
    g = torch.Generator(device=cuda).manual_seed(K)
    m, R = 4, 512
    randint = lambda *s: torch.randint(0, 256, s, generator=g, device=cuda).to(torch.uint8)
    lvl, sign = randint(m, R // 2, 128), randint(m, R // 8, 128)
    s = torch.randn(m, R, 128, generator=g, device=cuda)
    ws = torch.rand(K, m, generator=g, device=cuda)
    shifts = [k - K // 2 for k in range(K)]
    rl = torch.stack([torch.roll(lvl, k, 0) for k in shifts])
    rs = torch.stack([torch.roll(sign, k, 0) for k in shifts])
    want = kc.fused_mix_plain(rl, rs, s, ws, 4)
    assert torch.equal(kc.fused_mix(rl, rs, s, ws, 4), want)
    assert torch.equal(kc.fused_mix_shifted(lvl, sign, s.clone(), ws, shifts, 4), want)


def test_packed_and_fused_rounds_agree_on_the_card(cuda):
    """One bf16 round: theta and theta_hat equal, s within one bf16 step."""
    g = torch.Generator(device=cuda).manual_seed(0)
    m = 4
    theta, hat, s = (torch.randn(m, 3, 5000, generator=g, device=cuda).to(torch.bfloat16)
                     for _ in range(3))
    comp = KernelQuantization(4)
    xi = torch.rand(comp.noise_shape(m, (3, 5000)), generator=g, device=cuda)
    packed = gossip._round_leaf(theta, hat, s, xi, ring(m), 0.1, comp, True, False)
    fused = gossip._round_leaf(theta, hat, s, xi, ring(m), 0.1, comp, True, True)
    assert torch.equal(packed[0], fused[0]) and torch.equal(packed[1], fused[1])
    a, b = packed[2].float(), fused[2].float()
    assert bool(((a - b).abs() <= torch.maximum(a.abs(), b.abs()) * 2.0**-7).all())


@pytest.mark.parametrize("fused", [False, True])
def test_reduced_trainer_runs_through_the_gossip_kernels(cuda, fused):
    _build.reset_launch_counts()
    res = train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2", "--compressor",
                      "kq4b", *(["--fused-gossip"] if fused else [])])
    assert all(np.isfinite(res["losses"]))
    counts = _build.launch_counts()
    names = ("fused_encode", "fused_mix") if fused else ("quantize", "dequantize")
    assert all(counts[n] > 0 for n in names)


def test_zero_residual_quantizes_and_decodes_to_exact_zeros(cuda):
    """A dropped node's residual is zero: no level, no sign, and exactly
    0.0 back (the kernel divides by max(norm, 1e-30))."""
    g = torch.Generator(device=cuda).manual_seed(1)
    m, shape = 3, (2, 5000)
    x = torch.randn((m,) + shape, generator=g, device=cuda)
    x[1] = 0.0
    comp = KernelQuantization(4)
    xi = torch.rand(comp.noise_shape(m, shape), generator=g, device=cuda)
    payload = comp.encode(x, xi)
    assert float(payload["norm"][1]) == 0.0
    assert not bool(payload["levels"][1].any()) and not bool(payload["signs"][1].any())
    out = comp.decode(payload, shape, torch.float32)
    assert torch.equal(out[1].view(torch.int32), torch.zeros_like(out[1]).view(torch.int32))
    cpu = comp.decode(comp.encode(x.cpu(), xi.cpu()), shape, torch.float32)
    assert torch.equal(out.cpu(), cpu)


def test_masked_kq4b_round_matches_its_cpu_twin(cuda):
    """One masked round (round-robin W(t), node 1 dropped), bf16 state on
    the card through the quantize / dequantize kernels, against the same
    round on the CPU's plain versions: theta and theta_hat equal, s within
    one bf16 step (the dense W(t) products sum in another order); the
    dropped node's rows untouched; one encode and one decode per node."""
    from repro_torch.core.topology import make_topology_schedule

    g = torch.Generator().manual_seed(2)
    m, shape = 4, (3, 5000)
    theta, hat, s = (torch.randn((m,) + shape, generator=g).to(torch.bfloat16)
                     for _ in range(3))
    comp = KernelQuantization(4)
    xi = torch.rand(comp.noise_shape(m, shape), generator=g)
    sched = make_topology_schedule("roundrobin:ring,torus", m, dropout=0.3)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    outs = []
    for dev in ("cpu", cuda):
        before = (kq.quantize_launches.count, kq.dequantize_launches.count)
        trees = [{"w": x.clone().to(dev)} for x in (theta, hat, s)]
        state = gossip.CHOCOState(theta_hat=trees[1], s=trees[2])
        t_new, st = gossip.choco_round(trees[0], state, sched.topology_at(1), 0.2, comp,
                                       noise=lambda li, ci, shape_: xi, mixing=sched.mixing_at(1, mask),
                                       mask=mask.to(dev))
        launched = (kq.quantize_launches.count - before[0],
                    kq.dequantize_launches.count - before[1])
        outs.append([t_new["w"].cpu(), st.theta_hat["w"].cpu(), st.s["w"].cpu()])
    assert launched == (m, m)
    (tc, hc, sc), (tg, hg, sg) = outs
    assert torch.equal(tc, tg) and torch.equal(hc, hg)
    a, b = sc.float(), sg.float()
    assert bool(((a - b).abs() <= torch.maximum(a.abs(), b.abs()) * 2.0**-7 + 1e-6).all())
    for before_, after in ((theta, tg), (hat, hg), (s, sg)):
        assert torch.equal(after[1], before_[1])


# ------------------------------------------------------------------ block top-k
def _topk_rows(case, g, device):
    """(x [rows, block] f32, k) for one block top-k case."""
    if case == "random":
        return torch.randn(300, 1024, generator=g, device=device), 256
    if case == "ties":  # few magnitudes; row 0 ties its max more than k times
        x = torch.randint(1, 4, (64, 256), generator=g, device=device).float()
        x = x * (torch.randint(0, 2, x.shape, generator=g, device=device) * 2 - 1)
        x[0, ::2] = 3.0
        return x, 100
    if case == "zero_row":
        x = torch.randn(16, 128, generator=g, device=device)
        x[3] = 0.0
        return x, 32
    if case == "negative":
        return -torch.randn(16, 128, generator=g, device=device).abs(), 16
    if case == "k1":
        return torch.randn(33, 512, generator=g, device=device), 1
    if case == "k_block":
        return torch.randn(8, 2048, generator=g, device=device), 2048
    if case == "ragged_block":
        return torch.randn(9, 300, generator=g, device=device), 75
    raise ValueError(case)


def test_block_topk_kernel_on_all_zero_rows(cuda):
    """A dropped node's zero residual: every block of zeros keeps zeros,
    bit for bit against ``ref.block_topk_ref`` (signed zeros included),
    alone and beside live rows."""
    from repro_torch.kernels.ref import block_topk_ref

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, 6 * 1024, generator=g, device=cuda)
    x[2] = 0.0
    x[3, :2048] = -0.0
    out = ops.block_topk(x, 0.25, 1024)
    want = block_topk_ref(x.reshape(-1, 1024).cpu(), 256).reshape(x.shape)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
    assert not bool(out[2].any())


@pytest.mark.parametrize("case", ["random", "ties", "zero_row", "negative", "k1", "k_block",
                                  "ragged_block"])
def test_block_topk_kernel_matches_plain_bit_for_bit(cuda, case):
    x, k = _topk_rows(case, torch.Generator(device=cuda).manual_seed(len(case)), cuda)
    before = ktopk.launches.count
    out = ktopk.block_topk(x, k)
    assert ktopk.launches.count == before + 1
    want = ktopk.block_topk_plain(x, k)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))  # -0.0 included
    if case == "negative":
        assert bool(torch.signbit(out).all())


@pytest.mark.parametrize("rows,block,k", [
    (4097, 1024, 256),   # rows not a multiple of the CTA's 4 warps
    (30001, 1024, 256),  # more rows than resident warps: each warp walks several
    (20003, 300, 75),    # 75 16-byte chunks per row: lanes past the row idle
    (5001, 75, 7),       # 4-byte elements: block % 4 != 0
    (12345, 2048, 1),
    (7, 1, 1),
])
def test_block_topk_kernel_persistent_walks(cuda, rows, block, k):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, block, generator=g, device=cuda) * 0.02
    x[rows // 2] = 0.0
    x[-1, ::3] = 0.01  # ties at the max
    out = ktopk.block_topk(x, k)
    want = ktopk.block_topk_plain(x, k)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_block_topk_kernel_reads_an_unaligned_view(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn(257 * 1024 + 1, generator=g, device=cuda)
    x = base[1:].view(257, 1024)  # 4 bytes past a 16-byte boundary: the 4-byte path
    out = ktopk.block_topk(x, 100)
    assert torch.equal(out.view(torch.int32), ktopk.block_topk_plain(x, 100).view(torch.int32))


@pytest.mark.parametrize("case", ["huge", "ties", "subnormal"])
def test_block_topk_kernel_off_the_banded_rounds(cuda, case):
    """Rows the banded rounds do not take (magnitudes past 1e38; a band of
    ties wider than the per-lane lists) and subnormal rows."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    if case == "huge":
        x = torch.randn(300, 1024, generator=g, device=cuda)
        x[:, :3] = 3e38
    elif case == "ties":
        x = torch.randint(8, 129, (300, 1024), generator=g, device=cuda).float() / 8
    else:
        x = torch.randn(300, 1024, generator=g, device=cuda) * 1e-39
    for k in (1, 256, 300):
        out = ktopk.block_topk(x, k)
        assert torch.equal(out.view(torch.int32), ktopk.block_topk_plain(x, k).view(torch.int32))


def test_block_topk_op_launches_once_for_all_nodes(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 37, 29, generator=g, device=cuda).to(torch.bfloat16)
    before = ktopk.launches.count
    out = ops.block_topk(x, 0.25, 128)
    assert ktopk.launches.count == before + 1
    assert torch.equal(out, ops.block_topk(x.cpu(), 0.25, 128).to(cuda))


def test_reduced_trainer_runs_through_the_block_topk_kernel(cuda):
    _build.reset_launch_counts()
    res = train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2"],
                     compressor=KernelBlockTopK(0.25, 1024))
    assert all(np.isfinite(res["losses"])) and res["gamma"] == 0.125
    assert _build.launch_counts()["block_topk"] > 0


# ------------------------------------------------------------- serving fleet
FLEET_ARGV = ["--arch", "qwen3-1.7b", "--reduced", "--fleet", "2", "--slots", "2",
              "--prompts", "zipf", "--prompt-pool", "8", "--prompt-len", "24", "--gen", "6",
              "--cache-len", "48", "--requests", "24", "--rate", "0.5"]


@pytest.mark.parametrize("overrides,prefill_kernel,decode_kernel", [
    ({"attn_kernel": "flash"}, "flash_attention", "decode_attention"),
    ({"attn_kernel": "flash", "quantized_kv": True}, "flash_attention", "decode_attention_int8"),
    ({"attn_kernel": "block_sparse"}, "block_sparse_attention", "decode_attention"),
])
def test_fleet_on_the_kernels_equals_its_twin(cuda, overrides, prefill_kernel, decode_kernel):
    """serve.py --fleet at reduced width (full attention, so the prefix cache
    is on): every prefill and decode forward launches its kernel once per
    layer, and the --no-fastpath twin has the same tick fields."""
    overrides = {**overrides, "long_context_window": None}
    runs = {}
    for extra in ([], ["--no-fastpath"]):
        _build.reset_launch_counts()
        res = serve.main(FLEET_ARGV + extra, config_overrides=overrides)
        counts = _build.launch_counts()
        layers = get_config("qwen3-1.7b").reduced().num_layers
        assert counts[prefill_kernel] == layers * res["prefill_forwards"] > 0
        assert counts[decode_kernel] == layers * res["decode_forwards"] > 0
        runs[bool(extra)] = res
    fast, twin = runs[False], runs[True]
    assert fast["metrics"]["cache_hit_rate"] > 0 and twin["metrics"]["cache_hit_rate"] == 0
    assert fast["ticks"] == twin["ticks"]
    for k in ("completed", "rejected", "shed", "p50_ttft_ticks", "p95_ttft_ticks",
              "p99_ttft_ticks", "mean_queue_depth", "max_queue_depth", "slot_occupancy"):
        assert fast["metrics"][k] == twin["metrics"][k], k


def test_fleet_hot_reload_on_the_card(cuda, tmp_path):
    """A node serving on the card reloads a saved step onto the card, skips
    a torn newer file, and drops its prefix cache."""
    cfg = _reduced(long_context_window=None, attn_kernel="flash")
    params = T.init_model(cfg, seed=0, device=cuda)
    prefix = str(tmp_path / "consensus")
    node = FleetNode(0, ServeEngine(cfg, params, max_slots=2, cache_len=48, prompt_bucket=8,
                                    device=cuda),
                     reloader=HotReloader(prefix, params, log=lambda s: None))
    for n in (5, 9, 5):
        node.offer(Request(prompt=list(range(1, n + 1)), max_new_tokens=3), tick=0)
    while not node.drained:
        node.tick()
    assert node.engine.stats()["prefix_entries"] > 0
    new = {**params, "final_norm": {"scale": params["final_norm"]["scale"] * 2}}
    save(prefix, new, step=1)
    with open(step_path(prefix, 2), "wb") as f:
        f.write(b"PK\x03\x04 torn")
    assert node.maybe_reload() == 1 and node.reloader.skipped == 1
    got = node.engine.params["final_norm"]["scale"]
    assert got.device.type == "cuda" and torch.equal(got, new["final_norm"]["scale"])
    assert node.engine.stats()["prefix_entries"] == 0 and node.engine.prefix_invalidations == 1
    node.offer(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=3), tick=node.engine._steps)
    while not node.drained:
        node.tick()
    assert len(node.requests[-1].output) == 3


def test_classifier_engine_on_the_card(cuda):
    """The classifier engine and the batched probe on the card predict what
    they predict on the CPU."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    x = rng.normal(size=(11, 6)).astype(np.float32)
    y = rng.integers(0, 4, 11)
    want = np.argmax(x @ w + b, axis=-1)
    for dev in (cuda, torch.device("cpu")):
        params = {"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}
        eng = ClassifierEngine(train_serve.logistic_apply, params, max_slots=4)
        reqs = [EvalRequest(features=x[i:i + 1]) for i in range(len(x))]
        for r in reqs:
            eng.submit(r)
        while eng.pending:
            eng.step()
        assert [r.output[0] for r in reqs] == want.tolist()
        probe = BatchedProbe(train_serve.logistic_apply, {"a": (x[:5], y[:5]), "b": (x[5:], y[5:])},
                             loss_fn=train_serve.loss_fn)
        q = probe.probe(params, step=3)
        assert q["a"]["acc"] == float((want[:5] == y[:5]).mean()) and probe.probe_forwards == 1
        assert probe.probe(params, step=3) is q and probe.probe_forwards == 1
