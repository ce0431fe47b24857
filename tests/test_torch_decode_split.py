"""The split-L decode kernel's plan, on the CPU.

``csrc/decode_attn.cu`` cuts the cache length into chunks of whole 64-row
tiles (``kernels/decode.py::split_plan``), one block per (chunk, kv head,
batch row); a tile with no live row is skipped, a dead row in a live tile is
not read, each chunk leaves an f32 partial ``(m, l, acc)`` and the last
block of the cache row to finish combines them; a batch row with no live
row at all takes the uniform mean of V over all L.  ``decode_attention_split`` runs that plan in plain
PyTorch.  Here it is held against the port's plain version
(``decode_attention_ref``) and the JAX oracle ``repro.kernels.ref.
decode_attention_ref`` (the JAX Pallas decode kernel raises in interpret
mode under jax 0.9.0), on the same numpy inputs: f32, bf16 and int8 KV, hd
64 / 128, G 1..8, linear and ring-wrapped masks, an all-masked row, L below
one tile and not a multiple of it.

Tolerances: f32 ``atol 2e-5, rtol 1e-4`` (the same math in another
summation order); bf16 ``atol 1e-4, rtol 1e-2`` (both sides reduce in f32 and
round once to bf16: at most one rounding step apart), the bounds of
``PERF.md`` section 2.  The CUDA kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode as kd
from repro_torch.kernels.ref import quantize_kv_ref

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=1e-4, rtol=1e-2)


def _valid(B, L, mask, rng):
    """[B, L] bool: 'linear' (row b holds positions 0..p_b), 'ring' (a ring
    buffer after wrapping), 'holes' (random rows dead), 'dead' (row 0 all
    masked, the rest linear)."""
    idx = np.arange(L)[None]
    pos = rng.integers(0, 3 * L, B)
    if mask == "linear":
        return idx <= np.minimum(pos, L - 1)[:, None]
    if mask == "ring":
        age = ((pos % L)[:, None] - idx) % L
        return age < np.minimum(pos + 1, L)[:, None]
    if mask == "holes":
        v = rng.random((B, L)) < 0.3
        v[:, 0] = True
        return v
    if mask == "dead_tiles":  # row 0 all masked; the others lose whole tiles
        v = rng.random((B, L)) < 0.7
        v[0] = False
        v[1:, 64:192] = False
        return v
    v = idx <= np.minimum(pos, L - 1)[:, None]
    v[0] = False
    return v


def _inputs(B, L, KV, G, hd, mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    return q, k, v, _valid(B, L, mask, rng)


def _jax_ref(q, k, v, valid, ks=None, vs=None):
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    return np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(valid), **kw), np.float32)


@pytest.mark.parametrize("B,KV,L", [(1, 1, 1), (2, 3, 64), (3, 2, 300), (4, 8, 1024),
                                    (64, 8, 8192), (1, 1, 10**6)])
def test_split_plan_covers_the_cache_in_whole_tiles(B, KV, L):
    chunk, splits = kd.split_plan(B, KV, L)
    assert chunk % kd.TILE == 0 and chunk >= kd.TILE
    assert (splits - 1) * chunk < L <= splits * chunk  # every row in exactly one chunk
    assert splits <= kd.MAX_SPLITS
    tiles = -(-L // kd.TILE)
    if tiles * B * KV <= kd.MAX_BLOCKS and tiles <= kd.MAX_SPLITS:
        assert chunk == kd.TILE  # one tile per block while the grid allows
    else:  # merged only as far as the grid and the split cap need
        assert splits * B * KV <= kd.MAX_BLOCKS + B * KV
        shorter = -(-L // (chunk - kd.TILE))
        assert shorter * B * KV > kd.MAX_BLOCKS or shorter > kd.MAX_SPLITS


def test_split_plan_at_the_serving_shape():
    # qwen3-1.7b, B4 L1024 KV8 G2: 16 chunks of 64 rows, 512 blocks on 132 SMs
    assert kd.split_plan(4, 8, 1024, 2) == (64, 16)
    assert kd.split_plan(4, 8, 1024) == (64, 16)


@pytest.mark.parametrize("B,KV,L,G,expect", [
    (4, 1, 1024, 48, (128, 8)),    # granite-20b: a row of 8 chunks, one cluster
    (4, 1, 2048, 10, (256, 8)),    # recurrentgemma-2b's ring
    (4, 8, 272, 4, (64, 5)),       # qwen3-4b
    (2, 8, 272, 8, (64, 5)),       # command-r-35b
    (2, 1, 500, 64, (64, 8)),
    (3, 2, 37, 33, (64, 1)),       # a cache under one tile
    (4, 1, 2049, 48, (192, 11)),   # past 32 tiles: partials through device memory
    (1, 1, 10**6, 64, None),       # long caches: at most MAX_PARTIALS partials a row
])
def test_split_plan_at_wide_groups(B, KV, L, G, expect):
    """Past 2 query heads a cache row of at most CLUSTER x CLUSTER_TILES
    tiles is cut into at most CLUSTER chunks (one cluster); a longer one
    gives a chunk at least ROWS_PER_HEAD rows per head (its f32 partial at
    most a quarter of its bf16 K/V bytes) and a row at most MAX_PARTIALS
    partials (the combine's (m, l) pairs)."""
    chunk, splits = kd.split_plan(B, KV, L, G)
    if expect is not None:
        assert (chunk, splits) == expect
    assert chunk % kd.TILE == 0
    assert (splits - 1) * chunk < L <= splits * chunk
    assert splits * G <= kd.MAX_PARTIALS and splits <= kd.MAX_SPLITS
    if -(-L // kd.TILE) <= kd.CLUSTER * kd.CLUSTER_TILES:
        assert splits <= kd.CLUSTER and chunk <= kd.CLUSTER_TILES * kd.TILE
    else:
        assert chunk >= kd.ROWS_PER_HEAD * G
    # the split body's groups keep the plan they had
    assert kd.split_plan(B, KV, L, 2) == kd.split_plan(B, KV, L)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hd,G,L,mask", [
    (128, 2, 1024, "ring"),    # the engine's shape, cut in batch
    (64, 1, 37, "linear"),     # below one tile
    (128, 8, 1000, "holes"),   # not a multiple of a tile; dead rows in live tiles
    (64, 4, 200, "dead"),      # an all-masked row
    (128, 3, 130, "ring"),
    (64, 5, 64, "linear"),
])
def test_split_twin_matches_plain_and_jax(dtype, hd, G, L, mask):
    B, KV = 3, 2
    q, k, v, valid = _inputs(B, L, KV, G, hd, mask, seed=hd + G + L)
    tv = torch.from_numpy(valid)
    if dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv_ref(torch.from_numpy(k)), quantize_kv_ref(
            torch.from_numpy(v))
        args = (torch.from_numpy(q), kq, vq, tv)
        kw = dict(k_scale=ks, v_scale=vs)
        jax_out = _jax_ref(q, kq.numpy(), vq.numpy(), valid, ks.numpy(), vs.numpy())
        tol = F32
    elif dtype == "bfloat16":
        args = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)) + (tv,)
        kw = {}
        jax_out = _jax_ref(*(a.float().numpy() for a in args[:3]), valid)
        tol = BF16
    else:
        args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tv)
        kw = {}
        jax_out = _jax_ref(q, k, v, valid)
        tol = F32
    twin = kd.decode_attention_split(*args, **kw)
    plain = kd.decode_attention_plain(*args, **kw)
    assert twin.dtype == plain.dtype and twin.shape == plain.shape
    torch.testing.assert_close(twin.float(), plain.float(), **tol)
    # the JAX oracle in f32 on the same values: the twin is one bf16 rounding off
    np.testing.assert_allclose(twin.float().numpy(), jax_out, **tol)


@pytest.mark.parametrize("quantized", [False, True])
def test_all_masked_row_takes_the_uniform_mean_of_v(quantized):
    q, k, v, valid = _inputs(2, 150, 2, 2, 64, "linear", seed=3)
    valid[1] = False
    args = [torch.from_numpy(a) for a in (q, k, v, valid)]
    kw = {}
    if quantized:
        (args[1], ks), (args[2], vs) = quantize_kv_ref(args[1]), quantize_kv_ref(args[2])
        kw = dict(k_scale=ks, v_scale=vs)
    twin = kd.decode_attention_split(*args, **kw)
    vf = args[2].float() * (kw["v_scale"][..., None] if quantized else 1.0)
    mean = vf[1].mean(0)  # [KV, hd]
    torch.testing.assert_close(twin[1], mean[:, None, :].expand_as(twin[1]), **F32)
    torch.testing.assert_close(twin, kd.decode_attention_plain(*args, **kw), **F32)


def test_dead_rows_are_never_read():
    """K and V of rows that are not live do not reach the result (the kernel
    never loads them): garbage there leaves the twin's output unchanged, bit
    for bit, unless a batch row has no live row at all."""
    q, k, v, valid = _inputs(3, 700, 2, 4, 128, "holes", seed=5)
    valid[2, 128:320] = False  # whole dead tiles as well
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    out = kd.decode_attention_split(*t)
    dead = ~t[3][:, :, None, None]
    garbage = torch.full_like(t[1], 1e6)
    out2 = kd.decode_attention_split(t[0], torch.where(dead, garbage, t[1]),
                                     torch.where(dead, -garbage, t[2]), t[3])
    assert torch.equal(out, out2)


def _wide_args(dtype, q, k, v, valid):
    """(args, kwargs, JAX oracle output) of one dtype: f32, bf16, or int8 K/V
    with bf16 queries (the serving path's int8 cache)."""
    tv = torch.from_numpy(valid)
    if dtype == "int8":
        (kq, ks), (vq, vs) = (quantize_kv_ref(torch.from_numpy(a)) for a in (k, v))
        qb = torch.from_numpy(q).to(torch.bfloat16)
        jax_out = _jax_ref(qb.float().numpy(), kq.numpy(), vq.numpy(), valid, ks.numpy(),
                           vs.numpy())
        return (qb, kq, vq, tv), dict(k_scale=ks, v_scale=vs), jax_out
    if dtype == "bfloat16":
        args = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)) + (tv,)
        return args, {}, _jax_ref(*(a.float().numpy() for a in args[:3]), valid)
    args = tuple(torch.from_numpy(a) for a in (q, k, v)) + (tv,)
    return args, {}, _jax_ref(q, k, v, valid)


# wide groups at reduced L: recurrentgemma-2b's G 10 at hd 256, granite-20b's
# G 48, and the 16-row padding edges G 17 and G 33
WIDE = [(256, 10, 300, "ring"), (128, 48, 400, "ring"), (128, 17, 260, "holes"),
        (64, 33, 330, "dead_tiles"), (256, 48, 200, "dead_tiles")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hd,G,L,mask", WIDE)
def test_split_twin_at_wide_groups(dtype, hd, G, L, mask):
    """The plan at wide G (chunks of at least 4 rows per head) against the
    plain version and the JAX oracle: bf16 and f32, int8 K/V with bf16
    queries, an all-masked row, whole dead tiles and dead rows."""
    B, KV = 3, 1 if G > 16 else 2
    q, k, v, valid = _inputs(B, L, KV, G, hd, mask, seed=hd + G + L)
    args, kw, jax_out = _wide_args(dtype, q, k, v, valid)
    tol = F32 if dtype == "float32" else BF16
    twin = kd.decode_attention_split(*args, **kw)
    plain = kd.decode_attention_plain(*args, **kw)
    assert twin.dtype == plain.dtype and twin.shape == plain.shape
    torch.testing.assert_close(twin.float(), plain.float(), **tol)
    np.testing.assert_allclose(twin.float().numpy(), jax_out, **tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("hd,G,L,mask", WIDE + [(128, 3, 1000, "holes"), (64, 64, 150, "ring")])
def test_tensor_core_arithmetic_within_the_decode_bound(dtype, hd, G, L, mask):
    """The tensor-core body's arithmetic (bf16 Q.K^T on f32 sums with the
    scale after, P.V as bf16(p) + bf16(p - bf16(p))) over the plan, against
    the plain version and the JAX oracle, within the unchanged decode bound
    (``atol 1e-4, rtol 1e-2``)."""
    B, KV = 3, 1 if G > 16 else 2
    q, k, v, valid = _inputs(B, L, KV, G, hd, mask, seed=7 * hd + G + L)
    args, kw, jax_out = _wide_args(dtype, q, k, v, valid)
    emulated = kd.decode_attention_split(*args, **kw, tensor_cores=True)
    plain = kd.decode_attention_plain(*args, **kw)
    assert emulated.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(emulated.float(), plain.float(), **BF16)
    np.testing.assert_allclose(emulated.float().numpy(), jax_out, **BF16)


def test_p_split_keeps_sixteen_bits():
    """hi = bf16(p), lo = bf16(p - hi) recovers p to about 2**-16 of its
    value, where bf16(p) alone is off by up to 2**-9."""
    p = torch.from_numpy(np.random.default_rng(0).random(100000).astype(np.float32))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert float(((hi + lo - p).abs() / p).max()) <= 2.0**-16
    assert float(((hi - p).abs() / p).max()) > 2.0**-10


@pytest.mark.parametrize("hd,G,L,mask", [(128, 2, 1000, "holes"), (256, 10, 300, "ring"),
                                         (64, 4, 200, "dead")])
def test_split_twin_in_float64(hd, G, L, mask):
    """Float64 inputs run the plan in float64 (the on-card test's oracle for
    the f32 kernel): it agrees with the f32 twin and the JAX oracle within
    the f32 bound and returns float64."""
    q, k, v, valid = _inputs(3, L, 2, G, hd, mask, seed=11 * hd + G)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    twin64 = kd.decode_attention_split(*(a.double() for a in t), torch.from_numpy(valid))
    twin32 = kd.decode_attention_split(*t, torch.from_numpy(valid))
    assert twin64.dtype == torch.float64
    torch.testing.assert_close(twin64.float(), twin32, **F32)
    np.testing.assert_allclose(twin64.numpy(), _jax_ref(q, k, v, valid), **F32)
