"""The attention kernels' tile schedules and arithmetic, on the CPU.

``csrc/attn_mainloop.cuh`` runs one mainloop for ``flash_attn_fwd`` (a range
of kv tiles per query tile, computed in-kernel and written out on the host by
``kernels/flash_attention.py::range_schedule``) and ``block_sparse_attn_fwd``
(the host's re-tiled lists, ``BlockSparsePattern.kernel_tiles``).  Here:

(a) the re-tiled block-sparse schedule against ``ref.block_sparse_mask``;
(b) the range schedule against the causal / window element mask;
    for both, every live (q, k) pair lies in exactly one scheduled tile, no
    tile flagged ``MASK_NONE`` holds a dead pair, a ``MASK_ELEM`` tile's live
    pairs are exactly the causal / window rule's, and no scheduled tile is
    dead (a SKIP-only tile is never loaded);
(c) a torch twin of the kernel's bf16 arithmetic (128-row query tiles,
    128-key kv tiles, the online softmax in log2 units with the scale applied
    in f32, the finite -1e30 sentinel, P rounded to bf16 before P.V) over both
    schedules, held against the plain versions and the JAX oracles
    (``repro.kernels.ref``) on the same numpy inputs, within the kernels'
    bf16 bound: ``1e-4 + 1e-2 |plain| + 2**-8 plain(|v|)``.  The twin's cases
    include rows whose first scheduled tiles are all masked for them.

Small sizes only (S <= 512, a few heads).  The CUDA kernels themselves are
held to the plain versions on the card (``tests/test_torch_cuda.py``).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import block_sparse as kbs
from repro_torch.kernels.flash_attention import MASK_BLOCKS, MASK_ELEM, MASK_NONE, TILE_K
from repro_torch.kernels.ref import NEG_INF, block_sparse_mask, p_rounding_bound
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the submodules themselves: the package exports the ops wrappers of the same names
kf = importlib.import_module("repro_torch.kernels.flash_attention")

P = kbs.BlockSparsePattern
LOG2E = 1.4426950408889634
BF16_TOL = dict(atol=1e-4, rtol=1e-2)  # plus p_rounding_bound


def _elem_mask(seq_q, seq_k, causal, window):
    qp = np.arange(seq_q)[:, None]
    kp = np.arange(seq_k)[None, :]
    live = np.ones((seq_q, seq_k), bool)
    if causal:
        live &= qp >= kp
    if window is not None:
        live &= qp - kp < window
    return live


def _check_schedule(schedule, tile_rows, live, rule):
    """schedule: per query tile [(kv_tile, mask)]; live: [Sq, Sk] the pairs
    the kernel must attend; rule: [Sq, Sk] the causal / window rule."""
    seq_q, seq_k = live.shape
    assert len(schedule) == -(-seq_q // tile_rows)
    cover = np.zeros(live.shape, np.int32)
    for t, tiles in enumerate(schedule):
        kts = [kt for kt, _ in tiles]
        assert kts == sorted(set(kts)), f"query tile {t}: kv tiles not ascending and distinct"
        rows = slice(t * tile_rows, min((t + 1) * tile_rows, seq_q))
        for kt, mask in tiles:
            keys = slice(kt * TILE_K, min((kt + 1) * TILE_K, seq_k))
            tile = live[rows, keys]
            assert tile.any(), f"tile ({t}, {kt}) holds no live pair but is scheduled"
            if mask == MASK_NONE:
                assert tile.all() and (kt + 1) * TILE_K <= seq_k, f"tile ({t}, {kt}) not full"
            elif mask == MASK_ELEM:
                np.testing.assert_array_equal(tile, rule[rows, keys])
            else:
                assert mask == MASK_BLOCKS
            cover[rows, keys] += 1
    assert (cover[live] == 1).all(), "a live pair is not in exactly one scheduled tile"


def _list_schedule(pattern):
    entries, counts, _ = pattern.kernel_tiles(kf.tile_q(pattern.seq_q))
    return [[(int(e) >> 2, int(e) & 3) for e in entries[t, : counts[t]]]
            for t in range(entries.shape[0])]


def _bitmap_pattern(n, block_q, block_k, seed):
    """A random from_bitmap pattern (causal-valid, diagonal live, a FULL
    block where the causal pool allows one)."""
    rng = np.random.default_rng(seed)
    pool = P.causal_pattern(n * block_q, n * block_q, block_q, block_k).bitmap
    keep = rng.random(pool.shape) < 0.5
    diag = np.minimum(((np.arange(pool.shape[0]) + 1) * block_q - 1) // block_k,
                      pool.shape[1] - 1)
    keep[np.arange(pool.shape[0]), diag] = True
    return P.from_bitmap(np.where(keep, pool, kbs.SKIP), block_q=block_q, block_k=block_k)


def _make(layout, S, block_q, block_k):
    if layout == "causal":
        return P.causal_pattern(S, S, block_q, block_k)
    if layout == "windowed":
        return P.windowed(S, S, 3 * max(block_q, block_k) // 2 + 5, block_q, block_k)
    if layout == "strided":
        return P.strided(S, S, local_blocks=2, stride=3, block_q=block_q, block_k=block_k)
    return _bitmap_pattern(S // block_q, block_q, block_k, seed=S + block_q + block_k)


LAYOUTS = ["causal", "windowed", "strided", "bitmap"]
# (block_q, block_k, S): square blocks 8..128, then uneven blocks and lengths
# that are no multiple of the kernel's 128-row / 128-key tile
BLOCKS = [(8, 8, 256), (16, 16, 512), (32, 32, 512), (64, 64, 512), (128, 128, 512),
          (32, 8, 256), (8, 32, 256), (24, 40, 240), (128, 32, 384), (8, 8, 200), (16, 16, 48)]


@pytest.mark.parametrize("block_q,block_k,S", BLOCKS,
                         ids=[f"bq{a}-bk{b}-S{c}" for a, b, c in BLOCKS])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_list_schedule_covers_the_pattern(layout, block_q, block_k, S):
    pattern = _make(layout, S, block_q, block_k)
    live = block_sparse_mask(pattern, "cpu").numpy()
    rule = _elem_mask(S, S, pattern.causal, pattern.window)
    schedule = _list_schedule(pattern)
    _check_schedule(schedule, kf.tile_q(S), live, rule)
    masks = {m for tiles in schedule for _, m in tiles}
    if layout in ("causal", "windowed"):
        assert MASK_BLOCKS not in masks, "pooled patterns need no bitmap reads"


RANGES = [  # Sq, Sk, causal, window
    (512, 512, True, None), (300, 300, True, 100), (200, 200, True, None),
    (1100, 1100, True, 300), (333, 333, True, 50), (64, 64, True, None), (65, 65, True, 13),
    (1, 1, True, None), (40, 100, False, None), (96, 96, False, None), (200, 300, False, 70),
]


@pytest.mark.parametrize("Sq,Sk,causal,window", RANGES)
def test_range_schedule_covers_the_mask(Sq, Sk, causal, window):
    live = _elem_mask(Sq, Sk, causal, window)
    schedule = kf.range_schedule(Sq, Sk, causal=causal, window=window)
    _check_schedule(schedule, kf.tile_q(Sq), live, live)
    assert all(m in (MASK_NONE, MASK_ELEM) for tiles in schedule for _, m in tiles)


# ---------------------------------------------------------------- (c) twin
def twin(q, k, v, schedule, tile_rows, live, scale):
    """The bf16 kernel's arithmetic over ``schedule``: q [BH, Sq, hd], k, v
    [BH, Sk, hd] bf16, live [Sq, Sk] bool -> [BH, Sq, hd] bf16.  Keys past Sk
    are zero-filled (as TMA fills them) and masked."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    n_kt = -(-Sk // TILE_K)
    pad = n_kt * TILE_K - Sk
    kf32 = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf32 = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    live = torch.nn.functional.pad(torch.as_tensor(live), (0, pad))
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros(BH, Sq, hd)
    for t, tiles in enumerate(schedule):
        rows = slice(t * tile_rows, min((t + 1) * tile_rows, Sq))
        qt = q[:, rows].float()
        m = torch.full(qt.shape[:2], NEG_INF)
        l = torch.zeros(qt.shape[:2])
        acc = torch.zeros(qt.shape)
        for kt, mask in tiles:
            keys = slice(kt * TILE_K, (kt + 1) * TILE_K)
            s = (qt @ kf32[:, keys].transpose(1, 2)) * c
            if mask != MASK_NONE:
                s = torch.where(live[rows, keys][None], s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf32[:, keys]
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(torch.bfloat16)


def _inputs(BH, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((BH, s, hd)).astype(np.float32) for s in (Sq, Sk, Sk)]
    # bf16-exact values: the same numbers reach torch (bf16) and JAX (f32)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _assert_within_bf16_bound(out, ref, slack, what):
    out, ref = out.float(), ref.float()
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * ref.abs() + slack
    err = (out - ref).abs()
    assert bool(torch.isfinite(out).all()), what
    assert bool((err <= limit).all()), (
        f"{what}: {int((err > limit).sum())} elements out of bound, max err/limit "
        f"{float((err / limit).max()):.3f}")


def _first_tile_masked_rows(schedule, tile_rows, live):
    """Rows whose first scheduled kv tile holds no live key for them."""
    n = 0
    for t, tiles in enumerate(schedule):
        kt = tiles[0][0]
        rows = live[t * tile_rows:(t + 1) * tile_rows, kt * TILE_K:(kt + 1) * TILE_K]
        n += int((~rows.any(1)).sum())
    return n


FLASH_TWIN = [  # BH, Sq, Sk, hd, causal, window
    (2, 300, 300, 128, True, None), (2, 400, 400, 128, True, 50), (3, 40, 100, 64, False, None),
    (2, 130, 130, 64, True, None),
]


@pytest.mark.parametrize("BH,Sq,Sk,hd,causal,window", FLASH_TWIN)
def test_twin_range_schedule_matches_plain_and_jax(BH, Sq, Sk, hd, causal, window):
    q, k, v = _inputs(BH, Sq, Sk, hd, seed=Sq + hd)
    scale = 1.0 / math.sqrt(hd)
    live = _elem_mask(Sq, Sk, causal, window)
    schedule = kf.range_schedule(Sq, Sk, causal=causal, window=window)
    out = twin(q, k, v, schedule, kf.tile_q(Sq), live, scale)

    def plain(v_):  # [BH, S, hd] as [B=BH, S, H=1, hd]
        return kf.flash_attention_plain(q[:, :, None], k[:, :, None], v_[:, :, None],
                                        causal=causal, window=window)[:, :, 0]

    slack = p_rounding_bound(plain, v)
    _assert_within_bf16_bound(out, plain(v), slack, "twin vs plain")
    want = jref.flash_attention_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                    causal=causal, window=window)
    _assert_within_bf16_bound(out, torch.from_numpy(np.array(want)), slack, "twin vs JAX")
    if window is not None:
        assert _first_tile_masked_rows(schedule, kf.tile_q(Sq), live) > 0


def _masked_first_pattern():
    """Blocks of 32 at S 256: query tile 1 (q blocks 4-7) visits kv tile 0
    for q block 4's FULL block 0, while q block 7 attends only its local
    kv blocks 6-7, so its rows meet kv tile 0 fully masked first."""
    bm = P.causal_pattern(256, 256, 32, 32).bitmap.copy()
    bm[4:, :4] = kbs.SKIP
    bm[4, 0] = kbs.FULL
    bm[7, :6] = kbs.SKIP
    return P.from_bitmap(bm, block_q=32, block_k=32)


SPARSE_TWIN = [  # name, BH, hd, pattern factory
    ("causal-64", 2, 128, lambda: P.causal_pattern(256, 256, 64, 64)),
    ("strided-64", 2, 128, lambda: P.strided(512, 512, local_blocks=2, stride=3, block_q=64,
                                             block_k=64)),
    ("windowed-24x40", 2, 64, lambda: P.windowed(240, 240, 41, 24, 40)),
    ("bitmap-masked-first", 2, 64, _masked_first_pattern),
    ("causal-8-ragged", 1, 128, lambda: P.causal_pattern(200, 200, 8, 8)),
]


@pytest.mark.parametrize("name,BH,hd,make", SPARSE_TWIN, ids=[c[0] for c in SPARSE_TWIN])
def test_twin_list_schedule_matches_plain_and_jax(name, BH, hd, make):
    pattern = make()
    S = pattern.seq_q
    q, k, v = _inputs(BH, S, S, hd, seed=S + hd + len(name))
    scale = 1.0 / math.sqrt(hd)
    live = block_sparse_mask(pattern, "cpu").numpy()
    schedule = _list_schedule(pattern)
    out = twin(q, k, v, schedule, kf.tile_q(S), live, scale)

    def plain(v_):
        return kbs.block_sparse_attention_plain(q[:, :, None], k[:, :, None], v_[:, :, None],
                                                pattern)[:, :, 0]

    slack = p_rounding_bound(plain, v)
    _assert_within_bf16_bound(out, plain(v), slack, "twin vs plain")
    want = jref.block_sparse_attention_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                           pattern)
    _assert_within_bf16_bound(out, torch.from_numpy(np.array(want)), slack, "twin vs JAX")
    if name == "bitmap-masked-first":
        assert _first_tile_masked_rows(schedule, kf.tile_q(S), live) > 0
