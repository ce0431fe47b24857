"""repro_torch gossip kernels (quantize, dequantize, fused encode, fused mix):
their plain versions against the JAX Pallas kernels in interpret mode and
the JAX oracles, on the CPU (the CUDA kernels against their plain versions:
test_torch_cuda.py).

Inputs are made with numpy from a seed and handed to both sides, the noise
``xi`` included; where the port takes a norm itself, the test hands it the
reference's norm (``jnp.linalg.norm`` and ``torch.linalg.vector_norm`` sum in
different orders, so a level at a floor boundary could flip: test_torch_gossip
holds whole rounds to a tolerance instead).  Tolerance: none -- levels,
signs, digests and every float output equal bit for bit (bf16 compared
through int16), because every operation is one IEEE rounding in the same
order on both sides.  The JAX side is compiled with
``xla_allow_excess_precision=False``: by default XLA on the CPU keeps a bf16
difference in f32 inside a fusion, where the reference's semantics (and
PyTorch) round it to bf16.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import choco_fused as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import dequantize_pallas, quantize_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import choco_fused as kc
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the submodules themselves: the package exports the ops wrappers of the same names
kq = importlib.import_module("repro_torch.kernels.quantize")

LANES = 128


def _np(x) -> np.ndarray:
    """A JAX or torch array as numpy; bf16 as its int16 bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax(fn, *args):
    """``fn(*args)`` compiled by XLA with every bf16 operation rounded."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_norms(resid: torch.Tensor) -> torch.Tensor:
    """Per-node norms as the reference takes them (``jnp.linalg.norm``)."""
    r = jnp.asarray(resid.reshape(resid.shape[0], -1).numpy())
    return torch.from_numpy(np.array(_jax(jax.vmap(jnp.linalg.norm), r)))


def _equal(jax_out, torch_out):
    np.testing.assert_array_equal(_np(torch_out), _np(jax_out))


def _pair(a: np.ndarray, dtype="float32"):
    """One numpy array as (jax, torch) arrays of ``dtype`` (bf16 rounds
    the same way, to nearest even, on both sides)."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_dequantize_match_pallas(bits):
    rng = np.random.default_rng(bits)
    rows = 128
    x = rng.standard_normal((rows, LANES)).astype(np.float32)
    xi = rng.random((rows, LANES), dtype=np.float32)
    norm = np.float32(np.linalg.norm(x))
    jl, js = quantize_pallas(jnp.asarray(x), jnp.asarray(xi), jnp.asarray(norm), bits,
                                    interpret=True)
    tl, ts = kq.quantize(torch.from_numpy(x), torch.from_numpy(xi), torch.tensor(norm), bits)
    _equal(jl, tl)
    _equal(js, ts)
    assert tl.shape == (rows * bits // 8, LANES) and ts.shape == (rows // 8, LANES)
    scale = np.float32(norm / np.float32((1 << bits) * ref.tau_for(rows * LANES, bits)))
    jd = dequantize_pallas(jl, js, jnp.asarray(scale), bits, interpret=True)
    _equal(jd, kq.dequantize(tl, ts, torch.tensor(scale), bits))


@pytest.mark.parametrize("bits", [2, 8])
def test_ref_oracles_match_jax(bits):
    rng = np.random.default_rng(10 + bits)
    m, rows, K = 3, 64, 3
    assert ref._rows_for(1000, 8 // bits) == jref._rows_for(1000, 8 // bits)
    assert ref.tau_for(12345, bits) == jref.tau_for(12345, bits)
    x = rng.standard_normal((rows, LANES)).astype(np.float32)
    xi = rng.random((rows, LANES), dtype=np.float32)
    norm = np.float32(np.linalg.norm(x))
    jl, js = jref.quantize_ref(jnp.asarray(x), jnp.asarray(xi), jnp.asarray(norm), bits)
    tl, ts = ref.quantize_ref(torch.from_numpy(x), torch.from_numpy(xi), torch.tensor(norm), bits)
    _equal(jl, tl)
    _equal(js, ts)
    _equal(jref.dequantize_ref(jl, js, jnp.float32(0.125), bits),
           ref.dequantize_ref(tl, ts, 0.125, bits))
    tn = rng.standard_normal((m, rows, LANES)).astype(np.float32)
    hat = rng.standard_normal((m, rows, LANES)).astype(np.float32)
    xi3 = rng.random((m, rows, LANES), dtype=np.float32)
    scales = np.stack([rng.random(m) * 4 + 0.5, rng.random(m) * 0.1], 1).astype(np.float32)
    for jo, to in zip(jref.fused_encode_ref(*map(jnp.asarray, (tn, hat, xi3, scales)), bits),
                      ref.fused_encode_ref(*map(torch.from_numpy, (tn, hat, xi3, scales)), bits)):
        _equal(jo, to)
    lvl = rng.integers(0, 256, (K, m, rows * bits // 8, LANES), dtype=np.uint8)
    sign = rng.integers(0, 256, (K, m, rows // 8, LANES), dtype=np.uint8)
    ws = rng.random((K, m), dtype=np.float32)
    _equal(jref.fused_mix_ref(*map(jnp.asarray, (lvl, sign, tn, ws)), bits),
           ref.fused_mix_ref(*map(torch.from_numpy, (lvl, sign, tn, ws)), bits))


def _encode_inputs(seed, m, rows, bits, dtype):
    rng = np.random.default_rng(seed)
    tn = rng.standard_normal((m, rows, LANES)).astype(np.float32)
    hat = (0.5 * rng.standard_normal((m, rows, LANES))).astype(np.float32)
    xi = rng.random((m, rows, LANES), dtype=np.float32)
    (jtn, ttn), (jhat, that) = _pair(tn, dtype), _pair(hat, dtype)
    resid = np.asarray((jtn - jhat).astype(jnp.float32)).reshape(m, -1)
    norms = np.sqrt((resid.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    tau = np.float32((1 << bits) * ref.tau_for(rows * LANES, bits))
    scales = np.stack([np.float32(1 << bits) / norms, norms / tau], 1).astype(np.float32)
    return (jtn, jhat, jnp.asarray(xi), jnp.asarray(scales)), (ttn, that, torch.from_numpy(xi),
                                                               torch.from_numpy(scales))


@pytest.mark.parametrize("dtype,digest", [("float32", False), ("float32", True),
                                          ("bfloat16", False), ("bfloat16", True)])
def test_fused_encode_matches_pallas(dtype, digest):
    bits, m, rows = 4, 3, 32
    jin, tin = _encode_inputs(7, m, rows, bits, dtype)
    jout = _jax(lambda *a: jfused.fused_encode_pallas(*a, bits, interpret=True,
                                                      with_digest=digest), *jin)
    tout = kc.fused_encode(*tin, bits, with_digest=digest)
    assert len(tout) == len(jout) == (4 if digest else 3)
    for j, t in zip(jout, tout):
        _equal(j, t)
    assert tout[2].dtype == tin[1].dtype


@pytest.mark.parametrize("K,dtype", [(1, "float32"), (3, "float32"), (8, "float32"),
                                     (3, "bfloat16")])
def test_fused_mix_matches_pallas(K, dtype):
    bits, m, rows = 4, 4, 32
    rng = np.random.default_rng(K)
    lvl = rng.integers(0, 256, (K, m, rows // 2, LANES), dtype=np.uint8)
    sign = rng.integers(0, 256, (K, m, rows // 8, LANES), dtype=np.uint8)
    js, ts = _pair(rng.standard_normal((m, rows, LANES)).astype(np.float32), dtype)
    ws = (rng.random((K, m)) * 0.1).astype(np.float32)
    jout = _jax(lambda *a: jfused.fused_mix_pallas(*a, bits, interpret=True),
                jnp.asarray(lvl), jnp.asarray(sign), js, jnp.asarray(ws))
    tout = kc.fused_mix(torch.from_numpy(lvl), torch.from_numpy(sign), ts, torch.from_numpy(ws),
                        bits)
    _equal(jout, tout)


def test_fused_mix_shifted_equals_rolled_payloads():
    """The round's launch reads the unrolled payload at node offsets: the
    same sum as the rolled signature, in place."""
    bits, m, rows = 2, 5, 64
    rng = np.random.default_rng(3)
    lvl = torch.from_numpy(rng.integers(0, 256, (m, rows // 4, LANES), dtype=np.uint8))
    sign = torch.from_numpy(rng.integers(0, 256, (m, rows // 8, LANES), dtype=np.uint8))
    s = torch.from_numpy(rng.standard_normal((m, rows, LANES)).astype(np.float32))
    shifts = [0, 1, -1, 2, -2]
    ws = torch.from_numpy(rng.random((len(shifts), m), dtype=np.float32))
    want = kc.fused_mix(torch.stack([torch.roll(lvl, k, 0) for k in shifts]),
                        torch.stack([torch.roll(sign, k, 0) for k in shifts]), s, ws, bits)
    got = kc.fused_mix_shifted(lvl, sign, s.clone(), ws, shifts, bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_round_leaf_matches_pallas_ragged(dtype, monkeypatch):
    """A ragged leaf (d = 3 x 700, padded to the grid) through the whole
    fused round, with the reference's per-node noise and norms handed over."""
    from repro.core.topology import ring as jring
    from repro_torch.core.topology import ring

    bits, m = 4, 4
    rng = np.random.default_rng(11)
    arrs = [(0.3 * rng.standard_normal((m, 3, 700))).astype(np.float32) for _ in range(3)]
    (jl, tl), (jh, th), (js, ts) = (_pair(a, dtype) for a in arrs)
    key = jax.random.PRNGKey(5)

    def reference(l, h, s_, k):
        return jfused.fused_round_leaf(l, h, s_, k, jring(m).shifts, 0.2, bits, interpret=True,
                                       with_digest=True)

    # the reference round is Python around jitted kernels: run it so in f32
    # (one program would let XLA contract the averaging step into an FMA),
    # and as one program with every bf16 operation rounded in bf16
    jout = _jax(reference, jl, jh, js, key) if dtype == "bfloat16" else reference(jl, jh, js, key)
    rows = ref._rows_for(2100, 8 // bits)
    xi = jax.vmap(lambda k: jax.random.uniform(k, (rows, LANES)))(jax.random.split(key, m))
    monkeypatch.setattr(kc, "node_norms", _jax_norms)
    tout = kc.fused_round_leaf(tl, th, ts, torch.from_numpy(np.array(xi)), ring(m).shifts, 0.2,
                               bits, with_digest=True)
    for j, t in zip(jout, tout):
        _equal(j, t)


def test_ops_quantize_ragged_matches_reference_ops(monkeypatch):
    """ops.quantize / dequantize pad a ragged tensor as the reference does;
    with the reference's noise and norms the payload is byte-equal."""
    bits, m = 4, 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, 37, 29)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), m)
    jp = [_jax(lambda a, k: jops.quantize(a, k, bits, interpret=True), jnp.asarray(x[i]), keys[i])
          for i in range(m)]
    rows = ref._rows_for(37 * 29, 8 // bits)
    xi = np.stack([np.asarray(jax.random.uniform(k, (rows, LANES))) for k in keys])
    monkeypatch.setattr(kc, "node_norms", _jax_norms)
    tp = ops.quantize(torch.from_numpy(x), torch.from_numpy(xi), bits)
    for i in range(m):
        for part in ("levels", "signs", "norm"):
            _equal(jp[i][part], tp[part][i])
    back = ops.dequantize(tp, (37, 29), torch.float32, bits)
    for i in range(m):
        _equal(_jax(lambda p: jops.dequantize(p, (37, 29), jnp.float32, bits, interpret=True),
                    jp[i]), back[i])


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which takes
    CUDA tensors only: it raises, it never runs the plain version."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kq.quantize(meta(64, LANES), meta(64, LANES), meta(1), 4)
    with pytest.raises(ValueError, match="CUDA"):
        kq.dequantize(meta(32, LANES, dtype=torch.uint8), meta(8, LANES, dtype=torch.uint8),
                      meta(1), 4)
    with pytest.raises(ValueError, match="CUDA"):
        kc.fused_encode(meta(2, 16, LANES), meta(2, 16, LANES), meta(2, 16, LANES), meta(2, 2), 4)
    with pytest.raises(ValueError, match="CUDA"):
        kc.fused_mix(meta(3, 2, 8, LANES, dtype=torch.uint8), meta(3, 2, 2, LANES, dtype=torch.uint8),
                     meta(2, 16, LANES), meta(3, 2), 4)
    assert _build.launch_counts() == before
