"""repro_torch top-k compression against the JAX package, on the CPU: the
block top-k kernel's plain version against ``block_topk_pallas`` in
interpret mode, ``ops.block_topk`` on ragged and node-stacked shapes, the
``TopK`` / ``BlockTopK`` / ``KernelBlockTopK`` compressors, CHOCO rounds with
each, a reduced AD-GDA trainer on ``KernelBlockTopK``, and a quickstart-sized
logistic run on ``top10`` (the CUDA kernel against its plain version:
test_torch_cuda.py).

Tolerances.  Block top-k: none -- the mask is a threshold bisection of
adds, halvings and integer counts, so both sides keep the same elements and
write the same values.  The output is ``x * mask``: a dropped negative
element is ``-0.0`` in IEEE arithmetic, which the port and the reference's
eager oracle (``repro.kernels.ref.block_topk_ref``) write, equal bit for bit
(compared through int32).  XLA on the CPU compiles the Pallas kernel's
``x * convert(mask)`` into a select and writes ``+0.0`` there, so against
``block_topk_pallas(interpret=True)`` the values are held equal (``-0.0 ==
0.0``) and the kept elements identical.

``TopK`` / ``BlockTopK``: equal on tie-free inputs only -- ``jax.lax.top_k``
and ``torch.topk`` keep different elements among ties.

Rounds: the top-k compressors draw no noise, and f32 / bf16 element
operations round alike on both sides (the reference compiled with every bf16
operation rounded), so theta and theta_hat are held to 1e-6 of each leaf's
largest magnitude, and s too in f32.  A bf16 s may sit one bf16 step (2**-7
of the value) apart, or by f32 rounding where the neighbour sum cancels:
XLA contracts that f32 sum into FMAs before s rounds to bf16.  A bf16
residual ties magnitudes, so bf16 rounds of ``TopK`` / ``BlockTopK`` start
from fresh trackers on distinct magnitudes; block top-k on the bisection
keeps every tie on both sides and needs no such care.

Trainers: losses, lambda and theta to 1e-5 relative over 3 rounds, as the
trainer tests (matmul summation order, XLA's FMA contraction inside the
jitted step); the 40-round quickstart run's network mean to 1e-4 relative.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_config
from repro.core import ADGDAConfig as JADGDAConfig
from repro.core import adgda_trainer as jax_adgda
from repro.core import choco_sgd as jax_choco_sgd
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core.compression import make_compressor as jax_compressor
from repro.data import node_token_stream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk import block_topk_pallas
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.core import ADGDAConfig, BlockTopK, TopK, adgda_trainer, choco_sgd, gossip
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.data import rotated_minority_classification
from repro_torch.kernels import ops
from repro_torch.kernels import topk as ktopk
from repro_torch.kernels.ops import KernelBlockTopK
from repro_torch.launch import quickstart
from repro_torch.launch import steps as tsteps
from repro_torch.tree import leaves, unflatten

M = 4
REL = 1e-5
# 40 rounds compound the per-round summation-order differences (~1e-7)
QUICKSTART_REL = 1e-4


def _bits(x) -> np.ndarray:
    """f32 values as their int32 bits (so -0.0 != 0.0)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _rows(case: str):
    """(x [rows, block] f32, k) for one block top-k case."""
    rng = np.random.default_rng(len(case))
    if case == "random":
        return rng.standard_normal((6, 1024)).astype(np.float32), 256
    if case == "ties":  # few distinct magnitudes; row 0 ties its max 128 times
        x = rng.choice([-3, -2, -1, 1, 2, 3], (4, 256)).astype(np.float32)
        x[0, ::2] = 3.0
        return x, 100
    if case == "zero_row":
        x = rng.standard_normal((3, 128)).astype(np.float32)
        x[1] = 0.0
        return x, 32
    if case == "negative":  # every dropped element must come out as -0.0
        return -np.abs(rng.standard_normal((3, 128))).astype(np.float32), 16
    if case == "k1":
        return rng.standard_normal((2, 512)).astype(np.float32), 1
    if case == "k_block":
        return (rng.standard_normal((2, 256)) * 10.0 ** rng.integers(-8, 3, (2, 256))
                ).astype(np.float32), 256
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "ties", "zero_row", "negative", "k1", "k_block"])
def test_block_topk_plain_matches_pallas_bit_for_bit(case):
    x, k = _rows(case)
    want = np.asarray(block_topk_pallas(jnp.asarray(x), k, interpret=True))
    got = ktopk.block_topk(torch.from_numpy(x), k)  # CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_array_equal(_bits(got), _bits(jref.block_topk_ref(jnp.asarray(x), k)))
    kept = (got != 0).sum(1)
    if case == "ties":
        assert kept[0] == (np.abs(x[0]) == 3).sum() > k  # every element tied at the threshold
        assert bool((kept[1:] <= k).all())  # ties below it are dropped
    if case == "zero_row":
        assert bool((got[1] == 0).all())
    if case == "negative":
        assert bool(torch.signbit(got).all())


@pytest.mark.parametrize("shape,fraction,block", [
    ((3, 1000), 0.1, 256), ((7,), 0.5, 128), ((5, 33, 7), 0.25, 128), ((2, 640), 0.25, 1024),
])
def test_ops_block_topk_matches_reference_on_ragged_shapes(shape, fraction, block):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = jops.block_topk(jnp.asarray(x), fraction, block, interpret=True)
    got = ops.block_topk(torch.from_numpy(x)[None], fraction, block)[0]  # one node
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # node-stacked: each node padded on its own, as the reference's vmap
    stacked = ops.block_topk(torch.from_numpy(x), fraction, block)
    per_node = [np.asarray(jops.block_topk(jnp.asarray(r), fraction, block, interpret=True))
                for r in x]
    np.testing.assert_array_equal(stacked.numpy(), np.stack(per_node))


def test_ops_block_topk_keeps_the_leaf_dtype():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 300)).astype(np.float32))
    out = ops.block_topk(x.to(torch.bfloat16), 0.25, 128)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 300)
    want = ops.block_topk(x.to(torch.bfloat16).float(), 0.25, 128)
    assert torch.equal(out.float(), want)


@pytest.mark.parametrize("inner", [(40, 32), (37, 29)], ids=["whole_blocks", "ragged"])
@pytest.mark.parametrize("spec", ["top10", "btop25", "kernel"])
def test_topk_compressors_match_reference(spec, inner):
    """Payloads (values, indices) and decodes on a tie-free input.  A ragged
    input pads its last block with zeros, which tie: there only the decodes
    are compared (either side's choice among the zeros decodes alike)."""
    x = np.random.default_rng(7).standard_normal((M,) + inner).astype(np.float32)
    if spec == "kernel":
        jc, tc = jops.KernelBlockTopK(0.25, 256, interpret=True), KernelBlockTopK(0.25, 256)
    else:
        jc, tc = jax_compressor(spec), make_compressor(spec)
    jpay = jax.vmap(jc.encode)(jnp.asarray(x))
    tpay = tc.encode(torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(jpay), leaves(tpay)):
        assert b.dtype == (torch.int32 if np.asarray(a).dtype == np.int32 else torch.float32)
        if inner == (40, 32) or spec == "kernel":
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jdec = jax.vmap(lambda p: jc.decode(p, x.shape[1:], jnp.float32))(jpay)
    np.testing.assert_array_equal(tc.decode(tpay, x.shape[1:], torch.float32).numpy(),
                                  np.asarray(jdec))
    assert tc.noise_shape(M, x.shape[1:]) is None


@pytest.mark.parametrize("spec", ["top10", "btop25", "top0.5"])
def test_bits_delta_and_specs_match_reference(spec):
    jc, tc = jax_compressor(spec), make_compressor(spec)
    assert type(tc).__name__ == type(jc).__name__
    assert tc.delta == jc.delta
    for d in (1, 7, 1000, 1 << 24):
        assert tc.bits_per_element(d) == jc.bits_per_element(d)
    jk, tk = jops.KernelBlockTopK(0.25, 1024), KernelBlockTopK(0.25, 1024)
    assert tk.delta == jk.delta == 0.25
    assert tk.bits_per_element(4096) == jk.bits_per_element(4096) == (32 + math.log2(1024)) / 4
    assert isinstance(make_compressor("top10"), TopK)
    assert isinstance(make_compressor("btop25"), BlockTopK)


def _tree(m: int, seed: int, dtype, *, distinct=False, zeros=False):
    """A last-axis-chunked leaf ([m, 1000] -> 4 x 250 at BLOCK 256), a
    layer-stack leaf ([m, 3, 260] -> 3 x 1) and a small ragged one.
    ``distinct``: every node's magnitudes differ (bf16 values from 16
    binades); ``zeros``: all zero."""
    rng = np.random.default_rng(seed)
    pool = np.ldexp(1 + np.arange(128) / 128, np.arange(-8, 8)[:, None]).reshape(-1)

    def leaf(shape):
        if zeros:
            return np.zeros(shape, np.float32)
        if not distinct:
            return rng.standard_normal(shape).astype(np.float32)
        mags = np.stack([rng.choice(pool, int(np.prod(shape[1:])), replace=False)
                         for _ in range(shape[0])])
        return (mags * rng.choice([-1.0, 1.0], mags.shape)).reshape(shape).astype(np.float32)

    shapes = {"w": (m, 1000), "blocks": [{"b": (m, 3, 260)}], "z": (m, 7)}
    tree = jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("spec", ["top10", "btop25", "kernel"])
def test_choco_round_with_topk_matches_reference(spec, packed, dtype):
    jdt = jnp.dtype(dtype)
    fresh = dtype == "bfloat16" and spec != "kernel"
    theta = _tree(M, 0, jdt, distinct=fresh)
    hat, s = (_tree(M, seed, jdt, zeros=fresh) for seed in (1, 2))
    if spec == "kernel":
        jc, tc = jops.KernelBlockTopK(0.25, 128, interpret=True), KernelBlockTopK(0.25, 128)
    else:
        jc, tc = jax_compressor(spec), make_compressor(spec)
    def jround(th, st):
        return jg.choco_round(th, st, jtopo.ring(M), 0.2, jc, jax.random.PRNGKey(0),
                              packed=packed, block_scan_elems=256)

    args = (theta, jg.CHOCOState(theta_hat=hat, s=s))
    if dtype == "bfloat16":  # every bf16 operation rounded to bf16, as in PyTorch
        jt, js = jax.jit(jround).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    else:  # op by op: one program would contract the f32 averaging step into an FMA
        jt, js = jround(*args)

    def to_t(tree):
        return unflatten(tree, [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
                                for x in jax.tree_util.tree_leaves(tree)])

    state = gossip.CHOCOState(theta_hat=to_t(hat), s=to_t(s))
    tt, ts = gossip.choco_round(to_t(theta), state, topology.ring(M), 0.2, tc, packed=packed,
                                block_scan_elems=256)
    for name, a, b in (("theta", jt, tt), ("theta_hat", js.theta_hat, ts.theta_hat),
                       ("s", js.s, ts.s)):
        for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), leaves(b))):
            ref, got = np.asarray(x, np.float32), y.float().numpy()
            diff = np.abs(got - ref)
            atol = 1e-6 * np.abs(ref).max()
            if name == "s" and dtype == "bfloat16":
                step = 2.0**-7 * np.maximum(np.abs(ref), np.abs(got))
                assert (diff <= step + atol).all(), f"s leaf {i}"
            else:
                assert diff.max() <= atol, f"{name} leaf {i}"


def test_fused_gossip_refuses_topk():
    theta = {"w": torch.zeros(4, 300)}
    for comp in (make_compressor("top10"), make_compressor("btop25"), KernelBlockTopK()):
        with pytest.raises(ValueError, match="fused gossip needs"):
            gossip.choco_round(theta, gossip.choco_init(theta), topology.ring(4), 0.1, comp,
                               fused=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("spec", ["kernel", "top10"])
def test_reduced_trainer_with_topk_matches_reference(spec):
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    if spec == "kernel":
        jtr = jsteps.make_trainer(jcfg, M, compressor="btop25")
        jtr.consensus.compressor = jops.KernelBlockTopK(0.25, 1024, interpret=True)
        ttr = tsteps.make_trainer(tcfg, M, compressor=KernelBlockTopK(0.25, 1024), device="cpu")
    else:
        jtr = jsteps.make_trainer(jcfg, M, compressor=spec)
        ttr = tsteps.make_trainer(tcfg, M, compressor=spec, device="cpu")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = unflatten(jparams, [torch.from_numpy(np.array(x))
                                  for x in jax.tree_util.tree_leaves(jparams)])
    jstate = jtr.init(jparams, jax.random.PRNGKey(1))
    tstate = ttr.init(tparams, seed=0)
    assert ttr.gamma == jtr.gamma == 0.5 * ttr.compressor.delta
    stream = node_token_stream(M, 2, 8, jcfg.vocab_size, seed=0)
    for _ in range(3):
        tokens = next(stream)
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)})
        assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
        assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
        assert float(taux["consensus_err"]) == pytest.approx(float(jaux["consensus_err"]),
                                                            rel=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.theta), leaves(tstate.theta)):
        assert _rel(b.numpy(), a) <= REL
    assert ttr.bits_per_round(tstate) == jtr.bits_per_round(jstate)


def _jax_logistic_loss(params, batch, rng):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    logz = jax.nn.logsumexp(logits, axis=-1)
    return (logz - jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]).mean()


@pytest.mark.parametrize("robust", [True, False], ids=["adgda", "choco_sgd"])
def test_quickstart_sized_top10_run_matches_reference(robust):
    """The quickstart's experiment (10 nodes, ring, ``top10``) for 40 rounds."""
    steps = 40
    kw = dict(num_nodes=10, topology="ring", compressor="top10", alpha=0.05, eta_theta=0.3,
              eta_lambda=0.2, lr_decay=0.99)
    data = rotated_minority_classification(num_nodes=10, minority_nodes=2, seed=1)
    jtr = (jax_adgda if robust else jax_choco_sgd)(JADGDAConfig(**kw), _jax_logistic_loss)
    ttr = (adgda_trainer if robust else choco_sgd)(ADGDAConfig(**kw), quickstart.loss_fn,
                                                   device="cpu")
    jstate = jtr.init({"w": jnp.zeros((data.dim, data.num_classes)),
                       "b": jnp.zeros((data.num_classes,))}, jax.random.PRNGKey(0))
    tstate = ttr.init({"w": torch.zeros(data.dim, data.num_classes),
                       "b": torch.zeros(data.num_classes)}, seed=0)
    gen = data.batches(50, seed=0)
    for _ in range(steps):
        xb, yb = next(gen)
        jstate, _ = jtr.step(jstate, (jnp.asarray(xb), jnp.asarray(yb)))
        tstate, _ = ttr.step(tstate, (torch.from_numpy(xb), torch.from_numpy(yb)))
    jmean, tmean = jtr.network_mean(jstate), ttr.network_mean(tstate)
    for name in ("w", "b"):
        assert _rel(tmean[name].numpy(), jmean[name]) <= QUICKSTART_REL, name
    assert ttr.bits_per_round(tstate) == jtr.bits_per_round(jstate)
