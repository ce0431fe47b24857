"""repro_torch's gradient tracking, local steps and microbatches against
the JAX trainer, on the CPU: reduced qwen3 (f32, 2 layers, d_model 64) on 4
ring nodes, 3 rounds, both lanes fed the reference's noise (the model lane
from the round's gossip key, the tracker lane from ``fold_in(key, 1)``):
GT at K 1 (``kq4b`` fused) and K 4 with a ``q2b`` tracker (packed);
AD-GDA with K 4 local steps and with 2 microbatches; and
``tracker=False`` equal to :class:`ChocoConsensus` bit for bit.

Tolerance: losses and lambda within 1e-5 relative, every theta and
model-lane theta_hat leaf within 1e-5 of its largest magnitude (f32 sums in
another order).  y, d_prev and the tracker lane's theta_hat are differences
of theta values (a K-step displacement, ~1e-2 of theta here), so their
rounding is theta's: each is held to 1e-5 of the matching theta leaf's
largest magnitude.  Bits exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.core import gossip, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.trainer import ChocoConsensus, GradientTrackingConsensus
from repro_torch.launch import steps as tsteps
from repro_torch.tree import leaves, unflatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

M, STEPS, REL = 4, 3, 1e-5


def _reference_noise(key, template, compressor):
    """{(leaf, None): xi [M, ...]} of a lane keyed ``key`` (no leaf is
    chunked at this size)."""
    flat = jax.tree_util.tree_leaves(template)
    out = {}
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        assert gossip._scan_plan(leaf.shape, int(np.prod(leaf.shape[1:])),
                                 gossip.BLOCK_SCAN_ELEMS) is None
        shape = compressor.noise_shape(M, leaf.shape[1:])
        if shape is not None:
            out[(li, None)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                        for nk in jax.random.split(k, M)])
    return out


def _strong_lam(jstate):
    """The reference's initial lambda is weakly typed and every later
    round's is not, so its jitted step would compile twice; a strong f32
    lambda (the same values) compiles it once."""
    return jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))


def _injected(xi):
    return lambda li, ci, shape: torch.from_numpy(xi[(li, ci)])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _run_both(local_steps=1, **kw):
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    jtr = jsteps.make_trainer(jcfg, M, local_steps=local_steps, **kw)
    ttr = tsteps.make_trainer(tcfg, M, local_steps=local_steps, device="cpu", **kw)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = unflatten(jparams, [torch.from_numpy(np.array(x))
                                  for x in jax.tree_util.tree_leaves(jparams)])
    rng = jax.random.PRNGKey(1)
    jstate, tstate = _strong_lam(jtr.init(jparams, rng)), ttr.init(tparams, seed=0)
    gt = kw.get("consensus") == "gt"
    tcomp = ttr.consensus._tracker_comp if gt else None
    stream = node_token_stream(M, 2 * local_steps * kw.get("microbatches", 1), 8,
                               jcfg.vocab_size, seed=0)
    for _ in range(STEPS):
        tokens = next(stream)
        keys = jax.random.split(jstate.rng, M + 2)
        model_xi = _reference_noise(keys[1], jstate.theta, ttr.compressor)
        noise = _injected(model_xi)
        if gt:
            noise = (noise, _injected(_reference_noise(jax.random.fold_in(keys[1], 1),
                                                       jstate.theta, tcomp)))
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)}, noise=noise)
        assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
        assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
        assert taux["bits_realized"] == pytest.approx(float(jaux["bits_realized"]), rel=1e-7)
    scale = [np.abs(np.asarray(a)).max() for a in jax.tree_util.tree_leaves(jstate.theta)]
    pairs = [(jstate.theta, tstate.theta, False)]
    if gt:
        pairs += [(jstate.consensus.model.theta_hat, tstate.consensus.model.theta_hat, False),
                  (jstate.consensus.y, tstate.consensus.y, True),
                  (jstate.consensus.d_prev, tstate.consensus.d_prev, True),
                  (jstate.consensus.tracker.theta_hat, tstate.consensus.tracker.theta_hat, True)]
    for ja, tb, displacement in pairs:
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(ja), leaves(tb))):
            bound = REL * (scale[i] if displacement else np.abs(np.asarray(a)).max())
            assert np.abs(b.numpy() - np.asarray(a)).max() <= bound
    assert ttr.bits_per_round(tstate) == jtr.bits_per_round(jstate)
    assert ttr.bits_per_round(tstate, per_iteration=True) == jtr.bits_per_round(
        jstate, per_iteration=True)
    return ttr, jtr, tstate, jstate


def test_gt_k1_fused_matches_reference():
    ttr, jtr, _, _ = _run_both(compressor="kq4b", fused_gossip=True, consensus="gt")
    assert str(ttr.consensus.wire_format) == str(jtr.consensus.wire_format)


def test_gt_k4_with_a_q2b_tracker_matches_reference():
    ttr, jtr, ts, js = _run_both(local_steps=4, compressor="kq4b", consensus="gt",
                                 tracker_compressor="q2b", momentum=0.9)
    assert ttr.consensus.bits_per_lane(ts.theta) == jtr.consensus.bits_per_lane(js.theta)
    assert str(ttr.consensus.wire_format) == str(jtr.consensus.wire_format)


def test_local_steps_match_reference():
    _run_both(local_steps=4, compressor="none", lr_decay=0.9)


def test_microbatches_match_reference():
    _run_both(compressor="kq4b", microbatches=2, momentum=0.5)


@pytest.mark.parametrize("fused", [False, True])
def test_tracker_off_is_choco_bit_for_bit(fused):
    m = 4
    base = {"w": torch.randn(m, 3000, generator=torch.Generator().manual_seed(0)),
            "b": torch.randn(m, 50, generator=torch.Generator().manual_seed(1))}
    outs = []
    for cons in (ChocoConsensus(topology.ring(m), make_compressor("kq4b"), fused=fused),
                 GradientTrackingConsensus(topology.ring(m), make_compressor("kq4b"),
                                           fused=fused, tracker=False)):
        theta = {k: v.clone() for k, v in base.items()}
        state = cons.init(theta)
        gen = torch.Generator().manual_seed(5)
        for _ in range(3):
            theta, state = cons.mix(theta, state, gen)
        outs.append(leaves(theta) + leaves(state.theta_hat) + leaves(state.s)
                    + [cons.bits_per_round(theta)])
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(*outs))


def test_gt_needs_theta_prev_and_a_gt_consensus():
    cons = GradientTrackingConsensus(topology.ring(4), make_compressor("kq4b"))
    theta = {"w": torch.zeros(4, 10)}
    with pytest.raises(ValueError, match="theta_prev"):
        cons.mix(theta, cons.init(theta), torch.Generator())
    with pytest.raises(ValueError, match="tracker_compressor only applies"):
        tsteps.make_trainer(torch_config("qwen3-1.7b").reduced(), 4, tracker_compressor="q2b",
                            device="cpu")
