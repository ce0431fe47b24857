"""repro_torch's baselines against the JAX package, on the CPU, ten nodes
and the reference benchmarks' logistic model: DR-DSGD (closed-form KL dual,
exact gossip; also on a time-varying wire with dropout), DRFA (K local
steps, sampled ascent, server averaging) with the reference's client
samples injected, over 3 rounds; ``kl_closed_form_weights``; the bits.

Tolerance: losses and lambda within 1e-5 relative, theta within 1e-5 of
its largest magnitude (f32 sums in another order); bits exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from benchmarks.common import logistic_init as jinit
from benchmarks.common import make_loss
from repro.core import DRDSGDConfig as JDRDSGDConfig
from repro.core import DRFAConfig as JDRFAConfig
from repro.core import drdsgd_trainer as jdrdsgd
from repro.core import drfa_trainer as jdrfa
from repro.core import dro as jdro
from repro.core import topology as jtopo
from repro.core import trainer as jtrainer
from repro.data import rotated_minority_classification
from repro.optim import make_schedule as jschedule
from repro.optim import sgd as jsgd
from repro_torch.core import DRDSGDConfig, DRFAConfig, drdsgd_trainer, drfa_trainer, dro
from repro_torch.core import topology, trainer
from repro_torch.launch.comparisons import logistic_apply, logistic_init, loss_fn
from repro_torch.optim import make_schedule, sgd
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

M, ROUNDS, REL = 10, 3, 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jloss():
    return make_loss(lambda p, x: x @ p["w"] + p["b"])


def _compare(jstate, tstate, jaux, taux):
    assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
    assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
    assert _rel(tstate.lam.numpy(), jstate.lam) <= REL
    for k in ("w", "b"):
        assert _rel(tstate.theta[k].numpy(), jstate.theta[k]) <= REL


def test_kl_closed_form_weights_match_reference():
    rng = np.random.default_rng(0)
    for alpha in (0.5, 6.0):
        losses = rng.random(M).astype(np.float32) * 3
        prior = rng.dirichlet(np.ones(M)).astype(np.float32)
        want = np.asarray(jdro.kl_closed_form_weights(jnp.asarray(losses), jnp.asarray(prior),
                                                      alpha))
        got = dro.kl_closed_form_weights(torch.from_numpy(losses), torch.from_numpy(prior),
                                         alpha).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_drdsgd_matches_reference():
    data = rotated_minority_classification(num_nodes=M, seed=0)
    kw = dict(num_nodes=M, topology="torus", alpha=6.0, eta_theta=0.3, lr_decay=0.99)
    jt = jdrdsgd(JDRDSGDConfig(**kw), _jloss())
    tt = drdsgd_trainer(DRDSGDConfig(**kw), loss_fn, device="cpu")
    js = jt.init(jinit(data.dim, data.num_classes), jax.random.PRNGKey(0))
    ts = tt.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    gen = data.batches(50, seed=0)
    for _ in range(ROUNDS):
        xb, yb = next(gen)
        js, ja = jt.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        ts, ta = tt.step(ts, (torch.from_numpy(xb), torch.from_numpy(yb)))
        _compare(js, ts, ja, ta)
        assert ta["bits_realized"] == float(ja["bits_realized"])
    assert tt.bits_per_round(ts) == jt.bits_per_round(js) == 8704.0


def test_exact_consensus_on_a_schedule_with_dropout_matches_reference():
    """DR-DSGD's composition over round-robin ring + torus with 30% dropout:
    the reference's masks injected (its key layout: next rng, mask key,
    node keys)."""
    data = rotated_minority_classification(num_nodes=M, seed=1)
    spec = "roundrobin:ring,torus"
    prior = np.full(M, 1.0 / M, np.float32)
    jsched = jschedule("exp", 0.3, decay=0.99)
    jt = jtrainer.DecentralizedTrainer(
        _jloss(), num_nodes=M,
        local=jtrainer.LocalUpdate(optimizer=jsgd(jsched, momentum=0.9), schedule=jsched),
        dual=jtrainer.KLClosedForm(prior=jnp.asarray(prior), alpha=6.0),
        consensus=jtrainer.ExactConsensus(jtopo.make_topology_schedule(spec, M, dropout=0.3)))
    tsched = make_schedule("exp", 0.3, decay=0.99)
    tt = trainer.DecentralizedTrainer(
        loss_fn, num_nodes=M,
        local=trainer.LocalUpdate(optimizer=sgd(tsched, momentum=0.9), schedule=tsched),
        dual=trainer.KLClosedForm(prior=prior, alpha=6.0),
        consensus=trainer.ExactConsensus(topology.make_topology_schedule(spec, M, dropout=0.3)),
        device="cpu")
    js = jt.init(jinit(data.dim, data.num_classes), jax.random.PRNGKey(4))
    ts = tt.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    gen = data.batches(50, seed=1)
    for _ in range(ROUNDS):
        xb, yb = next(gen)
        keys = jax.random.split(js.rng, M + 2)
        mask = np.asarray(jt.schedule.mask_at(keys[1], js.step))
        mu_before = ts.opt.mu[0].clone()
        js, ja = jt.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        ts, ta = tt.step(ts, (torch.from_numpy(xb), torch.from_numpy(yb)), mask=mask)
        _compare(js, ts, ja, ta)
        np.testing.assert_array_equal(ta["participation"].numpy(), np.asarray(ja["participation"]))
        dead = mask == 0
        assert dead.any() or ts.step < 2
        assert torch.equal(ts.opt.mu[0][dead], mu_before[dead])
        assert ta["bits_realized"] == pytest.approx(float(ja["bits_realized"]), rel=1e-7)
    for mode in ("max", "expected"):
        assert tt.bits_per_round(ts, mode=mode) == jt.bits_per_round(js, mode=mode)


def _reference_samples(js, num_sampled):
    """The reference DRFA round's client mask: its dual key is keys[1]."""
    keys = jax.random.split(js.rng, M + 2)
    u = jax.random.uniform(keys[1], (M,))
    scores = jnp.log(js.lam + 1e-20) - jnp.log(-jnp.log(u + 1e-20) + 1e-20)
    mask = np.zeros(M, np.float32)
    mask[np.asarray(jax.lax.top_k(scores, num_sampled)[1])] = 1.0
    return mask


@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_drfa_matches_reference(momentum):
    data = rotated_minority_classification(num_nodes=M, seed=0)
    k = 4
    kw = dict(num_nodes=M, participation=0.5, local_steps=k, eta_theta=0.3, eta_lambda=0.1,
              lr_decay=0.99, momentum=momentum)
    jt = jdrfa(JDRFAConfig(**kw), _jloss())
    tt = drfa_trainer(DRFAConfig(**kw), loss_fn, device="cpu")
    assert tt.federated and tt.consensus.num_sampled == 5
    js = jt.init(jinit(data.dim, data.num_classes), jax.random.PRNGKey(0))
    ts = tt.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    gen = data.batches(50 * k, seed=0)
    for _ in range(ROUNDS):
        xb, yb = next(gen)
        xb, yb = xb.reshape(M, k, -1, data.dim), yb.reshape(M, k, -1)
        sampled = _reference_samples(js, 5)
        js, ja = jt.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        ts, ta = tt.step(ts, (torch.from_numpy(xb), torch.from_numpy(yb)), sampled=sampled)
        _compare(js, ts, ja, ta)
        assert "consensus_err" not in ta and ts.theta["w"].shape == (data.dim, data.num_classes)
    assert tt.bits_per_round(ts) == jt.bits_per_round(js) == 2 * 5 * 68 * 32.0
    assert tt.bits_per_round(ts, per_iteration=True) == jt.bits_per_round(js, per_iteration=True)
    mean = tt.network_mean(ts)
    pred = logistic_apply(mean, torch.from_numpy(data.val_x[0])).argmax(-1)
    assert pred.shape == (len(data.val_y[0]),)


def test_drfa_draws_its_own_samples():
    """Without injection the sample is Gumbel top-k on the dual generator:
    |U| clients, a fresh draw each round, the same from the same seed."""
    data = rotated_minority_classification(num_nodes=M, seed=0)
    tt = drfa_trainer(DRFAConfig(num_nodes=M, local_steps=2), loss_fn, device="cpu")
    draws = []
    for _ in range(2):
        ts = tt.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=3)
        draws.append([tt.dual.begin(ts.lam, ts.dual_generator) for _ in range(4)])
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert all(float(d.sum()) == 5 for d in draws[0])
    assert len({tuple(d.tolist()) for d in draws[0]}) > 1
