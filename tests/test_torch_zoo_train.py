"""Training the zoo's other families in repro_torch against the JAX trainer,
on the CPU: the MoE deepseek-moe-16b, the Mamba2 SSD mamba2-1.3b, the
RG-LRU hybrid recurrentgemma-2b, the VLM internvl2-2b (``patches``) and the
encoder-decoder whisper-small (``frames``).

Reduced widths (``cfg.reduced()``, f32; the hybrid at 3 layers, so that it
covers ``rglru`` and ``local_attn``), JAX-initialised weights, the same
numpy tokens from ``node_token_stream`` on both sides.

- The batch: the port CLI's ``make_batch`` gives the reference CLI's keys,
  shapes, dtypes and zeros (the reference's batch captured from its own
  ``main``).
- Trainer rounds: 2 nodes on a ring, 2 rounds of ``make_trainer`` + ``step``
  with ``frames`` / ``patches`` N(0, 0.02²) from numpy; ``none`` on every
  arch, ``kq4b`` fused on deepseek-moe-16b and mamba2-1.3b with the port fed
  the reference's quantization noise.  Losses and lambda to 1e-5 relative,
  every theta leaf to 1e-5 of its largest magnitude, the consensus error to
  1e-4 relative, bits exact: the bounds of ``tests/test_torch_trainer.py``
  (summation order and XLA's FMA contraction inside the jitted step), theta
  after every round.  The MoE's routing agrees at this seed; a flipped
  expert would show as a loss far outside the bound.  Two leaves are held
  otherwise, each for a reason of arithmetic:

  - whisper's cross-attention key bias ``cross.bk`` has a zero gradient in
    exact arithmetic (a softmax over every encoder position does not move
    when ``q·b`` is added to all its scores), so both sides hold rounding
    noise there, ~1e-10: each must stay below 1e-8.
  - mamba2's weights after round 1 are held to 1e-3 of each leaf's largest
    magnitude (after round 0, 1e-5).  The SSD's intra-chunk decay is
    ``exp(cum_t - cum_s)`` of a cumulative sum, and XLA and torch sum a
    cumsum in different orders (they differ by ~1e-4 at 256 terms), so at
    the same weights the two gradients agree to ~1e-5 relative on every
    leaf (the other families: ~1e-6).  Round 1's gradient is then taken at
    weights ~1e-5 apart, and it moves the bias-like leaves (``conv_b``,
    ``A_log``) by up to ~4e-4 of their size.
- The CLI: the port's ``launch/train.py`` against the reference's on
  internvl2-2b and whisper-small with ``--compressor none``, 2 rounds, the
  port given the reference's initial tree; the ``--metrics-out`` files to
  the same bounds.  Whisper's run is the reference's zero-frame batch:
  its encoder LayerNorm over constant rows divides by ``sqrt(eps)``, the
  gradients pass 1e8 and the consensus error ~1e20 (the port's
  ``launch/train.py`` docstring), and the two sides still agree to the
  bounds at this size.
- The zero stubs themselves: whisper's gradients past 1e8 at reduced
  width, internvl2's not finite at its 24 layers, on both sides; the
  N(0, 0.02²) stubs keep both below 10.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves
from torch_reference_noise import reference_noise
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("deepseek-moe-16b", "mamba2-1.3b", "recurrentgemma-2b", "internvl2-2b",
            "whisper-small")
M, STEPS, B, S = 2, 2, 2, 32  # S: one reduced mamba2 chunk, past internvl2's 8 patches
REL = 1e-5
ERR_REL = 1e-4
SSD_LATER_REL = 1e-3  # mamba2's theta after round 1 (the module docstring)
ZERO_GRAD_LEAVES = ("['cross']['bk']",)  # 0 in exact arithmetic: both sides stay below 1e-8


def _layers(arch):
    return 3 if jax_config(arch).family == "hybrid" else 2


def _cfgs(arch):
    n = _layers(arch)
    return jax_config(arch).reduced(layers=n), torch_config(arch).reduced(layers=n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _stubs(cfg, rng):
    """The modality inputs over the node axis, N(0, 0.02²): [M, B, n, d]."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal((M, B, cfg.encoder_context, cfg.d_model))
                         * 0.02).astype(np.float32)
    if cfg.num_patches > 0:
        out["patches"] = (rng.standard_normal((M, B, cfg.num_patches, cfg.d_model))
                          * 0.02).astype(np.float32)
    return out


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("arch,spec", [(a, "none") for a in FAMILIES]
                         + [("deepseek-moe-16b", "kq4b"), ("mamba2-1.3b", "kq4b")])
def test_trainer_rounds_match_reference(arch, spec):
    jcfg, tcfg = _cfgs(arch)
    fused = spec == "kq4b"
    kw = dict(compressor=spec, fused_gossip=fused)
    jtr = jsteps.make_trainer(jcfg, M, **kw)
    ttr = tsteps.make_trainer(tcfg, M, device="cpu", **kw)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    rng = jax.random.PRNGKey(1)
    jstate = jtr.init(jparams, rng)
    # a strong f32 lambda (the same values): the jitted step compiles once
    jstate = jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))
    tstate = ttr.init(_to_torch(jparams), seed=0)
    assert ttr.gamma == pytest.approx(jtr.gamma, rel=1e-12)
    stream = node_token_stream(M, B, S, jcfg.vocab_size, seed=0)
    stubs = np.random.default_rng(7)
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jstate.theta)[0]]
    for r in range(STEPS):
        batch = {"tokens": next(stream), **_stubs(jcfg, stubs)}
        noise = None
        if fused:
            # the reference's round key: split(rng, m + 2) -> (next rng, gossip key, ...)
            keys = jax.random.split(rng, M + 2)
            rng = keys[0]
            xi = reference_noise(keys[1], jstate.theta, ttr.compressor, M)
            noise = lambda li, ci, shape, xi=xi: torch.from_numpy(xi[(li, ci)])
        jstate, jaux = jtr.step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, taux = ttr.step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                noise=noise)
        assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
        assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
        assert float(taux["consensus_err"]) == pytest.approx(float(jaux["consensus_err"]),
                                                            rel=ERR_REL)
        bound = SSD_LATER_REL if jcfg.ssm_state and r > 0 else REL
        for name, a, b in zip(names, jax.tree_util.tree_leaves(jstate.theta),
                              leaves(tstate.theta)):
            assert b.dtype == torch.float32
            if name.endswith(ZERO_GRAD_LEAVES):
                assert max(float(np.abs(np.asarray(a)).max()), float(b.abs().max())) < 1e-8
            else:
                assert _rel(b.numpy(), a) <= bound, (r, name)
    assert ttr.bits_per_round(tstate) == jtr.bits_per_round(jstate)


# ------------------------------------------------------------------ the CLI
CLI = ["--reduced", "--nodes", str(M), "--batch-per-node", "2", "--seq", "16", "--steps",
       str(STEPS), "--compressor", "none"]
CLI_ARCHS = ("internvl2-2b", "whisper-small")
_REFERENCE_RUNS: dict = {}


def _reference_cli(arch, tmp_path_factory, monkeypatch_ctx):
    """The reference CLI's metrics file and the batches its trainer was given
    (captured by wrapping its ``make_trainer``), once per arch."""
    if arch not in _REFERENCE_RUNS:
        out = tmp_path_factory.mktemp("jax") / "jax.json"
        batches = []
        make = jsteps.make_trainer

        def recording(*a, **kw):
            tr = make(*a, **kw)
            step = tr.step

            def record(state, batch):
                batches.append(jax.tree.map(np.asarray, batch))
                return step(state, batch)

            tr.step = record
            return tr

        with monkeypatch_ctx() as mp:
            mp.setattr(jtrain.st, "make_trainer", recording)
            mp.setattr(sys, "argv", ["train", "--arch", arch, *CLI, "--metrics-out", str(out)])
            jtrain.main()
        _REFERENCE_RUNS[arch] = json.loads(out.read_text()), batches
    return _REFERENCE_RUNS[arch]


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_make_batch_is_the_reference_clis_batch(arch, tmp_path_factory):
    """Keys, shapes, dtypes and values of every round's batch: the tokens
    from the stream, all-zero f32 ``frames`` / ``patches``."""
    _, batches = _reference_cli(arch, tmp_path_factory, pytest.MonkeyPatch.context)
    cfg = torch_config(arch).reduced()
    stream = node_token_stream(M, 2, 16, cfg.vocab_size, seed=0)
    assert len(batches) == STEPS
    for want in batches:
        got = ttrain.make_batch(torch.from_numpy(next(stream)), cfg, 2, "cpu")
        assert set(got) == set(want) == {"tokens", "frames" if cfg.is_encdec else "patches"}
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        extra = got["frames" if cfg.is_encdec else "patches"]
        assert extra.dtype == torch.float32 and not extra.any()


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_train_cli_matches_reference_cli(arch, tmp_path, tmp_path_factory, monkeypatch):
    """The port's CLI from the reference's initial tree against the
    reference CLI: the metrics file's losses, worst loss and consensus
    error."""
    want, _ = _reference_cli(arch, tmp_path_factory, pytest.MonkeyPatch.context)
    jcfg = jax_config(arch).reduced()
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(ttrain.T, "init_train_params",
                        lambda cfg, seed=0, device="cpu": _to_torch(jparams))
    out = tmp_path / "torch.json"
    res = ttrain.main(["--arch", arch, *CLI, "--device", "cpu", "--metrics-out", str(out)])
    got = json.loads(out.read_text())
    assert set(got) == set(want) and got["final_step"] == want["final_step"] == STEPS
    assert len(res["history"]) == STEPS
    assert _rel(got["losses"], want["losses"]) <= REL
    assert got["worst_loss"] == pytest.approx(want["worst_loss"], rel=REL)
    assert got["consensus_err"] == pytest.approx(want["consensus_err"], rel=ERR_REL)


# ------------------------------------------------- the reference's zero stubs
@pytest.mark.parametrize("arch,layers", [("whisper-small", 2), ("internvl2-2b", 24)])
def test_zero_stubs_overflow_the_gradient_on_both_sides(arch, layers):
    """Why ``chip_smoke.py`` phase 19 trains on N(0, 0.02²) stubs and the
    CLI keeps the reference's zeros only for parity: a norm over a constant
    row divides by ``sqrt(eps)``.  Whisper's encoder LayerNorm of zero
    frames gives gradients past 1e8 at reduced width (f32), and internvl2's
    RMSNorm of zero patch rows a non-finite gradient at its 24 layers; the
    stubs keep both below 10.  The port and the reference agree on each."""
    jcfg = jax_config(arch).reduced(layers=layers)
    tcfg = torch_config(arch).reduced(layers=layers)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    toks = next(node_token_stream(1, B, S, jcfg.vocab_size, seed=0))[0]
    zero = {k: np.zeros_like(v[0]) for k, v in _stubs(jcfg, np.random.default_rng(0)).items()}
    stub = {k: v[0] for k, v in _stubs(jcfg, np.random.default_rng(1)).items()}
    for extra, blown in ((zero, True), (stub, False)):
        jg = jax.grad(JT.lm_loss)(jparams, {"tokens": jnp.asarray(toks),
                                            **{k: jnp.asarray(v) for k, v in extra.items()}},
                                  jcfg)
        tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jparams)
        TT.lm_loss(tree, {"tokens": torch.from_numpy(toks),
                          **{k: torch.from_numpy(v) for k, v in extra.items()}}, tcfg).backward()
        tg = [t.grad for t in leaves(tree)]
        for g in ([np.asarray(x) for x in jax.tree_util.tree_leaves(jg)],
                  [x.numpy() for x in tg]):
            finite = all(np.isfinite(x).all() for x in g)
            top = max(float(np.abs(x).max()) for x in g) if finite else float("inf")
            assert (top > 1e8) == blown and (top < 10) == (not blown), (arch, blown, top)
