"""repro_torch's Mamba2 SSD mixer (``models/ssm.py``) against
``repro.models.ssm``.

Reduced mamba2-1.3b widths (d 256, inner 512, 16 heads of 32, state 32,
chunk 32) in f32, JAX-initialised weights, numpy inputs from a seed.
Tolerances: outputs and the final ``{ssm, conv}`` state to ``1e-4``
relative (atol 1e-5; f32, the chunk products summed in another order), the
decode steps after a prefill the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro_torch.configs import get_config as torch_config
from repro_torch.models import ssm as TS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seed=0, **kw):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(torch_config(ARCH).reduced(), **kw)
    jp = JS.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _x(B, S, d, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("chunks", [1, 3, 0.5])
def test_scan_matches_jax(chunks):
    """S = chunk, 3 chunks, and S < chunk (one chunk of S)."""
    jcfg, tcfg, jp, tp = _setup()
    S = int(jcfg.ssm_chunk * chunks)
    x = _x(2, S, jcfg.d_model)
    jy, js = JS.mamba2_scan(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, ts = TS.mamba2_scan(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]), **TOL)
    assert ts["ssm"].dtype == torch.float32 and set(ts) == {"ssm", "conv"}
    assert TS.mamba2_scan(tp, torch.from_numpy(x), tcfg, return_state=False)[1] is None


def test_decode_after_prefill_matches_jax():
    """Prefill 2 chunks, then 6 one-token steps on both sides; the state
    carried by the port's in-place cache equals the reference's."""
    jcfg, tcfg, jp, tp = _setup(seed=2)
    S = 2 * jcfg.ssm_chunk
    x = _x(3, S + 6, jcfg.d_model, seed=4)
    _, js = JS.mamba2_scan(jp, jnp.asarray(x[:, :S]), jcfg)
    _, ts = TS.mamba2_scan(tp, torch.from_numpy(x[:, :S]), tcfg)
    cache = TS.init_mamba2_cache(tcfg, 3, "cpu")
    for name in cache:
        cache[name].copy_(ts[name])
    for i in range(6):
        xi = x[:, S + i:S + i + 1]
        jy, js = JS.decode_mamba2(jp, jnp.asarray(xi), js, jcfg)
        ty, cache = TS.decode_mamba2(tp, torch.from_numpy(xi), cache, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(js[name]), **TOL)


def test_decode_continues_the_scan():
    """Within the port: prefill + decode steps equal one scan over the
    extended sequence (the continuation phase 14 holds at full width)."""
    _, tcfg, _, tp = _setup(seed=5)
    L = tcfg.ssm_chunk
    x = torch.from_numpy(_x(2, 2 * L, tcfg.d_model, seed=6))
    full, _ = TS.mamba2_scan(tp, x, tcfg)
    _, st = TS.mamba2_scan(tp, x[:, :L], tcfg)
    cache = TS.init_mamba2_cache(tcfg, 2, "cpu")
    for name in cache:
        cache[name].copy_(st[name])
    steps = [TS.decode_mamba2(tp, x[:, L + i:L + i + 1], cache, tcfg)[0] for i in range(L)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, L:].numpy(), **TOL)


def test_masked_decay_has_no_nan():
    """A large step size makes exp of the decay's upper triangle overflow:
    masking after exp would give inf * 0 = NaN there.  The scan masks
    before exp, as the reference does, and stays finite and equal to it."""
    jcfg, tcfg, jp, tp = _setup(seed=3)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 60.0))
    tp = dict(tp, dt_bias=torch.full_like(tp["dt_bias"], 60.0))
    x = _x(1, jcfg.ssm_chunk, jcfg.d_model, seed=8, scale=3.0)
    cum = torch.cumsum(torch.full((jcfg.ssm_chunk,), -60.0), 0)
    assert torch.isinf(torch.exp(cum[None, :] - cum[:, None])).any()  # the upper triangle overflows
    ty, ts = TS.mamba2_scan(tp, torch.from_numpy(x), tcfg)
    jy, js = JS.mamba2_scan(jp, jnp.asarray(x), jcfg)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(ts["ssm"]).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_scan_refuses_a_partial_chunk():
    _, tcfg, _, tp = _setup()
    with pytest.raises(ValueError, match="divisible by ssm chunk"):
        TS.mamba2_scan(tp, torch.zeros(1, tcfg.ssm_chunk + 3, tcfg.d_model), tcfg)


def test_apply_mamba2_matches_jax():
    """``apply_mamba2``: the scan's output alone, as the reference's."""
    jcfg, tcfg, jp, tp = _setup(seed=6)
    x = _x(2, 2 * jcfg.ssm_chunk, jcfg.d_model, seed=9)
    ty = TS.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(JS.apply_mamba2(jp, jnp.asarray(x), jcfg)),
                               **TOL)


@pytest.mark.parametrize("chunks", [1, 2])
def test_scan_from_an_initial_state_matches_jax(chunks):
    """``init_state``: a non-zero SSM state entering the first chunk (the
    conv still starts from zeros, on both sides)."""
    jcfg, tcfg, jp, tp = _setup(seed=7)
    x = _x(2, chunks * jcfg.ssm_chunk, jcfg.d_model, seed=10)
    _, H, N, _ = TS.dims(tcfg)
    h0 = _x(2, H, tcfg.ssm_head_dim * N, seed=11, scale=0.5).reshape(2, H, tcfg.ssm_head_dim, N)
    jy, js = JS.mamba2_scan(jp, jnp.asarray(x), jcfg, init_state=jnp.asarray(h0))
    ty, ts = TS.mamba2_scan(tp, torch.from_numpy(x), tcfg, init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts["ssm"].numpy(), np.asarray(js["ssm"]), **TOL)
    zero, _ = TS.mamba2_scan(tp, torch.from_numpy(x), tcfg)
    assert not torch.allclose(ty, zero)  # the state did enter
