"""repro_torch's RG-LRU block against ``repro.models.rglru`` on the same
weights and inputs.

Reduced recurrentgemma-2b (d 256, f32); JAX-initialised parameters, numpy
inputs from a seed.  Tolerance: rel 1e-5 (atol 1e-6 for values near zero):
the same f32 math, with the scan associated differently (Hillis-Steele
against ``jax.lax.associative_scan``).  The parallel scan equals the
sequential decode as the reference's own test holds it (atol 1e-4, rtol
1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rglru as JR
from repro_torch.configs import get_config as torch_config
from repro_torch.models import rglru as TR

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def block():
    jcfg = jax_config("recurrentgemma-2b").reduced()
    tcfg = torch_config("recurrentgemma-2b").reduced()
    jp = JR.init_rglru(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_params_keep_reference_dtypes():
    cfg = torch_config("recurrentgemma-2b").reduced()
    p = TR.init_rglru(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = JR.init_rglru(jax.random.PRNGKey(0), jax_config("recurrentgemma-2b").reduced())
    assert set(p) == set(ref)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == leaf.shape, name
        assert str(p[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert p["lamb"].dtype == torch.float32 and bool((p["lamb"] == 0.65).all())
    cache = TR.init_rglru_cache(cfg, 3, "cpu")
    assert cache["h"].dtype == torch.float32 and cache["h"].shape == (3, cfg.rglru_width)
    assert cache["conv"].shape == (3, TR.CONV_WIDTH - 1, cfg.rglru_width)


@pytest.mark.parametrize("S", [1, 2, 5, 12, 33])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_scan_matches_jax(block, S, with_state):
    """h at every position and the final state, from zero or a given state;
    lengths around the scan's powers of two."""
    _, _, jp, tp = block
    dr = jp["w_a"].shape[0]
    u = _x((2, S, dr), S)
    h0 = _x((2, dr), 100 + S) if with_state else None
    jh, jfinal = JR.rglru_scan(jp, jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    th, tfinal = TR.rglru_scan(tp, torch.from_numpy(u),
                               None if h0 is None else torch.from_numpy(h0))
    assert tfinal.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), **TOL)


@pytest.mark.parametrize("S", [3, 12, 20])
def test_apply_rglru_matches_jax(block, S):
    """The block's output and its decode state {h, conv} after the prompt."""
    jcfg, tcfg, jp, tp = block
    x = _x((2, S, jcfg.d_model), S)
    jy, jst = JR.apply_rglru(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TR.apply_rglru(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), **TOL)
    init = {"h": jst["h"]}
    jy2 = JR.apply_rglru(jp, jnp.asarray(x), jcfg, init_state=init)
    ty2 = TR.apply_rglru(tp, torch.from_numpy(x), tcfg, init_state={"h": tst["h"]})
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), **TOL)


def test_decode_rglru_matches_jax(block):
    """Eight decode steps from a primed state: outputs and the state."""
    jcfg, tcfg, jp, tp = block
    x = _x((2, 14, jcfg.d_model), 7)
    _, jc = JR.apply_rglru(jp, jnp.asarray(x[:, :6]), jcfg, return_state=True)
    _, tc = TR.apply_rglru(tp, torch.from_numpy(x[:, :6]), tcfg, return_state=True)
    for i in range(6, 14):
        jy, jc = JR.decode_rglru(jp, jnp.asarray(x[:, i:i + 1]), jc, jcfg)
        ty, tc = TR.decode_rglru(tp, torch.from_numpy(x[:, i:i + 1]), tc, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_rglru_scan_equals_sequential(block):
    """As the reference's own test: the parallel scan over 12 tokens equals 12
    decode steps from an empty cache, outputs and final state."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x((2, 12, tcfg.d_model), 0))
    y_par, st = TR.apply_rglru(tp, x, tcfg, return_state=True)
    cache = TR.init_rglru_cache(tcfg, 2, "cpu")
    ys = []
    for i in range(12):
        y, cache = TR.decode_rglru(tp, x[:, i:i + 1], cache, tcfg)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st["h"].numpy(), cache["h"].numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st["conv"].numpy(), cache["conv"].numpy(), atol=1e-6)
