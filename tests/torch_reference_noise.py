"""The reference trainer's quantization noise, for injection into the port.

JAX's threefry streams and torch's Philox streams differ, so a round-level
parity test draws the reference's uniforms and feeds them to the port's
``DecentralizedTrainer.step(..., noise=)``."""

import jax
import numpy as np

from repro_torch.core import gossip


def reference_noise(key, template, compressor, m: int) -> dict:
    """{(leaf, None): xi [m, ...]}: the reference's per-encode noise for a
    round whose gossip key is ``key``, over the node-stacked ``template``
    (no leaf may be chunked: the test's sizes keep every leaf whole)."""
    flat = jax.tree_util.tree_leaves(template)
    out = {}
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        assert gossip._scan_plan(leaf.shape, int(np.prod(leaf.shape[1:])),
                                 gossip.BLOCK_SCAN_ELEMS) is None
        shape = compressor.noise_shape(m, leaf.shape[1:])
        if shape is not None:
            out[(li, None)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                        for nk in jax.random.split(k, m)])
    return out
