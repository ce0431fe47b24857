"""Synthetic heterogeneous data (numpy, deterministic): the port's own copy
of the parts of ``repro.data.synthetic`` its trainer runs.  The same seeds
give byte-identical arrays.

* ``rotated_minority_classification`` -- minority nodes see a rotated view
  of the feature space (the quickstart's benchmark);
* ``node_token_stream`` -- per-node LM batches whose unigram distribution
  is node-skewed (one Zipf marginal, a vocabulary permutation per node).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HeterogeneousDataset", "node_token_stream", "rotated_minority_classification"]


@dataclasses.dataclass
class HeterogeneousDataset:
    """Per-node splits. x: [m, n, d]; y: [m, n] int labels. Plus held-out
    per-distribution validation sets for worst-case evaluation."""

    x: np.ndarray
    y: np.ndarray
    val_x: list[np.ndarray]  # one per latent distribution
    val_y: list[np.ndarray]
    val_names: list[str]

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    @property
    def num_classes(self) -> int:
        return int(max(y.max() for y in [self.y] + self.val_y)) + 1

    def batches(self, batch_size: int, seed: int = 0):
        """Infinite generator of per-node minibatches ([m, b, d], [m, b])."""
        rng = np.random.default_rng(seed)
        m, n, _ = self.x.shape
        while True:
            idx = rng.integers(0, n, size=(m, batch_size))
            xb = np.take_along_axis(self.x, idx[:, :, None], axis=1)
            yb = np.take_along_axis(self.y, idx, axis=1)
            yield xb, yb


def rotated_minority_classification(
    num_nodes: int = 10,
    num_classes: int = 4,
    dim: int = 16,
    n_per_node: int = 512,
    n_val: int = 512,
    minority_nodes: int = 2,
    rot_scale: float = 2.0,
    sep: float = 1.5,
    seed: int = 0,
) -> HeterogeneousDataset:
    """Minority nodes see a *rotated* view of the feature space, so no linear
    predictor fits both sub-populations: average-risk training sacrifices
    the minority while the DRO objective trades majority slack for minority
    accuracy."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * sep
    r = np.linalg.qr(np.eye(dim) + rot_scale * rng.normal(size=(dim, dim)) / np.sqrt(dim))[0]

    def sample(n, rotated):
        lab = rng.integers(0, num_classes, n)
        x = means[lab] + rng.normal(size=(n, dim))
        if rotated:
            x = x @ r.T
        return x.astype(np.float32), lab.astype(np.int32)

    xs, ys = [], []
    for i in range(num_nodes):
        x, lab = sample(n_per_node, rotated=i < minority_nodes)
        xs.append(x)
        ys.append(lab)
    val_x, val_y, names = [], [], []
    for name, rot in (("majority", False), ("minority", True)):
        x, lab = sample(n_val, rot)
        val_x.append(x)
        val_y.append(lab)
        names.append(name)
    return HeterogeneousDataset(np.stack(xs), np.stack(ys), val_x, val_y, names)


def node_token_stream(
    num_nodes: int,
    batch_per_node: int,
    seq_len: int,
    vocab_size: int,
    zipf_a: float = 1.2,
    seed: int = 0,
):
    """Infinite per-node LM batches [m, b, S] int32 with node-skewed unigram
    stats.  Tokens are ``perms[node, base]``: the reference gathers the same
    entries from a [m, b, S, V] repeat of the permutations (2.5 GB a batch at
    qwen3-1.7b's vocabulary); the RNG calls are the same, in the same order."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    perms = np.stack([rng.permutation(vocab_size) for _ in range(num_nodes)])
    node = np.arange(num_nodes)[:, None, None]
    while True:
        base = rng.choice(vocab_size, size=(num_nodes, batch_per_node, seq_len), p=probs)
        yield perms[node, base].astype(np.int32)
