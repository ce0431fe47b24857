"""Synthetic heterogeneous data (numpy, deterministic): the port's own copy
of the parts of ``repro.data.synthetic`` its trainer runs.  The same seeds
give byte-identical arrays.

* ``class_shard_classification`` -- node i holds class i mod C only;
* ``contrast_shift_classification`` -- a few nodes see a nonlinear contrast
  change (the CIFAR-contrast analogue);
* ``instrument_shift_classification`` -- minority nodes see the features
  through a second "microscope" (the COOS7 analogue);
* ``rotated_minority_classification`` -- minority nodes see a rotated view
  of the feature space (the quickstart's benchmark);
* ``node_token_stream`` -- per-node LM batches whose unigram distribution
  is node-skewed (one Zipf marginal, a vocabulary permutation per node).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HeterogeneousDataset",
    "class_shard_classification",
    "contrast_shift_classification",
    "instrument_shift_classification",
    "node_token_stream",
    "rotated_minority_classification",
]


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


def class_shard_classification(
    num_nodes: int = 10,
    num_classes: int | None = None,
    dim: int = 32,
    n_per_node: int = 512,
    n_val: int = 512,
    sep: float = 1.8,
    seed: int = 0,
) -> HeterogeneousDataset:
    """Node i stores samples of class (i mod C) only (paper §5.1 class split)."""
    num_classes = num_classes or num_nodes
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * sep
    xs, ys = [], []
    for i in range(num_nodes):
        c = i % num_classes
        x = means[c] + rng.normal(size=(n_per_node, dim))
        xs.append(x.astype(np.float32))
        ys.append(np.full((n_per_node,), c, np.int32))
    val_x, val_y, names = [], [], []
    for c in range(num_classes):
        x = means[c] + rng.normal(size=(n_val, dim))
        val_x.append(x.astype(np.float32))
        val_y.append(np.full((n_val,), c, np.int32))
        names.append(f"class_{c}")
    return HeterogeneousDataset(np.stack(xs), np.stack(ys), val_x, val_y, names)


def _contrast(x: np.ndarray, c: float) -> np.ndarray:
    """Paper eq. (11) analog on standardized features: nonlinear contrast."""
    z = c * x
    return np.sign(z) * np.abs(z) ** 1.1


def contrast_shift_classification(
    num_nodes: int = 20,
    num_classes: int = 10,
    dim: int = 32,
    n_per_node: int = 512,
    n_val: int = 512,
    low_nodes: int = 2,
    high_nodes: int = 2,
    sep: float = 1.5,
    seed: int = 0,
) -> HeterogeneousDataset:
    """CIFAR-contrast analog: a few nodes see c=0.5 / c=1.5 transformed data."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * sep
    contrasts = [0.5] * low_nodes + [1.5] * high_nodes + [1.0] * (num_nodes - low_nodes - high_nodes)
    xs, ys = [], []
    for i in range(num_nodes):
        labels = rng.integers(0, num_classes, n_per_node)
        x = means[labels] + rng.normal(size=(n_per_node, dim))
        xs.append(_contrast(x, contrasts[i]).astype(np.float32))
        ys.append(labels.astype(np.int32))
    val_x, val_y, names = [], [], []
    for cname, c in (("low_contrast", 0.5), ("high_contrast", 1.5), ("original", 1.0)):
        labels = rng.integers(0, num_classes, n_val)
        x = means[labels] + rng.normal(size=(n_val, dim))
        val_x.append(_contrast(x, c).astype(np.float32))
        val_y.append(labels.astype(np.int32))
        names.append(cname)
    return HeterogeneousDataset(np.stack(xs), np.stack(ys), val_x, val_y, names)


def instrument_shift_classification(
    num_nodes: int = 10,
    num_classes: int = 7,
    dim: int = 32,
    n_per_node: int = 512,
    n_val: int = 512,
    minority_nodes: int = 2,
    sep: float = 1.5,
    seed: int = 0,
) -> HeterogeneousDataset:
    """COOS7 analog: minority nodes sample via a different 'microscope'
    (a fixed random linear distortion + offset of the features)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * sep
    # instrument 2: fixed rotation-ish distortion + bias
    a = rng.normal(size=(dim, dim)) * (0.4 / np.sqrt(dim))
    distort = np.eye(dim) + a
    offset = rng.normal(size=(dim,)) * 0.8

    def instrument2(x):
        return x @ distort.T + offset

    xs, ys = [], []
    for i in range(num_nodes):
        labels = rng.integers(0, num_classes, n_per_node)
        x = means[labels] + rng.normal(size=(n_per_node, dim))
        if i < minority_nodes:
            x = instrument2(x)
        xs.append(x.astype(np.float32))
        ys.append(labels.astype(np.int32))
    val_x, val_y, names = [], [], []
    for name, fn in (("microscope_1", lambda x: x), ("microscope_2", instrument2)):
        labels = rng.integers(0, num_classes, n_val)
        x = means[labels] + rng.normal(size=(n_val, dim))
        val_x.append(fn(x).astype(np.float32))
        val_y.append(labels.astype(np.int32))
        names.append(name)
    return HeterogeneousDataset(np.stack(xs), np.stack(ys), val_x, val_y, names)


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
