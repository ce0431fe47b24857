"""Communication topologies and mixing matrices for decentralized gossip
(static part of ``repro.core.topology``; numpy, identical ``W`` and shifts).

The paper (Assumption 3.1) requires a symmetric, doubly-stochastic mixing
matrix W with spectral gap rho = 1 - |lambda_2(W)| in (0, 1].  Circulant
graphs (ring, torus, mesh) also carry their *shift structure*: the mixing
``sum_j w_ij x_j`` is ``sum_k weight_k * roll(x, shift_k)`` along the node
axis.  Time-varying schedules and node dropout are not yet ported (see
ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "Topology",
    "ring",
    "torus_2d",
    "mesh",
    "star",
    "erdos_renyi",
    "metropolis_weights",
    "spectral_gap",
    "make_topology",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip communication topology.

    Attributes:
      name: human-readable identifier.
      adjacency: [m, m] 0/1 numpy array (with self-loops on the diagonal).
      mixing: [m, m] symmetric doubly-stochastic numpy array.
      shifts: optional circulant decomposition -- (shift, weight) pairs with
        ``sum_j w_ij x_j == sum_k weight_k * roll(x, shift_k)`` along the
        node axis; ``None`` when the graph is not circulant.
    """

    name: str
    adjacency: np.ndarray
    mixing: np.ndarray
    shifts: tuple[tuple[int, float], ...] | None = None

    @property
    def num_nodes(self) -> int:
        return self.mixing.shape[0]

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.mixing)

    @property
    def beta(self) -> float:
        """beta = ||I - W||_2 as in Assumption 3.1."""
        m = self.mixing.shape[0]
        return float(np.linalg.norm(np.eye(m) - self.mixing, ord=2))

    @property
    def max_degree(self) -> int:
        """Max number of neighbors (excluding self) -- the 'busiest node'."""
        return int((self.adjacency - np.eye(self.num_nodes)).sum(axis=1).max())

    def consensus_step_size(self, delta: float) -> float:
        """Theorem 4.1/4.3 consensus step size gamma for compression factor delta."""
        return _theorem_gamma(self.spectral_gap, self.beta, delta)


def spectral_gap(w: np.ndarray) -> float:
    """rho = 1 - |lambda_2|: gap between the two largest eigenvalue moduli."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(1.0 - eig[1]) if eig.shape[0] > 1 else 1.0


def _theorem_gamma(rho: float, beta: float, delta: float) -> float:
    """Theorem 4.1/4.3 gamma from spectral gap rho and beta = ||I - W||."""
    return rho**2 * delta / (
        16 * rho + rho**2 + 4 * beta**2 + 2 * rho * beta**2 - 8 * rho * delta
    )


def _circulant_mixing(m: int, shifts: Sequence[tuple[int, float]]) -> np.ndarray:
    w = np.zeros((m, m))
    for shift, weight in shifts:
        w += weight * np.roll(np.eye(m), shift, axis=1)
    return w


def ring(m: int, self_weight: float | None = None) -> Topology:
    """Ring: each node talks to its two neighbors (paper §5.1)."""
    if m < 2:
        return mesh(1)
    if m == 2:
        return mesh(2)
    w_self = 1.0 / 3.0 if self_weight is None else self_weight
    w_side = (1.0 - w_self) / 2.0
    shifts = ((0, w_self), (1, w_side), (-1, w_side))
    w = _circulant_mixing(m, shifts)
    adj = (w > 0).astype(np.float64)
    return Topology("ring", adj, w, shifts)


def torus_2d(m: int) -> Topology:
    """2D torus: each node has 4 neighbors (Metropolis weights); non-square m
    falls back to a circulant 4-regular graph (offsets ±1, ±floor(sqrt(m)))."""
    side = int(round(math.sqrt(m)))
    stride = side if side * side == m else max(2, side)
    if m <= 4:
        return mesh(m)
    w_each = 1.0 / 5.0
    shifts = ((0, w_each), (1, w_each), (-1, w_each), (stride, w_each), (-stride, w_each))
    w = _circulant_mixing(m, shifts)
    adj = (w > 0).astype(np.float64)
    return Topology("torus", adj, w, shifts)


def mesh(m: int) -> Topology:
    """Fully-connected: W = (1/m) 11^T -- one-shot consensus."""
    w = np.full((m, m), 1.0 / m)
    adj = np.ones((m, m))
    shifts = tuple((k, 1.0 / m) for k in range(m))
    return Topology("mesh", adj, w, shifts)


def star(m: int) -> Topology:
    """Star topology with Metropolis weights (not circulant)."""
    adj = np.eye(m)
    adj[0, :] = 1.0
    adj[:, 0] = 1.0
    w = metropolis_weights(adj)
    return Topology("star", adj, w, None)


def erdos_renyi(m: int, p: float, seed: int = 0) -> Topology:
    """Connected Erdos-Renyi graph with Metropolis weights (resampled until
    connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((m, m)) < p
        adj = np.triu(upper, 1)
        adj = adj + adj.T + np.eye(m, dtype=bool)
        if _connected(adj):
            w = metropolis_weights(adj.astype(np.float64))
            return Topology("erdos_renyi", adj.astype(np.float64), w, None)
    raise ValueError(f"could not sample a connected G({m}, {p})")


def _connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    reach = np.eye(m, dtype=bool)
    frontier = reach
    for _ in range(m):
        frontier = (frontier @ adj) > 0
        new = frontier & ~reach
        if not new.any():
            break
        reach |= new
    return bool(reach[0].all())


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """w_ij = 1 / (1 + max(deg_i, deg_j)) for edges, diagonal absorbs the rest."""
    m = adj.shape[0]
    deg = (adj - np.eye(m)).sum(axis=1)
    w = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i != j and adj[i, j] > 0:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def _erdos_renyi_factory(m: int, p: float = 0.3, seed: int = 0) -> Topology:
    return erdos_renyi(m, p=p, seed=seed)


_FACTORIES = {
    "ring": ring,
    "torus": torus_2d,
    "mesh": mesh,
    "star": star,
    "erdos_renyi": _erdos_renyi_factory,
}


def make_topology(name: str, m: int, **kwargs) -> Topology:
    if name not in _FACTORIES:
        raise ValueError(f"unknown topology {name!r}; choose from {sorted(_FACTORIES)}")
    return _FACTORIES[name](m, **kwargs)
