"""Token batches from the seed: a frozen copy of the port's
``data/synthetic.py::node_token_stream`` (one Zipf marginal over the
vocabulary, a vocabulary permutation per node: the paper's heterogeneous
nodes), kept here so that a change to the program cannot change the traffic."""
from __future__ import annotations

import numpy as np


def node_token_stream(num_nodes: int, batch_per_node: int, seq_len: int, vocab_size: int,
                      zipf_a: float = 1.2, seed: int = 0):
    """Infinite per-node LM batches [m, b, S] int32 with node-skewed unigram
    statistics."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    perms = np.stack([rng.permutation(vocab_size) for _ in range(num_nodes)])
    node = np.arange(num_nodes)[:, None, None]
    while True:
        base = rng.choice(vocab_size, size=(num_nodes, batch_per_node, seq_len), p=probs)
        yield perms[node, base].astype(np.int32)


def batches(wl: dict, vocab_size: int, seed: int) -> tuple[list, list]:
    """(the checked rounds' batches, the window's pool): every batch a fresh
    draw of the stream, so no two rows repeat."""
    stream = node_token_stream(wl["nodes"], wl["batch_per_node"], wl["seq"], vocab_size,
                               zipf_a=wl["zipf_a"], seed=seed)
    checked = [next(stream) for _ in range(wl["checked_rounds"])]
    pool = [next(stream) for _ in range(wl["pool"])]
    return checked, pool
