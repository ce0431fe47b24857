"""Seeded, checkpointable load generator for the serving fleet (port of
``repro.serving.loadgen``, numpy only: the same config gives the same
arrival ticks, prompts and lengths as the reference, bit for bit).

* **Poisson arrivals** per node -- i.i.d. exponential inter-arrival gaps at a
  per-node ``rate`` (requests per engine tick);
* **Zipf-distributed prompt and output lengths**, bounded to
  ``[prompt_min, prompt_max]`` / ``[output_min, output_max]``;
* **node-skewed prompt tokens**: one Zipf unigram marginal under a
  node-specific vocabulary permutation;
* **three prompt modes** (``prompt_mode``): ``"iid"`` (every prompt token
  drawn i.i.d.), ``"pool"`` (a Zipf-popularity rank into a per-node pool of
  ``prompt_pool`` fixed prompts: the hot-prompt workload of the prefix
  cache) and ``"unique"`` (the i.i.d. draw with the request index stamped
  into the leading tokens, so every prompt is distinct).

Every draw for request ``i`` of node ``n`` comes from a counter-based RNG
keyed by ``(seed, n, i)`` (``np.random.SeedSequence``), so the stream is a
pure function of the config, and :meth:`LoadGenerator.state` (the per-node
cursor, a flat dict of arrays) checkpoints it through ``repro_torch.checkpoint``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.engine import Request

__all__ = ["LoadGenConfig", "LoadGenerator", "bounded_zipf_probs"]


def bounded_zipf_probs(a: float, lo: int, hi: int) -> np.ndarray:
    """P(k) ∝ (k - lo + 1)^-a for k in [lo, hi] (rank 1 at the minimum)."""
    assert hi >= lo >= 0, (lo, hi)
    ranks = np.arange(1, hi - lo + 2, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    num_nodes: int
    rate: float | tuple[float, ...]  # requests per engine tick, per node
    vocab_size: int
    prompt_zipf: float = 1.3
    prompt_min: int = 4
    prompt_max: int = 32
    output_zipf: float = 1.3
    output_min: int = 1
    output_max: int = 8
    token_zipf: float = 1.2
    seed: int = 0
    # prompt repetition structure (see module docstring): "iid" keeps the
    # historical stream bit-identically; "pool" draws from prompt_pool
    # fixed per-node prompts with Zipf(prompt_pool_zipf) popularity;
    # "unique" makes every prompt provably distinct
    prompt_mode: str = "iid"
    prompt_pool: int = 512
    prompt_pool_zipf: float = 1.1

    def __post_init__(self):
        if self.prompt_mode not in ("iid", "pool", "unique"):
            raise ValueError(f"unknown prompt_mode {self.prompt_mode!r}")

    def rate_for(self, node: int) -> float:
        r = self.rate
        return float(r[node]) if isinstance(r, (tuple, list)) else float(r)

    def mean_prompt_len(self) -> float:
        p = bounded_zipf_probs(self.prompt_zipf, self.prompt_min, self.prompt_max)
        return float(p @ np.arange(self.prompt_min, self.prompt_max + 1))

    def mean_output_len(self) -> float:
        p = bounded_zipf_probs(self.output_zipf, self.output_min, self.output_max)
        return float(p @ np.arange(self.output_min, self.output_max + 1))

    def mean_request_tokens(self) -> float:
        """Expected decode ticks a request occupies a slot for (its output
        length; the first token rides the prefill).  ``max_slots /
        mean_request_tokens`` is the analytic per-node capacity in
        requests/tick, the offered-load unit of suite S."""
        return self.mean_output_len()


class LoadGenerator:
    """Per-node Poisson/Zipf request stream, counter-based and resumable.

    ``payload(node, rng, prompt_len, max_new_tokens)`` may be overridden to
    emit a different request object from the same seeded per-request RNG
    (the train-and-serve loop, ``launch/train_serve.py``, routes classifier eval
    requests through identical arrival statistics); the default builds an
    LM :class:`~repro_torch.serving.engine.Request`.
    """

    def __init__(self, cfg: LoadGenConfig, payload=None):
        self.cfg = cfg
        self._default_payload = payload is None
        self._payload = payload or self._lm_request
        m = cfg.num_nodes
        self._next_index = np.zeros(m, np.int64)   # request counter per node
        self._next_time = np.full(m, np.inf)       # arrival time of request _next_index
        self._prompt_cdf = np.cumsum(
            bounded_zipf_probs(cfg.prompt_zipf, cfg.prompt_min, cfg.prompt_max)
        )
        self._output_cdf = np.cumsum(
            bounded_zipf_probs(cfg.output_zipf, cfg.output_min, cfg.output_max)
        )
        self._token_cdf = np.cumsum(
            bounded_zipf_probs(cfg.token_zipf, 0, cfg.vocab_size - 1)
        )
        # prompt-pool popularity (mode="pool"): rank 0 is the hottest prompt
        self._pool_cdf = np.cumsum(
            bounded_zipf_probs(cfg.prompt_pool_zipf, 0, cfg.prompt_pool - 1)
        )
        self._pool_cache: dict[tuple[int, int], np.ndarray] = {}
        # node-specific vocab permutation (namespaced so it can never collide
        # with a per-request (seed, 3, node, i) key)
        self._perms = [
            np.random.default_rng(np.random.SeedSequence((cfg.seed, 1, n))).permutation(
                cfg.vocab_size
            )
            for n in range(m)
        ]
        for n in range(m):
            self._next_time[n] = self._gap(n, 0)
        self.emitted = 0

    # ------------------------------------------------------- per-request rng
    def _rng(self, node: int, i: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence((self.cfg.seed, 3, node, int(i))))

    def _gap(self, node: int, i: int) -> float:
        """Exponential inter-arrival gap before request i of `node`."""
        rate = self.cfg.rate_for(node)
        if rate <= 0.0:
            return np.inf
        # dedicated lane so arrival times don't depend on payload draws
        rng = np.random.default_rng(np.random.SeedSequence((self.cfg.seed, 2, node, int(i))))
        return rng.exponential(1.0 / rate)

    def _bounded_zipf(self, rng, cdf: np.ndarray, lo: int) -> int:
        return lo + int(np.searchsorted(cdf, rng.random(), side="right"))

    def _lm_request(self, node: int, rng, prompt_len: int, max_new: int) -> Request:
        u = rng.random(prompt_len)
        base = np.searchsorted(self._token_cdf, u, side="right")
        toks = self._perms[node][np.minimum(base, self.cfg.vocab_size - 1)]
        return Request(prompt=toks.astype(int).tolist(), max_new_tokens=max_new)

    def _pool_prompt(self, node: int, rank: int) -> np.ndarray:
        """Pool prompt ``rank`` of ``node``: a pure function of the config
        (its own ``(seed, 4, node, rank)`` lane), memoized for speed."""
        key = (node, int(rank))
        if key not in self._pool_cache:
            rng = np.random.default_rng(
                np.random.SeedSequence((self.cfg.seed, 4, node, int(rank)))
            )
            plen = self._bounded_zipf(rng, self._prompt_cdf, self.cfg.prompt_min)
            u = rng.random(plen)
            base = np.searchsorted(self._token_cdf, u, side="right")
            self._pool_cache[key] = self._perms[node][
                np.minimum(base, self.cfg.vocab_size - 1)
            ]
        return self._pool_cache[key]

    def request(self, node: int, i: int):
        """Materialize request ``i`` of ``node`` (pure function of config)."""
        rng = self._rng(node, i)
        if self.cfg.prompt_mode == "pool":
            rank = self._bounded_zipf(rng, self._pool_cdf, 0)
            prompt = self._pool_prompt(node, rank)
            max_new = self._bounded_zipf(rng, self._output_cdf, self.cfg.output_min)
            if self._default_payload:
                return Request(prompt=prompt.astype(int).tolist(),
                               max_new_tokens=max_new)
            return self._payload(node, rng, len(prompt), max_new)
        plen = self._bounded_zipf(rng, self._prompt_cdf, self.cfg.prompt_min)
        max_new = self._bounded_zipf(rng, self._output_cdf, self.cfg.output_min)
        req = self._payload(node, rng, plen, max_new)
        if self.cfg.prompt_mode == "unique" and self._default_payload:
            # stamp the request index into the leading tokens: prompts are
            # provably distinct for i < vocab_size^min(3, plen) per node —
            # the guaranteed-zero-hit-rate control of suite S
            v = self.cfg.vocab_size
            for p in range(min(3, plen)):
                req.prompt[p] = (i // v ** p) % v
        return req

    # ------------------------------------------------------------- streaming
    def poll(self, until_tick: float) -> list[tuple[int, object]]:
        """All (node, request) arrivals with arrival time <= ``until_tick``.

        Arrivals are merged across nodes in time order (ties broken by node
        id), so a fleet draining one shared queue still sees a well-defined
        deterministic order.
        """
        out: list[tuple[float, int, object]] = []
        for n in range(self.cfg.num_nodes):
            while self._next_time[n] <= until_tick:
                i = int(self._next_index[n])
                out.append((float(self._next_time[n]), n, self.request(n, i)))
                self._next_index[n] = i + 1
                self._next_time[n] += self._gap(n, i + 1)
                self.emitted += 1
        out.sort(key=lambda t: (t[0], t[1]))
        return [(n, req) for _, n, req in out]

    # ----------------------------------------------------------- checkpoints
    def state(self) -> dict[str, np.ndarray]:
        """Resume cursor as a flat pytree of arrays (npz-checkpointable)."""
        return {
            "next_index": self._next_index.copy(),
            "next_time": self._next_time.copy(),
            "emitted": np.asarray(self.emitted, np.int64),
        }

    def restore(self, state: dict) -> None:
        """Adopt a cursor from :meth:`state`; the continuation is
        bit-identical to the uninterrupted stream (draws are keyed by the
        request counter, and the arrival clock rides in the state)."""
        self._next_index = np.asarray(state["next_index"], np.int64).copy()
        self._next_time = np.asarray(state["next_time"], np.float64).copy()
        self.emitted = int(np.asarray(state["emitted"]))
