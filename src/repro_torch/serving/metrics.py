"""Serving-fleet metrics (port of ``repro.serving.metrics``, numpy only):
per-node and fleet-wide latency/SLO accounting, in the reference's key
vocabulary:

* ``p50_ttft_ticks`` / ``p95_ttft_ticks`` / ``p99_ttft_ticks`` -- percentiles
  of time-to-first-token in **engine ticks** (the first token rides the
  prefill at admit, so TTFT is exactly queue wait; tick-denominated metrics
  are deterministic given the load generator's seed);
* ``p50_ttft_ms`` / ``p99_ttft_ms`` -- percentiles of wall milliseconds
  from submit to the first token (host-dependent).  The port's engine
  stamps ``first_wall`` once the first token is on the host, so these
  include the prefill; the reference stamps it at admit, before the
  prefill.  The port's TTFT ms is therefore not comparable with the
  reference's;
* ``per_token_ms`` -- mean wall milliseconds per generated token over the
  run;
* ``tok_per_s`` -- aggregate generated tokens per wall second;
* ``mean_queue_depth`` / ``max_queue_depth`` -- pending-queue occupancy
  sampled every tick;
* ``slot_occupancy`` -- mean fraction of the slot pool busy per tick;
* ``requests`` / ``completed`` / ``rejected`` / ``shed`` -- admission
  accounting (``rejected``: refused at arrival by the bounded queue;
  ``shed``: evicted from the queue under the shed-oldest policy);
* ``cache_hit_rate`` -- fraction of prefix-cache lookups that hit (0.0 when
  the engine has no prefix cache or bypasses it); ``prefill_skipped`` --
  prefill forwards the prefix cache avoided.

Latency stats accept a list of Request-like objects or a
:class:`RequestStats` accumulator (the fleet's ``retain="stats"`` mode),
which keeps the raw TTFT samples so percentiles stay exact.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "LATENCY_KEYS",
    "RequestStats",
    "percentiles",
    "summarize_requests",
    "summarize_node",
    "summarize_fleet",
]

# the shared latency/SLO key vocabulary, in table order
LATENCY_KEYS = (
    "requests",
    "completed",
    "rejected",
    "shed",
    "p50_ttft_ticks",
    "p95_ttft_ticks",
    "p99_ttft_ticks",
    "p50_ttft_ms",
    "p99_ttft_ms",
    "per_token_ms",
    "tok_per_s",
    "mean_queue_depth",
    "max_queue_depth",
    "slot_occupancy",
    "cache_hit_rate",
    "prefill_skipped",
)


class RequestStats:
    """Streaming accumulator over terminal requests (done/rejected/shed).

    Holds the per-request TTFT samples (exact percentiles) plus counters —
    a few machine words per request instead of a live Request object, so
    the fleet's ``retain="stats"`` mode scales to 10^6+ requests.  Merging
    accumulators concatenates the samples, so fleet-wide percentiles are
    pooled over every node's requests exactly like the list-based path.
    """

    __slots__ = ("requests", "completed", "rejected", "shed", "tokens",
                 "ttft_ticks", "ttft_ms")

    def __init__(self):
        self.requests = 0
        self.completed = 0
        self.rejected = 0
        self.shed = 0
        self.tokens = 0
        self.ttft_ticks: list[int] = []
        self.ttft_ms: list[float] = []

    def add(self, r) -> None:
        """Absorb a TERMINAL request (caller checks the status)."""
        self.requests += 1
        if r.status == "done":
            self.completed += 1
            self.tokens += len(r.output)
            self.ttft_ticks.append(r.ttft_ticks)
            self.ttft_ms.append((r.first_wall - r.submit_wall) * 1e3)
        elif r.status == "rejected":
            self.rejected += 1
        elif r.status == "shed":
            self.shed += 1

    @classmethod
    def merged(cls, parts) -> "RequestStats":
        out = cls()
        for p in parts:
            out.requests += p.requests
            out.completed += p.completed
            out.rejected += p.rejected
            out.shed += p.shed
            out.tokens += p.tokens
            out.ttft_ticks.extend(p.ttft_ticks)
            out.ttft_ms.extend(p.ttft_ms)
        return out


def percentiles(xs, qs=(50, 95, 99)) -> dict[float, float]:
    """Empirical percentiles (nearest-rank on the sorted sample); 0.0 when
    the sample is empty so overload rows still render."""
    xs = np.asarray(list(xs), np.float64)
    if xs.size == 0:
        return {q: 0.0 for q in qs}
    # "higher" = conservative nearest-rank: the reported p99 is an actual
    # sample value with >= 99% of the distribution at or below it
    return {q: float(np.percentile(xs, q, method="higher")) for q in qs}


def _as_stats(requests) -> RequestStats:
    if isinstance(requests, RequestStats):
        return requests
    s = RequestStats()
    for r in requests:
        s.add(r)
    return s


def summarize_requests(requests) -> dict:
    """Latency stats over Request-like objects OR a RequestStats accumulator.

    Only the queue/engine timestamps stamped by the engine and admission
    layer are read (duck-typed: the LM ``ServeEngine`` and the classifier
    engine both qualify).
    """
    s = _as_stats(requests)
    p_t = percentiles(s.ttft_ticks)
    p_w = percentiles(s.ttft_ms, (50, 99))
    return {
        "requests": s.requests,
        "completed": s.completed,
        "rejected": s.rejected,
        "shed": s.shed,
        "tokens": s.tokens,
        "p50_ttft_ticks": p_t[50],
        "p95_ttft_ticks": p_t[95],
        "p99_ttft_ticks": p_t[99],
        "p50_ttft_ms": p_w[50],
        "p99_ttft_ms": p_w[99],
    }


def summarize_node(requests, *, queue_samples, occupancy_samples, max_slots,
                   wall_seconds, tokens_generated, engine_stats=None) -> dict:
    """Per-node roll-up: request latency stats + queue/slot telemetry (+
    the engine's fast-path counters when it exposes ``stats()``)."""
    out = summarize_requests(requests)
    q = np.asarray(queue_samples, np.float64)
    occ = np.asarray(occupancy_samples, np.float64)
    out.update({
        "mean_queue_depth": float(q.mean()) if q.size else 0.0,
        "max_queue_depth": float(q.max()) if q.size else 0.0,
        "slot_occupancy": float(occ.mean() / max_slots) if occ.size else 0.0,
        "per_token_ms": (wall_seconds * 1e3 / tokens_generated) if tokens_generated else 0.0,
        "tok_per_s": (tokens_generated / wall_seconds) if wall_seconds > 0 else 0.0,
    })
    es = engine_stats or {}
    out.update({
        "cache_hit_rate": float(es.get("cache_hit_rate", 0.0)),
        "prefill_skipped": float(es.get("prefill_skipped", 0.0)),
        # raw lookup counts so the fleet roll-up can pool hit rates exactly
        "prefix_hits": float(es.get("prefix_hits", 0.0)),
        "prefix_misses": float(es.get("prefix_misses", 0.0)),
    })
    return out


def summarize_fleet(node_summaries: list[dict], all_requests) -> dict:
    """Fleet-wide roll-up: percentiles pooled over every node's requests
    (NOT a mean of per-node percentiles), throughput and admission totals
    summed, queue/occupancy averaged, cache hit rate pooled over lookups."""
    out = summarize_requests(all_requests)
    if not node_summaries:
        return out
    hits = float(np.sum([n.get("prefix_hits", 0.0) for n in node_summaries]))
    lookups = hits + float(np.sum([n.get("prefix_misses", 0.0) for n in node_summaries]))
    out.update({
        "per_token_ms": float(np.mean([n["per_token_ms"] for n in node_summaries])),
        "tok_per_s": float(np.sum([n["tok_per_s"] for n in node_summaries])),
        "mean_queue_depth": float(np.mean([n["mean_queue_depth"] for n in node_summaries])),
        "max_queue_depth": float(np.max([n["max_queue_depth"] for n in node_summaries])),
        "slot_occupancy": float(np.mean([n["slot_occupancy"] for n in node_summaries])),
        "cache_hit_rate": (hits / lookups) if lookups else 0.0,
        "prefill_skipped": float(np.sum([n.get("prefill_skipped", 0.0)
                                         for n in node_summaries])),
    })
    return out
