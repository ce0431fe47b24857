"""Decentralized serving fleet (port of ``repro.serving.fleet``): one engine
per node, admission control, and train-and-serve hot reload.

Every node serves its *local* traffic (the load generator's per-node
streams mirror the training heterogeneity) from the collaboratively trained
consensus model, and hot-reloads new consensus weights from a running
decentralized training through the atomic ``repro_torch.checkpoint``
machinery, so the DRO worst-distribution guarantee becomes a per-node
serving-quality number.

Pieces (each usable alone):

* :class:`AdmissionControl` -- a bounded pending queue per node with a
  ``reject`` (refuse new arrivals) or ``shed_oldest`` (evict the longest
  waiting queued request) overload policy;
* :class:`HotReloader` -- polls a step-tagged checkpoint prefix and swaps in
  the newest *loadable* step, restored onto the engine's device; it walks
  past unreadable files exactly like ``checkpoint.restore_latest``, so a
  torn or in-flight checkpoint is never served;
* :class:`ClassifierEngine` -- a slot-pool engine over any ``apply_fn`` for
  single-forward (classification) serving, with the LM engine's admission,
  queue and timing semantics;
* :class:`BatchedProbe` -- one forward over every population's eval set per
  checkpoint step, memoised by step and shared by the nodes;
* :class:`FleetNode` / :class:`ServingFleet` -- the per-node wrapper and the
  fleet's tick loop (arrivals -> admission -> engine tick -> telemetry ->
  periodic reload + quality probe).

Engines are duck-typed: anything with ``pending`` / ``active`` /
``max_slots`` / ``params`` / ``tokens_generated`` / ``submit(req)`` /
``step()`` (and Request-like objects with the timing fields of
``repro_torch.serving.engine.Request``) plugs in.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import all_steps, restore, step_path
from repro_torch.serving import metrics as M
from repro_torch.tree import leaves

__all__ = [
    "AdmissionControl",
    "HotReloader",
    "ClassifierEngine",
    "BatchedProbe",
    "EvalRequest",
    "FleetNode",
    "ServingFleet",
    "FleetReport",
]


def _device_of(tree) -> torch.device:
    """The device of a parameter tree's first tensor leaf."""
    return next(t.device for t in leaves(tree) if isinstance(t, torch.Tensor))


# ------------------------------------------------------------------ admission
@dataclasses.dataclass
class AdmissionControl:
    """Bounded queue with an overload policy.

    ``max_queue`` bounds the engine's *pending* queue (requests in a slot do
    not count).  ``policy``: ``"reject"`` -- a full queue refuses the
    arrival (marked ``rejected``, never enters the engine); ``"shed_oldest"``
    -- the oldest queued request is evicted (marked ``shed``) and the
    arrival is admitted.
    """

    max_queue: int = 8
    policy: str = "reject"

    def __post_init__(self):
        if self.policy not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown admission policy {self.policy!r}")

    def offer(self, engine, req, *, tick: int) -> str:
        req.submit_tick = tick
        req.submit_wall = time.time()
        if len(engine.pending) >= self.max_queue:
            if self.policy == "reject":
                req.status = "rejected"
                req.finish_tick = tick
                req.finish_wall = req.submit_wall
                return "rejected"
            victim = engine.pending.popleft()
            victim.status = "shed"
            victim.finish_tick = tick
            victim.finish_wall = time.time()
        engine.submit(req)
        return "admitted"


# ----------------------------------------------------------------- hot reload
class HotReloader:
    """Poll a step-tagged checkpoint prefix; serve only complete checkpoints.

    ``poll()`` returns ``(tree, step)`` when a step newer than the last
    loaded one restores (into the structure and dtypes of ``template``, on
    the template's device: the engine's), else ``None``.  Unreadable
    files (torn writes of other tools, in-flight copies) are skipped with a
    log line and counted in ``skipped``; the newest older loadable step is
    used instead.

    Nodes that follow one prefix share a restore: a reloader made with
    ``share=`` (or by :meth:`for_nodes`) takes the other's memo of the
    newest restored step, so each step is read once and every node serves
    the same tree.
    """

    def __init__(self, path: str, template, *, log: Callable[[str], None] = print,
                 share: "HotReloader | None" = None):
        if share is not None and (share.path, share.device) != (path, _device_of(template)):
            raise ValueError("a shared reloader must follow the same prefix on the same device")
        self.path = path
        self.template = template
        self.log = log
        self.device = _device_of(template)
        self.step: int | None = None  # last successfully loaded step
        self.reloads = 0
        self.skipped = 0
        self._restored: dict = share._restored if share is not None else {}

    @classmethod
    def for_nodes(cls, path: str, template, n: int, *,
                  log: Callable[[str], None] = print) -> list["HotReloader"]:
        """``n`` reloaders of one prefix that share each step's restore."""
        first = cls(path, template, log=log)
        return [first] + [cls(path, template, log=log, share=first) for _ in range(n - 1)]

    def poll(self):
        for step in reversed(all_steps(self.path)):
            if self.step is not None and step <= self.step:
                break
            tree = self._restored.get(step)
            if tree is None:
                fname = step_path(self.path, step)
                try:
                    tree = restore(fname, self.template, device=self.device)
                except Exception as e:  # BadZipFile / KeyError / ValueError / OSError
                    self.skipped += 1
                    self.log(f"hot reload: {fname} is unreadable ({type(e).__name__}); "
                             f"keeping the last complete checkpoint")
                    continue
                self._restored.clear()  # only the newest step is held
                self._restored[step] = tree
            self.step = step
            self.reloads += 1
            return tree, step
        return None


# --------------------------------------------------------- classifier engine
@dataclasses.dataclass
class EvalRequest:
    """A single-forward (classification) request: features in, predicted
    labels out, with the LM ``Request``'s lifecycle and timing fields."""

    features: np.ndarray
    labels: np.ndarray | None = None
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)  # predicted labels
    done: bool = False
    status: str = "queued"
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    submit_wall: float = 0.0
    first_wall: float = 0.0
    finish_wall: float = 0.0

    @property
    def ttft_ticks(self) -> int:
        if self.admit_tick < 0 or self.submit_tick < 0:
            return -1
        return self.admit_tick - self.submit_tick


class ClassifierEngine:
    """Slot-pool serving for single-forward models (one tick per request).

    Each tick admits up to ``max_slots`` pending requests FIFO, runs ONE
    forward over their stacked features (``apply_fn(params, x) -> logits``,
    under ``torch.no_grad()`` on the params' device), and finishes them.
    """

    def __init__(self, apply_fn, params, *, max_slots: int = 8):
        self.apply_fn = apply_fn
        self.params = params
        self.max_slots = max_slots
        self.pending: deque[EvalRequest] = deque()
        self.active: dict[int, EvalRequest] = {}
        self._steps = 0
        self._ids = 0
        self.tokens_generated = 0  # one "token" = one prediction
        self.last_busy = 0  # slots used this tick (requests retire in-tick)

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """argmax predictions for a [B, d] feature batch.

        Up to ``max_slots`` rows run as one batch padded with zeros to
        ``max_slots`` (the reference's one fixed-shape program; argmax is
        row-independent); larger batches run unpadded.
        """
        total = x.shape[0]
        if total <= self.max_slots:
            xp = np.zeros((self.max_slots,) + x.shape[1:], x.dtype)
            xp[:total] = x
        else:
            xp = x
        dev = _device_of(self.params)
        with torch.no_grad():
            logits = self.apply_fn(self.params, torch.from_numpy(xp).to(dev))
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
        return preds[:total]

    def submit(self, req: EvalRequest) -> int:
        req.rid = self._ids
        self._ids += 1
        if req.submit_tick < 0:
            req.submit_tick = self._steps
            req.submit_wall = time.time()
        self.pending.append(req)
        return req.rid

    def step(self) -> None:
        batch = []
        while self.pending and len(batch) < self.max_slots:
            batch.append(self.pending.popleft())
        self.last_busy = len(batch)
        if batch:
            feats = [np.atleast_2d(r.features) for r in batch]
            preds = self._forward(np.concatenate(feats, axis=0))
            off = 0
            now = time.time()  # after the predictions reached the host
            for r, f in zip(batch, feats):
                k = f.shape[0]
                r.admit_tick = self._steps
                r.first_wall = now
                r.output = preds[off:off + k].astype(int).tolist()
                off += k
                r.status = "done"
                r.done = True
                r.finish_tick = self._steps
                r.finish_wall = now
                self.tokens_generated += k
        self._steps += 1


# -------------------------------------------------------------- batched probe
class BatchedProbe:
    """Shared quality probe: ONE forward over the concatenated eval sets per
    checkpoint, memoised by step, instead of one forward per node per reload.

    Hand each node ``probe.quality_fn(name)`` as its FleetNode
    ``quality_fn``; the closure advertises ``accepts_step``, so FleetNode
    passes the checkpoint step, which keys the memo (reloaders that do not
    share a restore hand the nodes separate but equal trees).  ``probe_forwards`` counts the
    forwards actually run.  ``loss_fn(params, (x, y), rng) -> scalar``
    adds a ``loss`` to each population's quality.
    """

    def __init__(self, apply_fn, populations: dict, *, loss_fn=None, memo_size: int = 8):
        # populations: name -> (x, y) eval arrays
        self.names = sorted(populations)
        self._pop = {n: (np.asarray(populations[n][0]), np.asarray(populations[n][1]))
                     for n in self.names}
        self._x = np.concatenate([self._pop[n][0] for n in self.names], axis=0)
        self._sizes = [int(self._pop[n][0].shape[0]) for n in self.names]
        self._apply = apply_fn
        self._loss = loss_fn
        self._memo: OrderedDict = OrderedDict()
        self._memo_size = memo_size
        self.probe_forwards = 0

    def _evaluate(self, params) -> dict:
        """One forward on the params' device (the eval arrays are copied there
        per evaluation, which the memo makes once per step)."""
        dev = _device_of(params)
        with torch.no_grad():
            logits = self._apply(params, torch.from_numpy(self._x).to(dev))
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            self.probe_forwards += 1
            out, off = {}, 0
            for name, size in zip(self.names, self._sizes):
                x, y = self._pop[name]
                pred = preds[off:off + size]
                off += size
                q = {"acc": float((pred == y).mean())}
                if self._loss is not None:
                    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                    q["loss"] = float(self._loss(params, batch, None))
                out[name] = q
        return out

    def probe(self, params, step=None) -> dict:
        """All populations' quality dicts for one checkpoint (memoised)."""
        key = step if step is not None else ("obj", id(params))
        if key not in self._memo:
            self._memo[key] = self._evaluate(params)
            while len(self._memo) > self._memo_size:
                self._memo.popitem(last=False)
        else:
            self._memo.move_to_end(key)
        return self._memo[key]

    def quality_fn(self, name: str):
        def quality(params, step=None):
            return dict(self.probe(params, step=step)[name])

        quality.accepts_step = True
        return quality


# ----------------------------------------------------------------- the fleet
class FleetNode:
    """One node: engine + admission + (optional) hot reload + quality probe.

    ``quality_fn(params) -> dict`` is evaluated on the node's local
    distribution at start and after every successful reload, building the
    node's quality timeline (a :class:`BatchedProbe` closure also receives
    the checkpoint step).

    ``retain="all"`` (default) keeps every Request in ``self.requests``;
    ``retain="stats"`` folds terminal requests into a
    :class:`~repro_torch.serving.metrics.RequestStats` each tick: the same
    summaries (exact pooled percentiles) in bounded memory.
    """

    def __init__(self, node_id: int, engine, *, admission: AdmissionControl | None = None,
                 reloader: HotReloader | None = None, quality_fn=None, retain: str = "all"):
        if retain not in ("all", "stats"):
            raise ValueError(f"unknown retain mode {retain!r}")
        self.node_id = node_id
        self.engine = engine
        self.admission = admission or AdmissionControl(max_queue=8)
        self.reloader = reloader
        self.quality_fn = quality_fn
        self.retain = retain
        self.requests: list = []  # all offered (retain="all") or in flight
        self.stats = M.RequestStats() if retain == "stats" else None
        self.queue_samples: list[int] = []
        self.occupancy_samples: list[int] = []
        self.quality_timeline: list[tuple[int | None, dict]] = []
        if quality_fn is not None:
            self.quality_timeline.append((None, self._probe(engine.params, None)))

    def _probe(self, params, step):
        if getattr(self.quality_fn, "accepts_step", False):
            return self.quality_fn(params, step=step)
        return self.quality_fn(params)

    def offer(self, req, *, tick: int) -> str:
        self.requests.append(req)
        return self.admission.offer(self.engine, req, tick=tick)

    def _harvest(self) -> None:
        """retain="stats": fold terminal requests into the accumulator and
        drop them; ``self.requests`` stays the in-flight set."""
        if self.stats is None:
            return
        keep = []
        for r in self.requests:
            if r.status in ("done", "rejected", "shed"):
                self.stats.add(r)
            else:
                keep.append(r)
        self.requests = keep

    def tick(self) -> None:
        self.engine.step()
        self.queue_samples.append(len(self.engine.pending))
        # single-forward engines retire requests within the tick: their busy
        # count is last_busy, not the (empty) active pool
        self.occupancy_samples.append(getattr(self.engine, "last_busy", 0)
                                      or len(self.engine.active))
        self._harvest()

    def maybe_reload(self) -> int | None:
        """Poll for newer consensus weights; swap them in (between ticks, so
        atomically for the traffic) and probe quality if found."""
        if self.reloader is None:
            return None
        got = self.reloader.poll()
        if got is None:
            return None
        params, step = got
        self.engine.params = params
        if self.quality_fn is not None:
            self.quality_timeline.append((step, self._probe(params, step)))
        return step

    @property
    def drained(self) -> bool:
        return not (self.engine.pending or self.engine.active)

    def request_stats(self) -> M.RequestStats:
        """This node's requests as one accumulator (both retain modes;
        in-flight requests count toward ``requests`` only)."""
        self._harvest()
        s = M.RequestStats.merged([self.stats] if self.stats is not None else [])
        for r in self.requests:
            s.add(r)
        return s

    def summary(self, wall_seconds: float) -> dict:
        return M.summarize_node(
            self.request_stats() if self.stats is not None else self.requests,
            queue_samples=self.queue_samples,
            occupancy_samples=self.occupancy_samples,
            max_slots=self.engine.max_slots,
            wall_seconds=wall_seconds,
            tokens_generated=self.engine.tokens_generated,
            engine_stats=self.engine.stats() if hasattr(self.engine, "stats") else None,
        )


@dataclasses.dataclass
class FleetReport:
    ticks: int
    wall_seconds: float
    offered: int
    node_summaries: list[dict]
    fleet: dict
    quality: list[list[tuple[int | None, dict]]]  # per node: (ckpt step, metrics)


class ServingFleet:
    """Tick-synchronous fleet loop.

    Each global tick: (1) route the load generator's arrivals up to the
    current tick through their nodes' admission control, (2) every
    ``reload_every`` ticks poll the hot reloaders, (3) tick every engine.
    Runs until ``max_requests`` have been offered AND every queue drained,
    or ``max_ticks`` elapse.
    """

    def __init__(self, nodes: list[FleetNode], loadgen=None, *, reload_every: int = 0,
                 progress_every: int = 0, log: Callable[[str], None] = print):
        self.nodes = nodes
        self.loadgen = loadgen
        self.reload_every = reload_every
        self.progress_every = progress_every
        self.log = log
        self.ticks = 0
        self.offered = 0

    def run(self, *, max_requests: int | None = None, max_ticks: int = 1_000_000,
            drain: bool = True) -> FleetReport:
        t0 = time.time()
        start = self.ticks
        while self.ticks - start < max_ticks:
            feeding = self.loadgen is not None and (
                max_requests is None or self.offered < max_requests)
            if feeding:
                for node_id, req in self.loadgen.poll(self.ticks):
                    self.nodes[node_id].offer(req, tick=self.ticks)
                    self.offered += 1
            if self.reload_every and self.ticks % self.reload_every == 0:
                for node in self.nodes:
                    node.maybe_reload()
            for node in self.nodes:
                node.tick()
            self.ticks += 1
            if self.progress_every and self.ticks % self.progress_every == 0:
                self.log(f"fleet: tick {self.ticks}, offered {self.offered}"
                         f"{'' if max_requests is None else f'/{max_requests}'}, "
                         f"{time.time() - t0:.1f}s elapsed")
            if not feeding and (not drain or all(n.drained for n in self.nodes)):
                break
        return self.report(time.time() - t0)

    def report(self, wall_seconds: float) -> FleetReport:
        summaries = [n.summary(wall_seconds) for n in self.nodes]
        # pooled percentiles over every node's requests (not a mean of
        # per-node percentiles)
        pooled = M.RequestStats.merged([n.request_stats() for n in self.nodes])
        return FleetReport(
            ticks=self.ticks,
            wall_seconds=wall_seconds,
            offered=self.offered,
            node_summaries=summaries,
            fleet=M.summarize_fleet(summaries, pooled),
            quality=[n.quality_timeline for n in self.nodes],
        )
