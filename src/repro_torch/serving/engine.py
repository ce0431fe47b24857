"""Continuous-batching serving engine (PyTorch port of
``repro.serving.engine``).

* a fixed pool of ``max_slots`` cache slots (attention K/V, ring buffers for
  windowed archs), allocated once on the engine's device;
* requests are admitted whenever a slot is free: the prompt is prefilled
  (padded to a ``prompt_bucket`` multiple) and spliced into its slot;
* every tick decodes ONE token for all active slots in one batched decode
  step with per-slot positions;
* finished requests (max tokens or EOS) release their slot at once.

The fast path (``fastpath=True``, the default) has three levers that leave
every tick-denominated result unchanged -- admission order, completion
ticks and generated tokens -- and only save host and device time:

* prefix KV cache (``prefix_cache`` entries): post-prefill cache rows keyed
  by ``(bucket, quantized_kv, prompt)``, LRU-bounded, invalidated when
  ``engine.params`` is reassigned (hot reload), bypassed for windowed /
  recurrent archs (their exact-length prefill makes a cached row
  position-dependent) and with ``extra_inputs`` (the prompt alone does not
  key the forward);
* batched prefill (``batched_prefill``): the same-bucket requests admitted
  in one tick run as one forward, batch padded to a power of two;
* active-slot decode (``active_decode``): below full occupancy the decode
  gathers the active slots (padded to a power of two) instead of decoding
  the whole pool.

``extra_inputs`` (whisper's ``frames`` [encoder_context, d], internvl2's
``patches`` [num_patches, d]) go to every prefill, broadcast over its
batch rows, pad rows included.  mamba2 prompts must be whole multiples of
``ssm_chunk`` (the reference asserts it).

``fastpath=False`` with the levers defaulted is the reference's pre-cache
engine: one batch-1 prefill per request, whole-pool decode, no prefix
cache.  ``max_prefill_programs`` is accepted for the reference's signature
and bounds nothing: the port compiles no programs.  ``sample(logits,
generator)`` picks each decoded token from ``[rows, vocab]`` logits with the
engine's seeded ``torch.Generator`` (the reference passes a PRNG key);
greedy argmax is the default.  The first token is always the prefill's
argmax.  ``first_wall`` is stamped once the first token is on the host, so
wall TTFT includes the prefill; ``prefill_forwards`` / ``decode_forwards``
count model forwards (one kernel launch per layer each).

Admission is strictly FIFO: each tick runs an admit / finish fixpoint.
There is no jit; ``prefill_traces`` / ``decode_traces`` count the first use
of each program shape in the process-wide :data:`SEEN_SHAPES` set, so the
bounded-shape contract of the reference stays testable.  Nothing is cached
or evicted: ``prefill_evictions`` is always 0.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["Request", "ServeEngine", "SEEN_SHAPES"]


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    # filled by the engine
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle + timing (ticks are engine steps; walls are host seconds).
    # The first token lands at admit, so TTFT = admit_tick - submit_tick.
    status: str = "queued"  # queued | active | done | rejected | shed
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    submit_wall: float = 0.0
    first_wall: float = 0.0
    finish_wall: float = 0.0

    @property
    def ttft_ticks(self) -> int:
        """Time-to-first-token in engine ticks (queue wait; -1 if unserved)."""
        if self.admit_tick < 0 or self.submit_tick < 0:
            return -1
        return self.admit_tick - self.submit_tick


def _round_up(n: int, unit: int) -> int:
    return max(unit, -(-n // unit) * unit)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


#: program shapes used so far in this process: ``(kind, config, max_slots,
#: *shape)``.  Shared by every engine, as the reference's compiled programs
#: are; tests pinning trace counts clear it first.
SEEN_SHAPES: set[tuple] = set()


def _rows(cache, idx: torch.Tensor):
    """Rows ``idx`` of every cache leaf (a copy)."""
    return [{name: t.index_select(0, idx) for name, t in c.items()} for c in cache]


def _put_rows(pool, rows, idx: torch.Tensor) -> None:
    """pool[idx] = rows for every leaf, in place."""
    for c, r in zip(pool, rows):
        for name, t in c.items():
            t.index_copy_(0, idx, r[name].to(t.dtype))


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_slots: int = 4,
        cache_len: int = 256,
        prompt_bucket: int = 32,
        sample: Callable[[torch.Tensor, torch.Generator], torch.Tensor] | None = None,
        extra_inputs: dict | None = None,
        fastpath: bool = True,
        prefix_cache: int = 64,
        batched_prefill: bool | None = None,
        active_decode: bool | None = None,
        max_prefill_programs: int = 32,  # unused: no program cache
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.extra_inputs = {k: torch.as_tensor(v, device=self.device)
                             for k, v in (extra_inputs or {}).items()}
        self.cfg = cfg
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.prompt_bucket = prompt_bucket
        # the master toggle defaults the levers; the pre-cache engine
        # (fastpath=False) ignores them, as the reference's does
        self._fast = bool(fastpath)
        self._batched_prefill = self._fast and (batched_prefill is None or batched_prefill)
        self._active_decode = self._fast and (active_decode is None or active_decode)
        self._prefix_max = int(prefix_cache) if self._fast else 0  # 0 disables it

        self.cache = T.init_cache(cfg, max_slots, cache_len, device=self.device)
        self.pos = np.zeros(max_slots, np.int64)  # context length per slot
        self.last_tok = np.zeros(max_slots, np.int64)
        self.active: dict[int, Request] = {}
        self.pending: deque[Request] = deque()
        self._ids = itertools.count()
        self._steps = 0
        # first use of each program shape (one prefill per (bucket, batch),
        # a log2-bounded decode set) is the warm-cache contract
        self.prefill_traces = 0
        self.decode_traces = 0
        self.prefill_forwards = 0
        self.decode_forwards = 0
        self.tokens_generated = 0
        self._prefix: OrderedDict[tuple, tuple] = OrderedDict()
        self.params_version = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.prefix_invalidations = 0
        self.prefill_skipped = 0

        self._params = params
        self._sample = sample or (lambda logits, generator: torch.argmax(logits, dim=-1))
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        mixers = {cfg.mixer_for_layer(i) for i in range(cfg.num_layers)}
        self._recurrent = bool(mixers & {"mamba2", "rglru"})
        # windowed ring buffers attend every slot once wrapped, so bucket
        # padding would poison them: such archs prefill at exact length
        self._windowed = ("local_attn" in mixers) or (
            cfg.long_context_window is not None and cache_len > cfg.long_context_window
        )
        extras = tuple(sorted((k, tuple(v.shape)) for k, v in self.extra_inputs.items()))
        self._sig = (repr(cfg), cache_len, str(self.device), extras)

    # ------------------------------------------------------------- params
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, new):
        """Hot reload: swapping weights invalidates every cached prefix."""
        self._params = new
        self.params_version += 1
        if self._prefix:
            self.prefix_invalidations += 1
            self._prefix.clear()

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Engine-side fast-path telemetry (floats, fleet-aggregatable)."""
        lookups = self.prefix_hits + self.prefix_misses
        return {
            "prefix_hits": float(self.prefix_hits),
            "prefix_misses": float(self.prefix_misses),
            "prefix_entries": float(len(self._prefix)),
            "prefix_evictions": float(self.prefix_evictions),
            "prefix_invalidations": float(self.prefix_invalidations),
            "cache_hit_rate": (self.prefix_hits / lookups) if lookups else 0.0,
            "prefill_skipped": float(self.prefill_skipped),
            "prefill_programs": float(len(SEEN_SHAPES)),
            "prefill_evictions": 0.0,  # no program cache to evict from
            "prefill_traces": float(self.prefill_traces),
            "decode_traces": float(self.decode_traces),
        }

    # ----------------------------------------------------------- programs
    def _first_use(self, counter: str, kind: str, *shape) -> None:
        """Bump ``counter`` when this program shape is first used in the process."""
        key = (kind, self._sig, self.max_slots, *shape)
        if key not in SEEN_SHAPES:
            SEEN_SHAPES.add(key)
            setattr(self, counter, getattr(self, counter) + 1)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # ----------------------------------------------------------- prefill
    def _bucket_for(self, req: Request) -> int:
        plen = len(req.prompt)
        if self._recurrent or self._windowed:
            if self.cfg.ssm_state and plen % self.cfg.ssm_chunk:
                raise ValueError(f"mamba2 prompts must be multiples of ssm_chunk="
                                 f"{self.cfg.ssm_chunk}; got {plen} tokens")
            return plen
        return min(_round_up(plen, self.prompt_bucket), self.cache_len)

    def _post_admit(self, req: Request, slot: int, first: int, plen: int) -> None:
        # bucket-padded positions beyond plen hold garbage K/V; decode masks
        # by position (valid = idx <= pos), so they are never attended.
        # ``first`` is a host int: the device has delivered the first token
        req.first_wall = time.time()
        self.pos[slot] = plen
        self.last_tok[slot] = first
        req.output.append(first)
        self.tokens_generated += 1
        self.active[slot] = req

    def _admit(self, pairs: list) -> None:
        """Prefix-cache hits splice a stored row; misses run grouped per
        bucket as one batched prefill each (with ``batched_prefill``), else
        one batch-1 prefill each in admission order."""
        hits, misses = [], []
        cacheable = (self._prefix_max > 0 and not (self._recurrent or self._windowed)
                     and not self.extra_inputs)
        for req, slot in pairs:
            req.admit_tick = self._steps
            req.status = "active"
            plen = len(req.prompt)
            bucket = self._bucket_for(req)
            # keyed by quantization mode too: an int8 row never splices into
            # a float pool after a config flip (or vice versa)
            key = (bucket, bool(self.cfg.quantized_kv), tuple(req.prompt)) if cacheable else None
            if key is not None and key in self._prefix:
                row, first = self._prefix[key]
                self._prefix.move_to_end(key)
                self.prefix_hits += 1
                self.prefill_skipped += 1
                hits.append((req, slot, row, first, plen))
            else:
                if key is not None:
                    self.prefix_misses += 1
                misses.append((req, slot, bucket, key, plen))

        for req, slot, row, first, plen in hits:
            _put_rows(self.cache, row, self._tensor([slot]))
            self._post_admit(req, slot, first, plen)

        if not self._batched_prefill:  # one forward each, in admission order
            for item in misses:
                self._prefill_group(item[2], [item])
            return
        groups: dict[int, list] = {}
        for item in misses:
            groups.setdefault(item[2], []).append(item)
        for bucket, group in groups.items():
            self._prefill_group(bucket, group)

    def _prefill_group(self, bucket: int, group: list) -> None:
        # batch padded to a power of two: the shape set stays log-bounded
        bpad = _pow2(len(group))
        toks = np.zeros((bpad, bucket), np.int64)
        last = np.zeros(bpad, np.int64)
        for r, (req, _, _, _, plen) in enumerate(group):
            toks[r, :plen] = req.prompt
            last[r] = plen - 1
        self._first_use("prefill_traces", "prefill", bucket, bpad)
        batch = {"tokens": self._tensor(toks),
                 **{k: v.expand(bpad, *v.shape) for k, v in self.extra_inputs.items()}}
        logits, cache_b = T.prefill(self.params, batch, self.cfg, cache_len=self.cache_len)
        self.prefill_forwards += 1
        # first generated token per row: argmax at its last REAL position
        firsts = torch.argmax(logits[torch.arange(bpad, device=self.device),
                                     self._tensor(last)], dim=-1).tolist()
        _put_rows(self.cache, _rows(cache_b, self._tensor(range(len(group)))),
                  self._tensor([slot for _, slot, _, _, _ in group]))
        for r, (req, slot, _, key, plen) in enumerate(group):
            if key is not None and key not in self._prefix:
                self._prefix[key] = (_rows(cache_b, self._tensor([r])), int(firsts[r]))
                if len(self._prefix) > self._prefix_max:
                    self._prefix.popitem(last=False)
                    self.prefix_evictions += 1
            self._post_admit(req, slot, int(firsts[r]), plen)

    # -------------------------------------------------------------- API
    def submit(self, req: Request) -> int:
        req.rid = next(self._ids)
        if req.submit_tick < 0:  # a fleet may pre-stamp the arrival tick
            req.submit_tick = self._steps
            req.submit_wall = time.time()
        self.pending.append(req)
        return req.rid

    def _finish(self, slot: int) -> None:
        r = self.active[slot]
        r.done = True
        r.status = "done"
        r.finish_tick = self._steps
        r.finish_wall = time.time()
        del self.active[slot]
        self.pos[slot] = 0

    def _complete(self, r: Request) -> bool:
        return len(r.output) >= r.max_new_tokens or (
            r.eos_id is not None and bool(r.output) and r.output[-1] == r.eos_id
        )

    def _decode(self) -> None:
        """One token for every active slot.

        With ``active_decode``, below full occupancy the active slots are
        gathered, padded to a power of two with copies of the first active
        slot, and only the real rows are written back.  Rows are
        independent, so the tokens equal those of a full-pool step.
        """
        order = sorted(self.active)
        n = len(order)
        bpad = _pow2(n) if (self._active_decode and n < self.max_slots) else self.max_slots
        if bpad >= self.max_slots:
            self._first_use("decode_traces", "decode")
            logits, self.cache = T.decode_step(self.params,
                                               self._tensor(self.last_tok)[:, None], self.cache,
                                               self._tensor(self.pos), self.cfg)
            rows = {slot: slot for slot in order}
        else:
            gidx = np.empty(bpad, np.int64)
            gidx[:n] = order
            gidx[n:] = order[0]
            self._first_use("decode_traces", "decodeg", bpad)
            g = self._tensor(gidx)
            logits, sub = T.decode_step(self.params, self._tensor(self.last_tok[gidx])[:, None],
                                        _rows(self.cache, g), self._tensor(self.pos[gidx]),
                                        self.cfg)
            _put_rows(self.cache, [{k: t[:n] for k, t in c.items()} for c in sub], g[:n])
            rows = {slot: r for r, slot in enumerate(order)}
        self.decode_forwards += 1
        next_tok = torch.as_tensor(self._sample(logits[:, 0], self.generator)).reshape(-1).tolist()
        for slot in order:
            r = self.active[slot]
            tok = int(next_tok[rows[slot]])
            r.output.append(tok)
            self.tokens_generated += 1
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            if self._complete(r):
                self._finish(slot)

    def step(self) -> None:
        """One engine tick: admit (FIFO, to a fixpoint with completion), then
        decode one token for every active slot."""
        while True:
            for slot in list(self.active):
                if self._complete(self.active[slot]):
                    self._finish(slot)
            free = [s for s in range(self.max_slots) if s not in self.active]
            if not (self.pending and free):
                break
            pairs = []
            for slot in free:
                if not self.pending:
                    break
                pairs.append((self.pending.popleft(), slot))
            self._admit(pairs)
        if self.active:
            self._decode()
        self._steps += 1

    def run(self, requests: list[Request], max_ticks: int = 10_000) -> list[Request]:
        """Submit everything and tick until done.  Returns the requests."""
        for r in requests:
            self.submit(r)
        ticks = 0
        while (self.pending or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return requests
