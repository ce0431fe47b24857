"""Message-level wire faults and the self-healing machinery that survives
them (port of ``repro.core.faults``).

The NeighborCache (``core/wire.py``) assumes every compressed hat-delta
arrives intact on every union edge every round: one lost or garbled payload
would leave the receiver's mirror of the sender's ``theta_hat`` wrong for
good.  This module makes that failure injectable, detectable and
recoverable:

* :class:`FaultSpec` -- the fault model: per-edge, per-round i.i.d. message
  events (``drop`` / ``corrupt`` / ``dup`` / ``delay``), the staleness bound
  ``stale`` (S) a diverged mirror is still mixed for, and the exponential
  resync backoff; parsed from ``"drop:0.05,corrupt:0.01,stale:2"``.
* :func:`sample_events` -- one uniform draw per (union op, receiver) per
  round, classified into the event lanes.  The caller draws it (the
  trainer from its ``fault`` generator), so a test can feed the
  reference's draw.
* :func:`digest` -- the detection primitive: a 32-bit wraparound sum of the
  tensor's bits viewed as integers.  Integer addition commutes, so two
  tensors digest equal iff their bytes match (up to the 2^-32 collision
  budget), whatever the reduction order.  The sender's per-chunk digest of
  its post-round ``theta_hat`` rides every message; the receiver checks
  ``digest(mirror + delta)`` against it before committing the delta.
* :class:`FaultState` -- the per-edge recovery state machine, kept in
  ``CHOCOState.fault`` and in checkpoints: synced flags, staleness, resync
  wait and backoff, and the realized-bits meter.

Events (one draw gates the whole message: the delta, its digest and any
resync payload on the edge that round):

========  ==========================  =================================
event     wire effect                 receiver outcome (digest-verified)
========  ==========================  =================================
drop      nothing arrives             mirror misses the delta -> diverged
corrupt   payload garbled in flight   digest mismatch -> discarded -> diverged
dup       two copies arrive           the first applies, the second fails
                                      the digest; bills 2x
delay     arrives after the round     discarded == drop for state; bills 1x
========  ==========================  =================================

Recovery: a diverged mirror is a valid past value of the neighbour's hat,
so it stays in the mix for up to S more rounds; past S the edge leaves the
mix (the surviving-subgraph rescale takes its weight) and the receiver
requests a resync: the sender ships its ``theta_hat`` dense at its dtype,
over the same faulty wire.  A failed attempt doubles the edge's backoff
(capped); a verified one restores the mirror bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = [
    "FaultSpec",
    "FaultState",
    "FaultEvents",
    "WireBits",
    "parse_fault_spec",
    "sample_events",
    "digest",
    "garble",
    "init_fault_state",
    "update_fault_state",
    "receiver_maps",
]


# ================================================================= FaultSpec
_RATE_KEYS = ("drop", "corrupt", "dup", "delay")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded message-fault model for the union wire: ``drop`` / ``corrupt``
    / ``dup`` / ``delay`` are per-edge, per-round event probabilities
    (exclusive lanes of one uniform draw); ``stale`` is the staleness budget
    S; the k-th failed resync waits ``backoff_base^k`` rounds, at most
    ``backoff_cap``."""

    drop: float = 0.0
    corrupt: float = 0.0
    dup: float = 0.0
    delay: float = 0.0
    stale: int = 2
    backoff_base: int = 2
    backoff_cap: int = 32

    def __post_init__(self):
        for k in _RATE_KEYS:
            v = getattr(self, k)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault rate {k}={v} must be in [0, 1]")
        if sum(getattr(self, k) for k in _RATE_KEYS) > 1.0:
            raise ValueError("fault rates must sum to <= 1 (one event per message)")
        if self.stale < 0:
            raise ValueError(f"stale bound must be >= 0, got {self.stale}")
        if self.backoff_base < 1 or self.backoff_cap < 1:
            raise ValueError("backoff base/cap must be >= 1")

    @property
    def active(self) -> bool:
        """Whether any fault lane can fire."""
        return any(getattr(self, k) > 0.0 for k in _RATE_KEYS)

    def __str__(self) -> str:
        parts = [f"{k}:{getattr(self, k):g}" for k in _RATE_KEYS if getattr(self, k) > 0]
        parts.append(f"stale:{self.stale}")
        return ",".join(parts)


def parse_fault_spec(spec) -> FaultSpec | None:
    """``"drop:0.05,corrupt:0.01,stale:2"`` -> :class:`FaultSpec`.  Accepts a
    spec (returned as is), None or "" (no faults), the rate keys, ``stale``
    and ``backoff`` / ``backoff_cap``; a spec whose rates are all zero parses
    to None ("no faults" and "faults at rate 0" are one program)."""
    if spec is None or isinstance(spec, FaultSpec):
        return spec if spec is None or spec.active else None
    text = str(spec).strip()
    if not text:
        return None
    kw: dict[str, Any] = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" not in item:
            raise ValueError(f"bad fault-spec item {item!r}; expected key:value pairs like "
                             "'drop:0.05,corrupt:0.01,stale:2'")
        k, v = (s.strip() for s in item.split(":", 1))
        if k in _RATE_KEYS:
            kw[k] = float(v)
        elif k == "stale":
            kw["stale"] = int(v)
        elif k in ("backoff", "backoff_base"):
            kw["backoff_base"] = int(v)
        elif k == "backoff_cap":
            kw["backoff_cap"] = int(v)
        else:
            raise ValueError(f"unknown fault-spec key {k!r}; valid: "
                             f"{', '.join(_RATE_KEYS + ('stale', 'backoff', 'backoff_cap'))}")
    out = FaultSpec(**kw)
    return out if out.active else None


# ============================================================== fault events
class FaultEvents(NamedTuple):
    """One round's classified message events, [n_ops, m] bool each, indexed
    by (op, receiver)."""

    drop: torch.Tensor  # nothing arrives
    corrupt: torch.Tensor  # arrives garbled, the digest discards it
    dup: torch.Tensor  # arrives twice, the second copy is deduplicated
    delay: torch.Tensor  # arrives too late, discarded == drop


def sample_events(spec: FaultSpec, u: torch.Tensor) -> FaultEvents:
    """Classify the round's uniform draw ``u`` [n_ops, m] f32, one per (op,
    receiver), into the event lanes."""
    u = torch.as_tensor(u, dtype=torch.float32)
    t0 = spec.drop
    t1 = t0 + spec.corrupt
    t2 = t1 + spec.dup
    t3 = t2 + spec.delay
    return FaultEvents(drop=u < t0, corrupt=(u >= t0) & (u < t1),
                       dup=(u >= t1) & (u < t2), delay=(u >= t2) & (u < t3))


# ==================================================================== digest
_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def digest(x: torch.Tensor, axis_start: int = 1) -> torch.Tensor:
    """32-bit wraparound checksum of the raw bits, reduced over the dims from
    ``axis_start`` on: [block, ...] -> [block] int32.

    The tensor is viewed as the integer type of its width, each element sign
    extended, and summed in int64, then wrapped to int32 -- the value the
    reference's int32 sum wraps to.  A mirror kept bit-identical to the
    sender's hat digests equal by construction."""
    if x.is_floating_point():
        x = x.contiguous().view(_INTS[x.element_size()])
    lead = tuple(x.shape[:axis_start])
    if x.dim() <= axis_start:
        return x.to(torch.int32)
    total = x.reshape(lead + (-1,)).sum(-1, dtype=torch.int64)
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


_GARBLE32 = int(np.uint32(0x5A5A5A5A).view(np.int32))
_GARBLE16 = int(np.uint16(0x5A5A).view(np.int16))


def garble(x: torch.Tensor) -> torch.Tensor:
    """Deterministic in-flight corruption: XOR every element's bits with a
    fixed pattern (bijective and never the identity, so the digest mismatch
    is structural)."""
    nbits = x.element_size() * 8
    pattern = _GARBLE16 if nbits == 16 else _GARBLE32
    if not x.is_floating_point():
        return x ^ pattern
    bits = x.contiguous().view(_INTS[x.element_size()])
    return (bits ^ pattern).view(x.dtype)


# ================================================================ FaultState
class FaultState(NamedTuple):
    """Per-edge recovery state machine and realized-bits meter.  Edge arrays
    are [m, n_ops] (receiver-major), telemetry per node [m]."""

    synced: torch.Tensor  # [m, n_ops] f32: 1 = mirror bit-identical to the sender's hat
    stale: torch.Tensor  # [m, n_ops] i32: rounds since the mirror last verified
    wait: torch.Tensor  # [m, n_ops] i32: rounds until the next resync attempt
    backoff: torch.Tensor  # [m, n_ops] i32: failed-resync count (wait = base^k)
    detected: torch.Tensor  # [m] i32: cumulative divergence detections (receiver)
    resyncs: torch.Tensor  # [m] i32: cumulative verified resyncs (receiver)
    bits: torch.Tensor  # [m] f32: wire bits this node delivered last round


def init_fault_state(m: int, n_ops: int, device=None) -> FaultState:
    i32 = dict(dtype=torch.int32, device=device)
    return FaultState(
        synced=torch.ones((m, n_ops), dtype=torch.float32, device=device),
        stale=torch.zeros((m, n_ops), **i32), wait=torch.zeros((m, n_ops), **i32),
        backoff=torch.zeros((m, n_ops), **i32), detected=torch.zeros((m,), **i32),
        resyncs=torch.zeros((m,), **i32),
        bits=torch.zeros((m,), dtype=torch.float32, device=device))


def update_fault_state(fs: FaultState, delta_ok, resync_ok, want, spec: FaultSpec,
                       bits_sent) -> FaultState:
    """Advance the state machine by one round.  ``delta_ok`` / ``resync_ok``
    / ``want`` are op-major [n_ops, m] bool (as the round makes them), the
    state receiver-major.  An edge verifies when its delta applied or a
    requested resync landed, and is reset; otherwise the mirror ages, and a
    wanted resync that failed waits ``base^(k+1)`` rounds (capped)."""
    d_ok, r_ok, want_t = delta_ok.T, resync_ok.T, want.T
    now = d_ok | r_ok
    newly = (fs.synced > 0.0) & ~now
    failed = want_t & ~r_ok
    # the power in f32 with the exponent capped at 16, as the reference
    expo = torch.clamp(fs.backoff + 1, max=16).to(torch.float32)
    pw = torch.minimum(torch.pow(torch.tensor(float(spec.backoff_base), dtype=torch.float32,
                                              device=expo.device), expo),
                       torch.tensor(float(spec.backoff_cap), dtype=torch.float32,
                                    device=expo.device)).to(torch.int32)
    zero = torch.zeros_like(fs.stale)
    return FaultState(
        synced=now.to(torch.float32),
        stale=torch.where(now, zero, fs.stale + 1),
        wait=torch.where(now, zero, torch.where(failed, pw, torch.clamp(fs.wait - 1, min=0))),
        backoff=torch.where(now, zero, torch.where(failed, fs.backoff + 1, fs.backoff)),
        detected=fs.detected + newly.sum(1).to(torch.int32),
        resyncs=fs.resyncs + (want_t & r_ok).sum(1).to(torch.int32),
        bits=bits_sent,
    )


class WireBits(NamedTuple):
    """Realized-bits meter of a memoryless faulted wire (exact consensus):
    no mirrors to heal, so a round's fault state is the bits each node's
    sends delivered."""

    bits: torch.Tensor  # [m] f32


def receiver_maps(union) -> tuple[np.ndarray, ...]:
    """Inverse of the union's sender maps: ``rcv[k][j]`` = the node that
    receives node ``j``'s message on op ``k`` (-1 when ``j`` sends none), so
    sender-side billing can gather receiver-indexed events."""
    out = []
    for snd in union.senders:
        rcv = np.full_like(np.asarray(snd, np.int64), -1)
        idx = np.nonzero(np.asarray(snd) >= 0)[0]
        rcv[np.asarray(snd)[idx]] = idx
        out.append(rcv)
    return tuple(out)
