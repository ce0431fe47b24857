"""Spans at the program's layer boundaries: one context manager,
:func:`span`, at two levels.

*Coarse* spans -- ``round`` (all of ``DecentralizedTrainer.step``) and its
sections ``forward_backward``, ``optimizer``, ``dual``, ``consensus`` and
``consensus_err`` -- are recorded in every round by the module's
:class:`Recorder`: host start and end on ``time.perf_counter_ns()`` and, on
a CUDA device, a pair of timing events recorded on the device's current
stream.  The events come from a pool made at the recorder's first round on
the device and are reused; the device's clock is anchored to the host's at
that round (one ``synchronize``, an event, ``perf_counter_ns``), so an
event's time can be placed on the host clock.  The last :data:`RING` rounds
are kept in memory.  Nothing reads the device inside a round:
:func:`rounds` resolves the events when it is called and leaves out those
not yet completed, so a caller that synchronised first gets every device
time.  ``tracing.enabled = False`` turns the recorder off.

*Fine* spans -- a node's oracle (``oracle.forward``, ``oracle.backward``),
the MoE layer's sections (``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``, ``moe.shared``) and the gossip's (``gossip.noise``,
``gossip.copy``, ``gossip.fused``, ``gossip.encode``, ``gossip.decode``,
``gossip.mix``) -- exist only while ``torch.profiler`` records.  With the
profiler off a fine span costs one check and enters nothing.

Under the profiler every span, coarse or fine, is a ``record_function``
range, on the trace's own clock; on a card a coarse span also launches a
one-element fill at its start and its end (:func:`_bracket`), so that its
device-side span still covers its whole section.  A fine span's ``input`` and ``output``
mark the section's tensors: the section's backward then runs inside a
``<name>.backward`` range, opened when the gradient reaches the section's
outputs and closed when it leaves through its inputs (identity autograd
functions, inserted only while the profiler records, so an untraced round
builds the same graph).  With the profiler off no span makes a profiler
call.
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["COARSE", "RING", "Recorder", "Round", "Span", "enabled", "recorder", "rounds",
           "span"]

#: the spans recorded in every round; every other name is a fine span
COARSE = frozenset({"round", "forward_backward", "optimizer", "dual", "consensus",
                    "consensus_err"})
#: rounds kept in memory
RING = 512
#: the recorder records rounds (set False to measure what it costs)
enabled = True

_profiling = torch.autograd._profiler_enabled
# timing events made a device at its first round: two a coarse span of every kept
# round and of the open one
_POOL = (RING + 1) * 2 * len(COARSE)


class Span(NamedTuple):
    name: str
    parent: int | None  # index of the enclosing span in its round, None for ``round``
    host_start_ns: int
    host_end_ns: int
    device_ms: float | None  # between the span's two events; None off the card or pending
    device_start_ns: int | None  # the events' times placed on the host clock
    device_end_ns: int | None


class Round(NamedTuple):
    profiled: bool  # torch.profiler was recording when the round began
    spans: list  # [Span], in the order they opened; the first is ``round``


class _Entry:
    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1", "dev")

    def __init__(self, name, parent, dev):
        self.name, self.parent, self.dev = name, parent, dev
        self.t0 = self.t1 = 0
        self.ev0 = self.ev1 = None


class Recorder:
    """The coarse spans of the last ``bound`` rounds.  Used from the thread
    that runs the rounds."""

    def __init__(self, bound: int = RING):
        self.bound = bound
        self.ring: collections.deque = collections.deque()
        self._round: list | None = None  # the open round's entries
        self._profiled = False
        self._stack: list = []  # indices of the open entries
        self._stream = None
        self._anchors: dict = {}  # device index -> (event, host ns)
        self._pools: dict = {}  # device index -> [idle events]

    def _anchor(self, dev: torch.device) -> None:
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            # record every pooled event once, so that none is created in a round
            pool = [torch.cuda.Event(enable_timing=True) for _ in range(_POOL)]
            for ev in pool:
                ev.record(stream)
            torch.cuda.synchronize(dev)
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(stream)
            self._anchors[dev.index] = (anchor, time.perf_counter_ns())
        self._pools[dev.index] = pool

    def _event(self, dev_index: int):
        pool = self._pools[dev_index]
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def open(self, name: str, device: torch.device | None, profiled: bool):
        """Start a span; returns its entry, or None if it is not recorded
        (a section outside any round).  ``device`` (``round`` only): the
        round's device, with its index on a card."""
        if name == "round" and self._round is None:
            index = None
            if device is not None and device.type == "cuda":
                index = device.index
                if index not in self._anchors:
                    self._anchor(device)
                self._stream = torch.cuda.current_stream(device)
            self._round, self._profiled, self._stack = [], profiled, []
        elif self._round is None:
            return None
        else:
            index = self._round[0].dev
        entry = _Entry(name, self._stack[-1] if self._stack else None, index)
        self._stack.append(len(self._round))
        self._round.append(entry)
        entry.t0 = time.perf_counter_ns()
        if entry.dev is not None:
            entry.ev0 = self._event(entry.dev)
        return entry

    def close(self, entry: _Entry) -> None:
        if entry.dev is not None:
            entry.ev1 = self._event(entry.dev)
        entry.t1 = time.perf_counter_ns()
        self._stack.pop()
        if not self._stack:  # the round ends
            self.ring.append((self._profiled, self._round))
            self._round = None
            if len(self.ring) > self.bound:
                _, old = self.ring.popleft()
                for e in old:
                    if e.dev is not None:
                        self._pools[e.dev].extend((e.ev0, e.ev1))

    def _place(self, dev_index: int, ev) -> int:
        anchor, ns = self._anchors[dev_index]
        return ns + round(anchor.elapsed_time(ev) * 1e6)

    def rounds(self) -> list[Round]:
        """The kept rounds, oldest first, with the device times of every
        event that has completed."""
        out = []
        for profiled, entries in self.ring:
            spans = []
            for e in entries:
                ms = lo = hi = None
                if e.dev is not None and e.ev0.query() and e.ev1.query():
                    ms = e.ev0.elapsed_time(e.ev1)
                    lo, hi = self._place(e.dev, e.ev0), self._place(e.dev, e.ev1)
                spans.append(Span(e.name, e.parent, e.t0, e.t1, ms, lo, hi))
            out.append(Round(profiled, spans))
        return out


#: the process's recorder
recorder = Recorder()


def rounds() -> list[Round]:
    return recorder.rounds()


# the open round's device (nested coarse spans record on it)
_device: torch.device | None = None
# a one-element buffer a card, for the coarse spans' bracket kernels
_brackets: dict = {}


def _bracket(dev) -> None:
    """Under the profiler, one tiny kernel at a coarse span's start and end.
    The profiler gives each kernel to the innermost open range only, and a
    range's device-side span runs from its first kernel to its last: the
    brackets keep a coarse span's device-side span over its whole section
    when fine spans inside it take every other kernel."""
    if dev is None or dev.type != "cuda":
        return
    buf = _brackets.get(dev.index)
    if buf is None:
        buf = _brackets[dev.index] = torch.zeros(1, device=dev)
    buf.zero_()


class _Coarse:
    __slots__ = ("name", "device", "range", "entry", "outer")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _device
        self.outer = _device
        if self.device is not None:
            dev = torch.device(self.device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            _device = dev
        profiled = _profiling()
        self.range = None
        if profiled:
            self.range = record_function(self.name).__enter__()
            _bracket(_device)
        self.entry = recorder.open(self.name, _device, profiled) if enabled else None
        return self

    def __exit__(self, *exc):
        global _device
        if self.entry is not None:
            recorder.close(self.entry)
        if self.range is not None:
            _bracket(_device)
            self.range.__exit__(*exc)
        _device = self.outer


class _BackwardEnd(torch.autograd.Function):
    """Identity at a section's inputs: its backward closes the section's
    backward range."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box:
            torch.ops.profiler._record_function_exit._RecordFunction(ctx.box.pop())
        return (None, *grads)


class _BackwardStart(torch.autograd.Function):
    """Identity at a section's outputs: its backward opens the section's
    backward range."""

    @staticmethod
    def forward(ctx, box, name, *xs):
        ctx.box, ctx.name = box, name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.box.append(torch.ops.profiler._record_function_enter_new(ctx.name, None))
        return (None, None, *grads)


def _one(xs: tuple):
    return xs[0] if len(xs) == 1 else xs


class _Fine(record_function):
    """A fine span under the profiler: a ``record_function`` range whose
    ``input`` / ``output`` mark the section's backward."""

    def __init__(self, name: str):
        super().__init__(name)
        self.box = None

    def input(self, *xs):
        """The section's floating inputs, marked where the gradient leaves
        the section's backward (the same values)."""
        if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
            return _one(xs)
        self.box = []
        return _one(_BackwardEnd.apply(self.box, *xs))

    def output(self, *ys):
        """The section's outputs that carry a gradient, marked where it
        enters the section's backward (the same values)."""
        if self.box is None:
            return _one(ys)
        return _one(_BackwardStart.apply(self.box, f"{self.name}.backward", *ys))


class _Off:
    """A fine span while the profiler is off: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    @staticmethod
    def input(*xs):
        return _one(xs)

    output = input


_OFF = _Off()


def span(name: str, device=None):
    """The span ``name`` as a context manager.  A name in :data:`COARSE` is
    recorded by the recorder (``round`` takes the round's ``device``; the
    sections record on it); any other is a fine span, a ``record_function``
    range only while the profiler records."""
    if name in COARSE:
        return _Coarse(name, device)
    return _Fine(name) if _profiling() else _OFF
