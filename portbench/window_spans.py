"""The measured window's spans from the program's own recorder
(``repro_torch.tracing``): the rounds recorded with the profiler off,
the last ``run.window_rounds`` of them, are the window's (the checked
rounds come before it, the profiled rounds after it are flagged).

Read on the card only, after the window's ``synchronize``; a program
without the recorder gives nothing."""
from __future__ import annotations

import statistics


def per_round(run, name: str, value):
    """The median over the window's rounds of ``value([spans named name])``,
    in ms; None off the card, without the recorder, or where no round has
    a value."""
    if not run.on_card or run.window_rounds <= 0:
        return None
    try:
        from repro_torch import tracing
    except ImportError:  # a program that has no recorder
        return None
    rounds = [r for r in tracing.rounds() if not r.profiled][-run.window_rounds:]
    values = []
    for r in rounds:
        spans = [s for s in r.spans if s.name == name]
        v = value(spans) if spans else None
        if v is not None:
            values.append(v)
    return statistics.median(values) if values else None


def device_ms(spans):
    """The spans' device time (their CUDA event pairs), summed; None if an
    event has not completed."""
    if any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans)


def host_ms(spans):
    """The spans' host time (``perf_counter_ns``), summed."""
    return sum(s.host_end_ns - s.host_start_ns for s in spans) / 1e6


def lag_ms(spans):
    """How far the device trails the host at the last span's end: its end
    event's time on the host clock less the host time it was recorded at."""
    last = spans[-1]
    if last.device_end_ns is None:
        return None
    return (last.device_end_ns - last.host_end_ns) / 1e6
