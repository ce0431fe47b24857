"""Host time of the window's ``forward_backward`` sections a round, in ms
(median over the window's rounds, ``perf_counter_ns``): the oracle's
dispatch, plus the waits where the launch queue is full."""
from portbench.window_spans import host_ms, per_round


def read(run):
    return per_round(run, "forward_backward", host_ms)
