"""Device time of the window's ``forward_backward`` sections a round, in ms
(median over the window's rounds): the program's CUDA event pair around
``LocalUpdate``'s oracle, recorded with the profiler off -- ``fwd_bwd_ms``
without the profiler."""
from portbench.window_spans import device_ms, per_round


def read(run):
    return per_round(run, "forward_backward", device_ms)
