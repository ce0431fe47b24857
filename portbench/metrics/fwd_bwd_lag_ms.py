"""How far the device trails the host at the end of the window's
``forward_backward`` sections, in ms (median over the window's rounds): the
end event's time on the host clock (anchored once, at the program's first
round) less the host time it was recorded at.  Near 0: the device waited on
the host; hundreds of ms: the host ran ahead."""
from portbench.window_spans import lag_ms, per_round


def read(run):
    return per_round(run, "forward_backward", lag_ms)
