"""Share of the profiled rounds' wall time in which no operation ran on the
card, in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.traced_s)
