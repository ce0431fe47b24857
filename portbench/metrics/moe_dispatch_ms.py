"""Device-side span of the MoE layers' dispatch a profiled round, in ms: the
program's ``moe.dispatch`` ranges (the gather of each expert's tokens into
its ``[E, C, d]`` buffer, forward and remat's recompute) and
``moe.dispatch.backward`` (the gather's backward)."""

RANGES = ("moe.dispatch", "moe.dispatch.backward")


def read(run):
    if run.trace is None or not any(n in RANGES for n, _, _ in run.trace.gpu_ranges):
        return None
    return sum(run.trace.span_s(r) for r in RANGES) / run.profiled_rounds * 1e3
