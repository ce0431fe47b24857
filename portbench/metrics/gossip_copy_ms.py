"""Device-side span of the gossip's ``gossip.copy`` ranges a profiled round,
in ms: the copies of each chunk of theta, theta_hat and s into contiguous
buffers and back (``core/gossip.py::_round_leaves``)."""

RANGE = "gossip.copy"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.gpu_ranges):
        return None
    return run.trace.span_s(RANGE) / run.profiled_rounds * 1e3
