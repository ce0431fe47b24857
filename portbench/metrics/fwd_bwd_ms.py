"""Device-side span of the trainer's ``forward_backward`` ranges a round, in ms:
the model's forward and backward (every node's, through LocalUpdate._oracle)."""

RANGE = "forward_backward"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.gpu_ranges):
        return None
    return run.trace.span_s(RANGE) / run.profiled_rounds * 1e3
