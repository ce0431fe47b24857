"""Device-side span of the trainer's ``optimizer`` ranges a round, in ms:
the DRO-weighted SGD step (optim/sgd.py)."""

RANGE = "optimizer"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.gpu_ranges):
        return None
    return run.trace.span_s(RANGE) / run.profiled_rounds * 1e3
