"""Device-side span of the trainer's ``consensus`` ranges a round, in ms:
the compressed CHOCO round (core/gossip.py, the gossip kernels and their glue)."""

RANGE = "consensus"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.gpu_ranges):
        return None
    return run.trace.span_s(RANGE) / run.profiled_rounds * 1e3
