"""Device-side span of the trainer's ``consensus_err`` ranges a round, in ms:
the consensus error (core/trainer.py::_consensus_error)."""

RANGE = "consensus_err"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.gpu_ranges):
        return None
    return run.trace.span_s(RANGE) / run.profiled_rounds * 1e3
