"""The busiest node's bits on the wire a round, payload and dual, from the
trainer's meter (``aux["bits_realized"]``, the largest over the window's
rounds); the correctness check holds the checked rounds' readings to the
reference's count of what each round encoded."""


def read(run):
    return run.bits if run.bits > 0 else None
