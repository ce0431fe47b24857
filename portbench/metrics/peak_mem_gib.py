"""The card's peak allocated memory over set-up, the window and the profiled
rounds (``torch.cuda.max_memory_allocated``), in GiB: how many nodes and
layers fit on a card."""


def read(run):
    return run.peak / 2**30 if run.on_card and run.peak > 0 else None
