"""Model FLOPs of the window's rounds (``counting/flops.py``) over the
window's time and the card's bf16 dense peak, in %: the whole step's share
of the chip, over the traced run's rounds outside the profiler."""
from portbench.counting.peaks import BF16_FLOPS


def read(run):
    if not run.on_card or run.window_rounds <= 0 or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_round * run.window_rounds / run.window_s / BF16_FLOPS
