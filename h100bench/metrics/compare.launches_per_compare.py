"""Kernel launches that ran on the card in the traced sub-window (the
profiler's CUDA kernels; copies and sets left out) over the
whole-image compares dispatched in it. Every launch of the window counts,
the zeroing search's and the quant search's too."""

UNIT = "1"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["compares"] or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["compares"]
