"""The host time spent capturing the whole-image compares as CUDA graphs
(the program's compare_capture span, inside compare_dispatch:
ProcessStats.timings of each serial encode, phase_walls of each
lockstep batch) as a share of the walls, over the window's images or
batches that the profiler did not cover, in percent: what replaying a
compare costs before its first replay. Nothing where the program has
no such span."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "compare_capture")
