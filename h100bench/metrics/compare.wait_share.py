"""The host time blocked in the device-to-host copies of the
whole-image compares' results (the program's compare_wait span:
ProcessStats.timings of each serial encode, phase_walls of each
lockstep batch) as a share of the walls, over the window's images or
batches that the profiler did not cover, in percent: the time the host
waits for the card. Nothing where the program has no such span."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "compare_wait")
