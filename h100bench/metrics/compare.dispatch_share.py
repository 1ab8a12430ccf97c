"""The host time spent launching the whole-image compares' device work
(the program's compare_dispatch span: ProcessStats.timings of each
serial encode, phase_walls of each lockstep batch) as a share of the
walls, over the window's images or batches that the profiler did not
cover, in percent. A deferred compare is charged where its work is
launched, at its resolve. Nothing where the program has no such span.

The spans do not synchronize: a launch that waits for room in the
card's queue is charged here."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "compare_dispatch")
