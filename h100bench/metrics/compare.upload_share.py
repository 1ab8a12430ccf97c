"""The host-to-device copies of the compares' coefficient inputs, their
pinning included (the program's compare_upload span, inside
compare_dispatch: a 4:2:0 compare's whole Y, U and V planes, the quant
base, a wave's matrices, the resident 4:4:4 state's full upload and
its sparse (index, value) pairs; ProcessStats.timings of each serial
encode, phase_walls of each lockstep batch) as a share of the walls,
over the window's images or batches that the profiler did not cover,
in percent. Nothing where the program has no such span.

The span does not synchronize: a copy from pinned memory is queued and
its host cost is the pinning and the launch; a copy that waits for
the card's queue is charged here."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "compare_upload")
