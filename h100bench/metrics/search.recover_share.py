"""The recovery span (ProcessStats.timings["recover"]: freeing the
card's memory and rebuilding the comparator's device state after an
out-of-memory error, search/processor.py's Processor.recover; the
replayed compare stays under the compare spans) as a share of the
walls of the window's unprofiled images, in percent. 0 where no image
ran out of memory; nothing where the program has no such span."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "search driver (search/processor.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "recover")
