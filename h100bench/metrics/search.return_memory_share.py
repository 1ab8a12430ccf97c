"""The host memory returns' span (ProcessStats.timings["return_memory"]:
the garbage collection and malloc_trim of search/processor.py's
return_memory, after a large zeroing pass and every 8th back-end
iteration of a large image) as a share of the walls of the window's
unprofiled images, in percent. 0 where the images are too small to
return memory; nothing where the program has no such span."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "search driver (search/processor.py)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "return_memory")
