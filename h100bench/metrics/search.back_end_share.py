"""The back end's host span (ProcessStats.timings["back_end"]: the flip
loop, the sparse dispatches, serialization and their compares) as a
share of the image walls.

The spans do not synchronize: device work still queued when one ends is
charged to the next, so this is a host share."""

from h100bench.lib import shares

UNIT = "%"
LAYER = "search driver (search/processor.py)"
MOVES = "mpix_per_s"


def read(rec):
    return shares.share(rec, "back_end")
