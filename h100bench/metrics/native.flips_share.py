"""The native flip loop's host span (ProcessStats.timings
["backend_flips"]) as a share of the image walls.

The spans do not synchronize: device work still queued when one ends is
charged to the next, so this is a host share."""

from h100bench.lib import shares

UNIT = "%"
LAYER = "host native (native/)"
MOVES = "mpix_per_s"


def read(rec):
    return shares.share(rec, "backend_flips")
