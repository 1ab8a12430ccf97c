"""The quant search's host span (ProcessStats.timings
["select_quant_matrix"], search/quant_tree.py's waves) as a share of
the image walls.

The spans do not synchronize: device work still queued when one ends is
charged to the next, so this is a host share."""

from h100bench.lib import shares

UNIT = "%"
LAYER = "search driver (search/processor.py)"
MOVES = "mpix_per_s"


def read(rec):
    return shares.share(rec, "select_quant_matrix")
