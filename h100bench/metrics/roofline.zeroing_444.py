"""The 4:4:4 greedy zeroing search (kernel B, csrc/zeroing_loop.cu, via
kernels/) against its roofline: the least time of the work its inputs
need over the device time launched inside the benchmark's span around
search.zeroing.compute_zeroing_csr, in percent (lib/roofline.py)."""

from h100bench.lib import roofline

UNIT = "%"
LAYER = "kernels (csrc/, kernels/)"
MOVES = "mpix_per_s"


def read(rec):
    return roofline.share(rec, ("444",))
