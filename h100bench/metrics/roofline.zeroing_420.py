"""The 4:2:0 greedy zeroing searches, the Y pass and the chroma pass
together (kernels B' and B'', csrc/zeroing_loop.cu modes 420y and
420c), against their roofline, as lib/roofline.py sets out."""

from h100bench.lib import roofline

UNIT = "%"
LAYER = "kernels (csrc/, kernels/)"
MOVES = "mpix_per_s"


def read(rec):
    return roofline.share(rec, ("420y", "420c"))
