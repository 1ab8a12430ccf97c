"""The host decode of the inputs (the program's input_decode span:
reading the input's bytes and decoding them to RGB on the host, a
JPEG's reader and integer IDCT and upsample or a PNG's native decode,
inside image_setup; ProcessStats.timings of each serial encode,
phase_walls of each lockstep batch) as a share of the walls, over the
window's images or batches that the profiler did not cover, in
percent. Nothing where the program has no such span."""

from h100bench.lib import span_shares

UNIT = "%"
LAYER = "codec (codec/)"
MOVES = "mpix_per_s"


def read(rec):
    return span_shares.share(rec, "input_decode")
