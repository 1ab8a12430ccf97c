"""Seconds from the process's start to the first timed image: imports,
input generation, kernel builds (the first run in a checkout) and the
warm-up encodes of every image size."""

UNIT = "s"
LAYER = "entry"
MOVES = None


def read(rec):
    return rec["setup_s"]
