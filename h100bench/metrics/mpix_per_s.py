"""Input megapixels of every image completed in the window, over the time
from the window's start to the last completion."""

UNIT = "MPix/s"
LAYER = "entry"
MOVES = None


def read(rec):
    done = [im for im in rec["images"] if im["out"] is not None]
    if not done:
        return None
    span = max(im["end"] for im in done) - rec["window_start"]
    return sum(im["pixels"] for im in done) / 1e6 / span
