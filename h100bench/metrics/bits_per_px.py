"""8 x the output bytes over the input pixels, over one encode of each
entry of the deck: the first the window completed. That set does not
depend on how many images the window held, so for a seed the number
moves only when the program writes other bytes. Nothing is read unless
the window completed every entry of the deck at least once."""

UNIT = "bit/px"
LAYER = "entry"
MOVES = None


def read(rec):
    first = {}
    for im in rec["images"]:
        if im["out"] is not None and im["slot"] not in first:
            first[im["slot"]] = im
    if len(first) < rec["deck"]:
        return None
    return 8.0 * sum(len(im["out"]) for im in first.values()) / sum(
        im["pixels"] for im in first.values())
