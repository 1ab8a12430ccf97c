"""The one traffic generator: a cell's inputs from its traffic file, its
configuration and a seed.

A traffic file (h100bench/traffic/<config>.<mix>.json) lists a deck of
crops: a source photo from h100bench/sources/, a rectangle in it and,
for a thumbnail, the size it is downscaled to. The seed moves each
rectangle by up to `jitter` pixels in each direction (kept inside the
photo), mirrors it left to right with probability `flip`, and shuffles
the deck within each run of `group` consecutive entries. So every seed
gives the same sizes in the same proportions, and other pixels in
another order. The configuration says how each crop is handed to the
program: PNG bytes, or a baseline JPEG of a libjpeg quality and
subsampling. Pixels are read, downscaled (LANCZOS) and written by PIL,
as a user's tools make them.

Nothing here depends on the program under test.
"""

import io
import pathlib

import numpy as np
from PIL import Image

SOURCES = pathlib.Path(__file__).resolve().parent.parent / "sources"
# PIL's `subsampling` argument: 0 is 4:4:4, 2 is 4:2:0.
_SUBSAMPLING = {"444": 0, "420": 2}


def rng_for(seed, stream=0):
    """A NumPy generator for any whole-number seed (negative and past 64
    bits included) and a stream number."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def _load_sources(names):
    out = {}
    for n in sorted(set(names)):
        with Image.open(SOURCES / ("%s.png" % n)) as im:
            out[n] = np.asarray(im.convert("RGB"))
    return out


def input_bytes(rgb, config):
    """The bytes the program is given for pixels `rgb`, per the
    configuration's "input"."""
    spec = config["input"]
    buf = io.BytesIO()
    if spec["kind"] == "png":
        Image.fromarray(rgb).save(buf, "PNG")
    elif spec["kind"] == "jpeg":
        Image.fromarray(rgb).save(buf, "JPEG", quality=int(spec["quality"]),
                                  subsampling=_SUBSAMPLING[
                                      spec["subsampling"]])
    else:
        raise ValueError("unknown input kind %r" % spec["kind"])
    return buf.getvalue()


def generate(traffic, config, seed):
    """The cell's deck, in run order: a list of dicts with "name",
    "slot" (the deck entry it came from), "width", "height", "rgb" (the
    crop, uint8 [h, w, 3]) and "data" (the bytes handed to the
    program)."""
    deck = traffic["deck"]
    group = int(traffic.get("group", len(deck)))
    jitter = int(traffic.get("jitter", 0))
    p_flip = float(traffic.get("flip", 0.0))
    srcs = _load_sources(e["source"] for e in deck)
    rng = rng_for(seed)
    moves = rng.integers(-jitter, jitter + 1, size=(len(deck), 2))
    flips = rng.random(len(deck)) < p_flip
    order = []
    for g0 in range(0, len(deck), group):
        idx = np.arange(g0, min(g0 + group, len(deck)))
        order.extend(rng.permutation(idx).tolist())
    items = []
    for slot in order:
        e = deck[slot]
        src = srcs[e["source"]]
        sh, sw = src.shape[:2]
        x = int(np.clip(e["x"] + moves[slot, 0], 0, sw - e["w"]))
        y = int(np.clip(e["y"] + moves[slot, 1], 0, sh - e["h"]))
        rgb = src[y:y + e["h"], x:x + e["w"]]
        if flips[slot]:
            rgb = rgb[:, ::-1]
        if "out_w" in e:
            rgb = np.asarray(Image.fromarray(np.ascontiguousarray(rgb))
                             .resize((e["out_w"], e["out_h"]),
                                     Image.LANCZOS))
        rgb = np.ascontiguousarray(rgb)
        items.append({"name": "%s_%d_%d_%dx%d%s" % (
                          e["source"], x, y, rgb.shape[1], rgb.shape[0],
                          "_flip" if flips[slot] else ""),
                      "slot": int(slot), "width": int(rgb.shape[1]),
                      "height": int(rgb.shape[0]), "rgb": rgb,
                      "data": input_bytes(rgb, config)})
    return items
