"""Whole-image compares per input megapixel over the traced run's window:
Comparator.compares of each serial encode, or the corpus driver's
counters["compares"] of each batch (a quant wave counts its trials)."""

UNIT = "1/MPix"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"


def read(rec):
    if rec["batches"]:
        if any("compares" not in b for b in rec["batches"]):
            return None
        n = sum(b["compares"] for b in rec["batches"])
        px = sum(im["pixels"] for im in rec["images"])
    else:
        ims = [im for im in rec["images"] if "compares" in im]
        if not ims:
            return None
        n = sum(im["compares"] for im in ims)
        px = sum(im["pixels"] for im in ims)
    return n / (px / 1e6) if px and n else None
