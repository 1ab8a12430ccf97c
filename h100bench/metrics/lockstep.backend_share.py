"""The corpus driver's back-end rounds (parallel/lockstep.py
phase_walls["backend"]) as a share of the batch walls, over the window's
batches that the profiler did not cover, in percent. A host span."""

UNIT = "%"
LAYER = "corpus driver (parallel/lockstep.py)"
MOVES = "mpix_per_s"


def read(rec):
    bs = [b for b in rec["batches"] if not b["profiled"]]
    wall = sum(b["wall"] for b in bs)
    if not bs or wall <= 0:
        return None
    return 100.0 * sum(b["phase_walls"].get("backend", 0.0)
                       for b in bs) / wall
