"""A program span's share of the walls, in percent, over the window's
images or batches that the profiler did not cover: the serial entry's
ProcessStats.timings[key] over the image walls (lib/shares.share), or
the corpus driver's phase_walls[key] over the batch walls. None where
no such record holds the span (a program that lacks it)."""

from h100bench.lib import shares


def share(rec, key):
    if rec["batches"]:
        bs = [b for b in rec["batches"] if not b["profiled"]]
        wall = sum(b["wall"] for b in bs)
        if wall <= 0 or not any(key in b["phase_walls"] for b in bs):
            return None
        return 100.0 * sum(b["phase_walls"].get(key, 0.0)
                           for b in bs) / wall
    if not any(key in im["timings"] for im in rec["images"]
               if not im["profiled"]):
        return None
    return shares.share(rec, key)
