"""Shared arithmetic of the host-span shares: a ProcessStats timing summed
over the window's images that the profiler did not cover, over their
walls, in percent."""


def share(rec, key):
    ims = [im for im in rec["images"]
           if im["out"] is not None and not im["profiled"]
           and im["timings"]]
    wall = sum(im["wall"] for im in ims)
    if not ims or wall <= 0:
        return None
    return 100.0 * sum(im["timings"].get(key, 0.0) for im in ims) / wall
