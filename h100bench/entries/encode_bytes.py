"""Entry: guetzli_tpu_torch.api.encode_bytes, one image at a time.

A closed loop with one client, as a user runs a directory through the
encoder: the next image starts when the previous one has returned (each
call ends in torch.cuda.synchronize()). The deck is cycled until the
window's time is up; the image in flight then completes and counts.
In a traced run the profiler covers the window's first
`trace_images` images (the traffic file's).
"""

import time


def _encode(ctx, item):
    """One timed encode: its record."""
    from guetzli_tpu_torch import api, runtime
    from guetzli_tpu_torch.search import processor
    stats = processor.ProcessStats()
    ctx.inst.stats.clear()
    cpu = time.process_time()
    start = time.perf_counter()
    out = err = None
    try:
        out = api.encode_bytes(item["data"], ctx.quality, stats=stats,
                               device=ctx.device)
        ctx.sync()
    except Exception as e:     # an image's failure is counted, not fatal
        if runtime.is_sticky(e):
            raise
        err = "%s: %s" % (type(e).__name__, e)
    end = time.perf_counter()
    return {"slot": item["slot"], "name": item["name"],
            "pixels": item["width"] * item["height"], "start": start,
            "end": end, "wall": end - start,
            "cpu": time.process_time() - cpu, "out": out, "error": err,
            "distance": stats.final_distance,
            "search_error": stats.search_error,
            "timings": dict(stats.timings), "profiled": False}


def warm(ctx):
    """One encode of each image size the deck holds."""
    seen = set()
    for item in ctx.items:
        size = (item["width"], item["height"])
        if size not in seen:
            seen.add(size)
            _encode(ctx, item)


def window(ctx, seconds):
    """Run the window: (images, batches, start)."""
    n_traced = int(ctx.traffic.get("trace_images", 1)) if ctx.traced else 0
    inst = ctx.inst
    images = []
    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    # A traced run also completes one image the profiler does not cover:
    # the host shares are read from such images.
    while len(images) <= n_traced or time.perf_counter() < deadline:
        item = ctx.items[k % len(ctx.items)]
        if k == 0 and n_traced:
            inst.start_profile()
        rec = _encode(ctx, item)
        k += 1
        if n_traced:
            rec["compares"] = inst.take_compares()
            rec["profiled"] = k <= n_traced
            if rec["profiled"]:
                ctx.sub_compares += rec["compares"]
            if k == n_traced:
                inst.stop_profile()
        images.append(rec)
    return images, [], start
