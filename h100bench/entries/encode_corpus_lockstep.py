"""Entry: guetzli_tpu_torch.parallel.lockstep.encode_corpus_lockstep,
the corpus CLI's encoder, one batch at a time.

The deck is cut into batches of the traffic file's `batch` images, in
run order, and cycled; a closed loop with one client: the next batch
is submitted when the previous one has returned (and the card has
synchronized). The card's defaults are kept (no `pad`, one thread).
In a traced run the profiler covers the first batch from its first
call into the zeroing search (the masking pass) through
`trace_rounds` back-end rounds after it: the lockstep rounds' compares
are far too many to trace a whole batch.
"""

import time


def _batch(ctx, chunk, hooks=False):
    """One timed batch: (its record, its images' records)."""
    from guetzli_tpu_torch import runtime
    from guetzli_tpu_torch.parallel import lockstep
    inst = ctx.inst
    inst.stats.clear()
    walls, counters = {}, {}
    cpu = time.process_time()
    start = time.perf_counter()
    res = None
    err = None
    try:
        res = lockstep.encode_corpus_lockstep(
            [(it["name"], it["data"]) for it in chunk], ctx.quality,
            phase_walls=walls, counters=counters, device=ctx.device)
        ctx.sync()
    except Exception as e:     # the batch's failure is counted, not fatal
        if runtime.is_sticky(e):
            raise
        err = "%s: %s" % (type(e).__name__, e)
    end = time.perf_counter()
    if hooks:
        inst.stop_profile()
    stats = list(inst.stats)
    if len(stats) != len(chunk):
        stats = [None] * len(chunk)
    images = []
    for i, it in enumerate(chunk):
        st = stats[i]
        out = res[i][1] if res is not None else None
        images.append({
            "slot": it["slot"], "name": it["name"],
            "pixels": it["width"] * it["height"], "start": start,
            "end": end, "wall": end - start, "out": out,
            "error": err if out is None else None,
            "distance": st.final_distance if st is not None else None,
            "search_error": st.search_error if st is not None else None,
            "timings": {}, "profiled": hooks})
    return ({"start": start, "end": end, "wall": end - start,
             "cpu": time.process_time() - cpu,
             "phase_walls": walls, "counters": counters,
             "images": len(chunk), "profiled": hooks}, images)


def _chunks(ctx):
    n = int(ctx.traffic["batch"])
    return [ctx.items[i:i + n] for i in range(0, len(ctx.items), n)]


def warm(ctx):
    """One batch holding every image size of the deck."""
    seen = set()
    chunk = []
    for item in ctx.items:
        size = (item["width"], item["height"])
        if size not in seen:
            seen.add(size)
            chunk.append(item)
    _batch(ctx, chunk)


def window(ctx, seconds):
    """Run the window: (images, batches, start)."""
    chunks = _chunks(ctx)
    inst = ctx.inst
    rounds = int(ctx.traffic.get("trace_rounds", 4))
    fetched = [0]

    def on_zeroing(_rec):
        if not inst.profiling and inst.records is None:
            inst.start_profile()

    def on_fetch(n):
        if not inst.profiling:
            return
        ctx.sub_compares += n
        fetched[0] += 1
        if fetched[0] > rounds:
            inst.stop_profile()
    images, batches = [], []
    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    # A traced run also completes one batch the profiler does not cover:
    # the host shares are read from such batches.
    while len(batches) < (2 if ctx.traced else 1) \
            or time.perf_counter() < deadline:
        traced_batch = ctx.traced and k == 0
        if traced_batch:
            inst.on_zeroing, inst.on_fetch = on_zeroing, on_fetch
        b, ims = _batch(ctx, chunks[k % len(chunks)], traced_batch)
        inst.on_zeroing = inst.on_fetch = None
        if ctx.traced:
            b["compares"] = b["counters"].get("compares", 0)
        batches.append(b)
        images.extend(ims)
        k += 1
    return images, batches, start
