"""Entry: guetzli_tpu_torch.api.encode_bytes, one image at a time, for a
deck whose one pass outlasts the window.

The closed loop of encode_bytes.py (one client: the next image starts
when the previous one has returned), except that the window runs at
least one whole pass of the deck before the window's time can end it;
the image in flight at the deadline then completes and counts. So every
deck entry completes in every run and `bits_per_px` (one encode of each
entry) reads, also where one pass of large photos takes longer than
--seconds. The warm-up and each image's record are encode_bytes.py's.
"""

import time

from h100bench.entries import encode_bytes as _serial

warm = _serial.warm


def window(ctx, seconds):
    """Run the window: (images, batches, start)."""
    n_traced = int(ctx.traffic.get("trace_images", 1)) if ctx.traced else 0
    inst = ctx.inst
    images = []
    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    while (k < len(ctx.items) or len(images) <= n_traced
           or time.perf_counter() < deadline):
        item = ctx.items[k % len(ctx.items)]
        if k == 0 and n_traced:
            inst.start_profile()
        rec = _serial._encode(ctx, item)
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
