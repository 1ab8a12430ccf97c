"""Reduction of a torch.profiler trace to the benchmark's device numbers.

The arithmetic of guetzli_tpu_torch/trace_encode.py as of commit bfd8995
(device activities are kernels, copies and sets, from the profiler's
CUDA activity), with two changes: the busy time is the union of the
device intervals inside the traced sub-window, not their sum, and the
sub-window is one the benchmark marks, not a whole encode.

The input is a list of plain records, one per profiler event, so that
the arithmetic runs (and is tested) without a card:
  (name, kind, start_ns, end_ns, thread)
kind: "device" (a kernel, copy or set on the card), "runtime" (a CUDA
runtime call on the host), "span" (a record_function range of the
benchmark: h100bench.*, phase.*) or "op" (any other host event).
"""

import bisect

MARK = "h100bench.mark"


def is_kernel(name):
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def records_from_profiler(prof):
    """The plain records of a finished torch.profiler.profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = "CUDA" in str(e.device_type())
        bench = name.startswith("h100bench.") or name.startswith("phase.")
        if dev and not bench and not e.is_user_annotation():
            kind = "device"
        elif dev:
            continue        # the card-side copy of a host annotation
        elif bench:
            kind = "span"
        elif name.startswith("cuda") or name.startswith("cu"):
            kind = "runtime"
        else:
            kind = "op"
        start = e.start_ns()
        out.append((name, kind, start, start + e.duration_ns(),
                    e.start_thread_id()))
    return out


def union(intervals, lo=None, hi=None):
    """Total length of the union of (start, end) intervals, clipped to
    [lo, hi] when given."""
    total = 0
    end = None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps of [lo, hi] between the intervals."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def window_of(records):
    """(lo, hi, thread) of the traced sub-window: from the first mark's
    start to the last mark's end."""
    marks = [r for r in records if r[0] == MARK]
    if len(marks) < 2:
        return None
    return (min(r[2] for r in marks), max(r[3] for r in marks), marks[0][4])


def span_device_ns(records, names):
    """{span name: ns}: for each span named in `names`, the union of the
    device activities that ran wholly inside it. A span that ends by
    copying its result to the host (as the zeroing search does) has
    finished the device work it launched; device work queued before it
    and still running at its start is left out."""
    spans = [r for r in records if r[1] == "span" and r[0] in names]
    dev = sorted((r[2], r[3]) for r in records if r[1] == "device")
    starts = [d[0] for d in dev]
    out = {}
    for sp in spans:
        i0 = bisect.bisect_left(starts, sp[2])
        i1 = bisect.bisect_right(starts, sp[3])
        ivals = [d for d in dev[i0:i1] if d[1] <= sp[3]]
        out[sp[0]] = out.get(sp[0], 0) + union(ivals)
    return out


def _label_points(records, thread, points):
    """For each time in `points` (sorted), the innermost benchmark span
    and the innermost host op of `thread` around it, as one label."""
    nest = sorted((r for r in records
                   if r[4] == thread and r[1] in ("span", "op", "runtime")
                   and r[0] != MARK),
                  key=lambda r: (r[2], -r[3]))
    labels = []
    stack = []
    i = 0
    for t in points:
        while i < len(nest) and nest[i][2] <= t:
            r = nest[i]
            while stack and stack[-1][3] < r[2]:
                stack.pop()
            stack.append(r)
            i += 1
        while stack and stack[-1][3] < t:
            stack.pop()
        span = next((r[0] for r in reversed(stack) if r[1] == "span"),
                    "outside spans")
        op = stack[-1][0] if stack and stack[-1][1] != "span" else "python"
        labels.append("%s | %s" % (span, op[:60]))
    return labels


def reduce(records, top=10):
    """Device numbers of the traced sub-window: window_s, busy_s,
    kernels (launches that ran), device_ops and idle_gaps (top `top`,
    [name, seconds]), or None when the trace holds no sub-window."""
    win = window_of(records)
    if win is None:
        return None
    lo, hi, thread = win
    dev = [r for r in records if r[1] == "device" and r[3] > lo
           and r[2] < hi]
    ivals = [(r[2], r[3]) for r in dev]
    busy = union(ivals, lo, hi)
    by_name = {}
    for r in dev:
        key = r[0][:120]
        by_name[key] = by_name.get(key, 0) + (min(r[3], hi) - max(r[2], lo))
    idle = gaps(ivals, lo, hi)
    mids = [(s + e) // 2 for s, e in idle]
    order = sorted(range(len(mids)), key=lambda k: mids[k])
    labels = _label_points(records, thread, [mids[k] for k in order])
    by_label = {}
    for k, lab in zip(order, labels):
        s, e = idle[k]
        by_label[lab] = by_label.get(lab, 0) + (e - s)

    def top_list(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernels": sum(1 for r in dev if is_kernel(r[0])),
            "device_ops": top_list(by_name), "idle_gaps": top_list(by_label)}
