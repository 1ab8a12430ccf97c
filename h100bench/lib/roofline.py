"""The zeroing search's share of its roofline, from the traced spans.

Work: for each call into search.zeroing.compute_zeroing_csr that the
profiler covered, the evaluations and bytes its inputs need
(lib/ops_count.zeroing_work), and their least time (ops_count.bound_s:
operations over the float32 peak or bytes over the memory rate, the
larger). Time: the union of the device activities launched inside that
call's span. The share is the summed least time over the summed device
time of the calls of the given modes, in percent; None when no such
call was traced."""

from h100bench.lib import ops_count


def share(rec, modes):
    tr = rec["trace"]
    if not tr:
        return None
    calls = [z for z in tr["zeroing"] if z["mode"] in modes
             and z["device_s"] > 0]
    if not calls:
        return None
    least = sum(ops_count.bound_s(z["mode"], z["evals"], z["bytes"])[0]
                for z in calls)
    return 100.0 * least / sum(z["device_s"] for z in calls)
