"""The whole-image compare dispatches that replayed a CUDA graph, as a
share of all of them, in percent: the corpus driver's
counters["compare_graph_replays"] over the sum of
"compare_graph_captures", "compare_graph_replays" and "compare_eager",
over the window's batches that the profiler did not cover. Nothing
where the program keeps no such counters."""

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"

KEYS = ("compare_graph_captures", "compare_graph_replays", "compare_eager")


def read(rec):
    bs = [b for b in rec["batches"] if not b["profiled"]
          and any(k in b.get("counters", {}) for k in KEYS)]
    total = sum(b["counters"].get(k, 0) for b in bs for k in KEYS)
    if not total:
        return None
    return 100.0 * sum(b["counters"].get("compare_graph_replays", 0)
                       for b in bs) / total
