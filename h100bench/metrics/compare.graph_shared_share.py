"""The whole-image compare dispatches that replayed a CUDA graph
another comparator captured, as a share of all of them, in percent:
the corpus driver's counters["compare_graph_shared"] over the sum of
"compare_graph_captures", "compare_graph_replays" and "compare_eager",
over the window's batches that the profiler did not cover. Nothing
where the program keeps no such counter."""

UNIT = "%"
LAYER = "comparator (comparator.py)"
MOVES = "mpix_per_s"

KEYS = ("compare_graph_captures", "compare_graph_replays", "compare_eager")
SHARED = "compare_graph_shared"


def read(rec):
    bs = [b for b in rec["batches"] if not b["profiled"]
          and SHARED in b.get("counters", {})]
    total = sum(b["counters"].get(k, 0) for b in bs for k in KEYS)
    if not total:
        return None
    return 100.0 * sum(b["counters"][SHARED] for b in bs) / total
