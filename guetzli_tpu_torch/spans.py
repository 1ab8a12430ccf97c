"""The program's host spans: one timer for the search's phases
(ProcessStats.timed), the corpus driver's phase walls and the
comparator's compare spans.

timed(walls, name) adds the wall seconds of its block (time.time()) to
walls[name]; walls None adds nothing. While a torch.profiler session is
active it also opens record_function("phase." + name), so the phases
are events of the profiler's own trace (`--profile DIR`). The profiler
stamps its host events on the epoch clock, not on time.perf_counter's:
a span lines up with the device's activity only as an event of the same
trace. With no profiler running a span costs one flag check, two clock
reads and a dict update.
"""

import time
from contextlib import contextmanager, nullcontext

import torch
from torch.profiler import record_function


@contextmanager
def timed(walls, name):
    """Accumulate the wall time of the block under walls[name] (walls
    may be None), inside a "phase.<name>" profiler range when a profiler
    is active."""
    with (record_function("phase." + name)
          if torch.autograd._profiler_enabled() else nullcontext()):
        t0 = time.time()
        try:
            yield
        finally:
            if walls is not None:
                walls[name] = walls.get(name, 0.0) + time.time() - t0
