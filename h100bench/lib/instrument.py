"""The benchmark's own spans and counters around calls into the program.

Nothing here changes what the program computes. While installed:
  * `stats`: every ProcessStats the corpus driver makes is recorded, so
    the benchmark can read each image's in-search distance and search
    error (the serial entry passes its own ProcessStats);
and, in a traced run only:
  * `comparators`: every Comparator made, to read its `compares`;
  * a span "h100bench.zeroing#<k>" around each call into
    search.zeroing.compute_zeroing_csr, with the work its inputs need
    (lib/ops_count.zeroing_work);
  * a span "phase.<name>" around each of the program's own
    ProcessStats.timed phases;
  * a span "h100bench.fetch" around each lockstep round's
    comparator.fetch_compare_many, counting its compares;
  * the profiler of the traced sub-window (start, stop, marks).
"""

import contextlib

import numpy as np

from h100bench.lib import ops_count, trace


class Instruments:
    def __init__(self, traced):
        self.traced = traced
        self.stats = []
        self.comparators = []
        self.zeroing = []          # dicts: name, mode, evals, bytes, blocks
        self.on_zeroing = None     # hooks of the entry
        self.on_fetch = None
        self.prof = None
        self.records = None
        self._undo = []

    # -- patching ------------------------------------------------------

    def _patch(self, obj, attr, value):
        old = getattr(obj, attr)
        setattr(obj, attr, value)
        self._undo.append((obj, attr, old))
        return old

    def install(self):
        from guetzli_tpu_torch import comparator as cmp_mod
        from guetzli_tpu_torch.search import processor, zeroing
        inst = self
        base_stats = processor.ProcessStats

        class RecordedStats(base_stats):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                inst.stats.append(self)
        self._patch(processor, "ProcessStats", RecordedStats)
        if not self.traced:
            return self
        from torch.profiler import record_function

        old_init = cmp_mod.Comparator.__init__

        def init(comp, *a, **k):
            old_init(comp, *a, **k)
            inst.comparators.append(comp)
        self._patch(cmp_mod.Comparator, "__init__", init)

        old_timed = base_stats.timed

        @contextlib.contextmanager
        def timed(stats, name):
            with record_function("phase." + name), old_timed(stats, name):
                yield
        self._patch(base_stats, "timed", timed)

        old_csr = zeroing.compute_zeroing_csr

        def csr(blocks, orig_blocks, limit, aux, comp_mask, device, *a,
                **k):
            mode = k.get("mode", a[0] if a else "444")
            evals, nbytes, nb = ops_count.zeroing_work(blocks, comp_mask,
                                                       mode)
            rec = {"name": "h100bench.zeroing#%d" % len(inst.zeroing),
                   "mode": mode, "evals": evals, "bytes": nbytes,
                   "blocks": nb}
            inst.zeroing.append(rec)
            if inst.on_zeroing is not None:
                inst.on_zeroing(rec)
            with record_function(rec["name"]):
                return old_csr(blocks, orig_blocks, limit, aux, comp_mask,
                               device, *a, **k)
        self._patch(zeroing, "compute_zeroing_csr", csr)

        old_fetch = cmp_mod.fetch_compare_many

        def fetch(comps, handles):
            if inst.on_fetch is not None:
                inst.on_fetch(len(handles))
            with record_function("h100bench.fetch"):
                return old_fetch(comps, handles)
        self._patch(cmp_mod, "fetch_compare_many", fetch)
        return self

    def uninstall(self):
        while self._undo:
            obj, attr, old = self._undo.pop()
            setattr(obj, attr, old)

    # -- the profiler of the traced sub-window -------------------------

    def start_profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with record_function(trace.MARK):
            pass

    def stop_profile(self):
        import torch
        from torch.profiler import record_function
        if self.prof is None or self.records is not None:
            return
        torch.cuda.synchronize()
        with record_function(trace.MARK):
            pass
        self.prof.stop()
        self.records = trace.records_from_profiler(self.prof)
        self.prof = None

    @property
    def profiling(self):
        return self.prof is not None

    def take_compares(self):
        """Sum of `compares` of the comparators made since the last call,
        which are then dropped."""
        n = int(np.sum([c.compares for c in self.comparators])) \
            if self.comparators else 0
        self.comparators = []
        return n
