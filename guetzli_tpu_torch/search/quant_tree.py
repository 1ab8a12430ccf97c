"""The quant-matrix search in waves over its binary-search tree.

Port of guetzli_tpu/search/quant_tree.py. SelectQuantMatrix
(processor.cc:340-372) is a data-dependent loop, but the next candidate
depends only on the (matrix, distance_ok) history, through
QuantMatrixGenerator arithmetic, never on the raw distances. So the
candidates are enumerable on the host: cloning the generator down both
outcome branches gives every matrix the search could visit in the next
`depth` iterations.

TreeQuantSearch scores those candidates in waves: the unscored matrices
of the upcoming subtree go to the device as one batched compare that
requantizes on the device from the resident base coefficients
(Comparator.dispatch_quant_batch: 768 bytes of matrix per trial instead
of the coefficient planes), and the scores come back in one copy. Then
the serial loop is replayed exactly -- the same trial order, logs,
MaybeOutput sequence and generator updates -- with each distance read
from the memo. A batched trial's score equals its single compare bit for
bit, so the decisions are the serial loop's.

Two drivers share the state machine:
  * select_quant_matrix_tree: one image, a dispatch and a fetch per wave
    (Processor.select_quant_matrix takes it wherever the comparator
    supports_quant_batch, which is everywhere but under a mesh);
  * lockstep_select_quant_matrix_tree: a corpus; every active image's
    waves are dispatched first, then every score comes back in one
    device-to-host copy per round (parallel/lockstep.py).

A failed wave is replayed through Processor._recoverable (runtime.py);
it never falls back to serial trials. A padded comparator (config.pad)
runs its waves on its bucket (Comparator.dispatch_quant_batch), each
trial bit for bit its single padded compare; waves stay per image, also
in a corpus whose other compares go through a CompareBatcher.
"""

import numpy as np
import torch

from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch import runtime
from guetzli_tpu_torch.search import state as st

_TARGET_MUL_HIGH = 0.97
_TARGET_MUL_LOW = 0.95


def _enumerate_subtree(qgen, cur_q, initial, depth):
    """Every matrix the serial loop could visit within `depth` iterations
    from (generator state, current trial), depth first over the outcome
    branches; the generators are cloned, the caller's is untouched."""
    out = []
    seen = set()
    stack = [(qgen, cur_q, initial, 0)]
    while stack:
        g, q, init, d = stack.pop()
        key = q.tobytes()
        if key not in seen:
            seen.add(key)
            out.append(q)
        if d >= depth:
            continue
        # The initial trial is never added to the generator
        # (processor.cc:344-352): both outcomes share one successor.
        for outcome in ((True,) if init else (True, False)):
            g2 = g.clone()
            if not init:
                g2.add(q, outcome)
            qn = g2.get_next()
            if qn is not None:
                stack.append((g2, qn, False, d + 1))
    return out


class TreeQuantSearch:
    """One image's SelectQuantMatrix as a resumable state machine:
    dispatch_waves() queues the batched compares of the upcoming
    subtree, absorb() memoizes their scores, replay() advances the serial
    loop until it needs an unscored matrix or finishes (setting best_q).
    """

    def __init__(self, proc, jpg_in, downsample, best_q, img, depth=3):
        from guetzli_tpu_torch.search.processor import QuantMatrixGenerator
        self.proc = proc
        self.jpg_in = jpg_in
        self.img = img
        self.depth = depth
        self.best_q_out = best_q
        self.base_img = st.CoeffImage.from_jpeg(jpg_in)
        self.base = proc.comparator.quant_base_upload(self.base_img)
        self.memo = {}              # q bytes -> (score, handle, row)
        self.qgen = QuantMatrixGenerator(downsample)
        self.cur_q = best_q.copy()
        self.initial = True
        self.best = None
        self.done = False

    def dispatch_waves(self):
        """Queue one batched compare per wave of unscored subtree
        matrices, each dispatch with the runtime's replay; returns
        [(handle, chunk)] for fetch() and absorb()."""
        comp = self.proc.comparator
        fresh, seen = [], set()
        for q in _enumerate_subtree(self.qgen, self.cur_q, self.initial,
                                    self.depth):
            k = q.tobytes()
            if k not in self.memo and k not in seen:
                seen.add(k)
                fresh.append(q)
        wave = comp.quant_batch_sizes()[-1]
        pending = []
        with self.proc.stats.timed("quant_device"):
            for i in range(0, len(fresh), wave):
                chunk = fresh[i:i + wave]
                handle = self.proc._recoverable(self._dispatcher(chunk),
                                                lambda h: h)
                pending.append((handle, chunk))
                self.proc.stats.inc("quant_waves")
                self.proc.stats.inc("quant_wave_trials", len(chunk))
        return pending

    def _dispatcher(self, chunk):
        return lambda: self.proc.comparator.dispatch_quant_batch(
            self.base, chunk)

    def fetch(self, pending):
        """Each wave's scores, with the runtime's replay."""
        comp = self.proc.comparator
        with self.proc.stats.timed("quant_device"):
            return [self.proc._recoverable(self._dispatcher(chunk),
                                           comp.fetch_quant_scores, handle)
                    for handle, chunk in pending]

    def absorb(self, pending, scores_per_wave):
        """Memoize fetched scores; scores_per_wave[i] aligns with
        pending[i]'s chunk."""
        for (handle, chunk), scores in zip(pending, scores_per_wave):
            for j, q in enumerate(chunk):
                self.memo[q.tobytes()] = (float(scores[j]), handle, j)

    def replay(self):
        """Replay serial iterations (TryQuantMatrix, processor.cc:310-338)
        from the memo: host requantization (bit for bit the device's),
        serialization, the reference's log lines and MaybeOutput, in the
        serial order. Stops at a memo miss (False: dispatch more) or at
        the search's end (True: best_q is set)."""
        from guetzli_tpu_torch.search.processor import (
            _frame_type_str, quant_matrix_heuristic_score)
        proc, comp = self.proc, self.proc.comparator
        while True:
            key = self.cur_q.tobytes()
            if key not in self.memo:
                return False
            score, handle, row = self.memo[key]

            with proc.stats.timed("quant_host"):
                trial = self.base_img.copy()
                trial.apply_global_quantization(self.cur_q)
                self.img.comps = trial.comps
                encoded = proc.output_jpeg(
                    trial.save_to_jpeg_data(self.jpg_in))
            proc.stats.inc("iters")
            proc.stats.inc("quant_trials")
            proc.stats.log("Iter %2d: %s quantization matrix:\n",
                           proc.stats.counters["iters"],
                           _frame_type_str(self.img))
            proc.stats.log_quant(self.cur_q)
            proc.stats.log("Iter %2d: %s GQ[%5.2f] Out[%7d]",
                           proc.stats.counters["iters"],
                           _frame_type_str(self.img),
                           quant_matrix_heuristic_score(self.cur_q),
                           len(encoded))
            comp.set_quant_result(handle, row, score)
            proc.stats.log(" BA[100.00%%] D[%6.4f]", comp.distance)
            dist_ok = comp.distance_ok(_TARGET_MUL_HIGH)
            proc.maybe_output(encoded)
            size = len(encoded)

            if self.initial:
                self.best = (self.cur_q.copy(), dist_ok, size)
                self.initial = False
            else:
                self.qgen.add(self.cur_q, dist_ok)
                better = ((dist_ok and not self.best[1])
                          or (dist_ok == self.best[1]
                              and size < self.best[2]))
                if better:
                    self.best = (self.cur_q.copy(), dist_ok, size)
                    if dist_ok and not comp.distance_ok(_TARGET_MUL_LOW):
                        break
            qn = self.qgen.get_next()
            if qn is None:
                break
            self.cur_q = qn
        self.best_q_out[:] = self.best[0]
        # The wave handles, the resident base and its host copy are only
        # needed while trials are issued. The comparator's distmap is not
        # touched by the quant phase (set_quant_result).
        self.memo.clear()
        self.base = None
        self.base_img = None
        self.done = True
        return True


def select_quant_matrix_tree(proc, jpg_in, downsample, best_q, img,
                             depth=3):
    """Processor.select_quant_matrix in waves: the same result, best_q,
    logs and outputs. Returns dist_ok of the best trial."""
    sm = TreeQuantSearch(proc, jpg_in, downsample, best_q, img, depth)
    while not sm.done:
        pending = sm.dispatch_waves()
        sm.absorb(pending, sm.fetch(pending))
        sm.replay()
    return sm.best[1]


def lockstep_select_quant_matrix_tree(procs, jpgs, downsamples, best_qs,
                                      imgs, depth=3):
    """A corpus's quant searches in lockstep rounds: each round every
    active image dispatches its subtree waves (the base coefficients are
    resident), then every wave's scores come back in one device-to-host
    copy, then each image replays its serial iterations. Each image's
    decisions, logs and MaybeOutput order are those of its serial tree
    search, hence of its serial loop. Returns the per-image dist_ok."""
    sms = [TreeQuantSearch(p, j, d, q, i, depth)
           for p, j, d, q, i in zip(procs, jpgs, downsamples, best_qs,
                                    imgs)]
    while True:
        active = [s for s in sms if not s.done]
        if not active:
            break
        pend = [(s, s.dispatch_waves()) for s in active]
        timings = active[0].proc.comparator.timings
        try:
            with cmp_mod.dispatch_span(timings):
                flat = torch.cat([h[0][:h[1]] for _s, p in pend
                                  for h, _c in p])
            with cmp_mod.wait_span(timings):
                flat = flat.cpu().numpy()
        except runtime.RECOVERABLE:
            runtime.release_memory(active[0].proc.comparator.device,
                                   "the corpus quant waves")
            for s, p in pend:
                s.absorb(p, s.fetch(p))
                s.replay()
            continue
        pos = 0
        for s, p in pend:
            scores = []
            for h, _c in p:
                scores.append(flat[pos:pos + h[1]].astype(np.float64))
                pos += h[1]
            s.absorb(p, scores)
            s.replay()
    return [s.best[1] for s in sms]
