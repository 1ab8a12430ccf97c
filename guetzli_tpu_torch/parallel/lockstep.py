"""The lockstep corpus encoder: every image's search in phase.

Port of guetzli_tpu/parallel/lockstep.py. The reference encodes one
image per process and serializes a device round trip per search step.
Across a corpus those steps are independent, so each phase runs in
lockstep over every image:

  * the first compare of every image: all queued, then all fetched;
  * the quant search in rounds: every active image's trial compare is
    queued before any is fetched (lockstep_select_quant_matrix); with the
    quant tree on (config.py), every image's subtree waves are queued
    and all their scores come back in one device-to-host copy a round
    (search/quant_tree.lockstep_select_quant_matrix_tree);
  * each masking pass as ONE zeroing call over every image's blocks
    concatenated, with per-block error limits: one launch of the greedy
    kernel (B, B' or B'') and one of its compare (A, A' or A'') for the
    whole corpus (_corpus_masking);
  * the back-end loops in rounds: every image's generator advances to its
    fetch point (on a thread pool when threads > 1: the flips and the
    serialization are numpy and ctypes calls that release the GIL), then
    one combined device-to-host copy completes every compare
    (comparator.fetch_compare_many), the sparse dispatches of each
    image's resident coefficients (config.sparse) among them.

Each image keeps its own Processor and Comparator, and each decision
depends only on that image's own results, so every output equals the
serial api.encode_bytes bytes (at the same geometry) whatever the
threads' interleaving. Every comparator of a corpus shares one
CompareBatcher (comparator.py), and with it the back end's dispatches,
made on the pool's threads, only queue their compares: their device work
runs on the calling thread when the round's combined fetch reads them,
as do the masking passes' frozen state and the custom kernels (the
zeroing call): cuDNN failed once on the card, not reproduced, under
compares issued from several threads at once (PERF.md; api.encode_corpus
with threads > 1 still issues them so, ROADMAP.md section 3). A
comparator's resident back-end coefficients belong to its image: only
that image's generator updates them.

With the padded geometry on (config.auto("pad"), the serial encoders'
knob too; off by default) every comparator sits on its image's bucket
(ops/padgeom.py): the queued whole-image compares of a round -- the
first compares, the quant rounds without the tree, the back end's plain
dispatches -- run as one stacked compare per bucket, each row bit for
bit its image's single padded compare, and the zeroing call runs on
the bucket block grids and keeps the real blocks' rows
(_corpus_masking). The tree's waves and the sparse dispatches of a
resident state stay per image, as in the JAX package. The back end is not pipelined here: a round's combined fetch
already waits once for every image.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch import config, runtime
from guetzli_tpu_torch.search import zeroing
from guetzli_tpu_torch.search.processor import QuantMatrixGenerator

_TARGET_MUL_HIGH = 0.97
_TARGET_MUL_LOW = 0.95


class _QuantSearch:
    """One image's SelectQuantMatrix (processor.cc:340-372), split at the
    fetch point: the serial Processor.select_quant_matrix's decisions."""

    def __init__(self, proc, jpg_in, downsample, best_q, img):
        self.proc = proc
        self.jpg_in = jpg_in
        self.best_q = best_q
        self.img = img
        self.qgen = QuantMatrixGenerator(downsample)
        self.cur_q = best_q.copy()
        self.initial = True
        self.best = None
        self.done = False
        self.pending = None

    def dispatch(self):
        """Queue the current trial's compare and serialize its JPEG."""
        self.pending = self.proc._quant_eval_start(self.jpg_in, self.cur_q)

    def resolve(self):
        """Fetch the trial, advance the binary search and set up the next
        trial (or finish)."""
        dist_ok, size = self.proc._quant_resolve(
            self.jpg_in, self.cur_q, *self.pending, self.img,
            _TARGET_MUL_HIGH)
        self.pending = None
        if self.initial:
            self.best = (self.cur_q.copy(), dist_ok, size)
            self.initial = False
        else:
            self.qgen.add(self.cur_q, dist_ok)
            better = ((dist_ok and not self.best[1])
                      or (dist_ok == self.best[1] and size < self.best[2]))
            if better:
                self.best = (self.cur_q.copy(), dist_ok, size)
                if dist_ok and not self.proc.comparator.distance_ok(
                        _TARGET_MUL_LOW):
                    self._finish()
                    return
        qn = self.qgen.get_next()
        if qn is None:
            self._finish()
            return
        self.cur_q = qn

    def _finish(self):
        self.best_q[:] = self.best[0]
        self.done = True


def lockstep_select_quant_matrix(procs, jpgs, downsamples, best_qs, imgs):
    """Every image's quant-matrix search in lockstep rounds: each round
    queues every active image's trial, then fetches them in corpus order
    (with a CompareBatcher on the comparators, the first fetch runs the
    round's trials of each bucket as one stacked compare).

    Per-image lists; `best_qs` entries are updated in place as
    Processor.select_quant_matrix updates its best_q. Returns the
    per-image dist_ok (the serial method's return value). With the quant
    tree on for the comparators' device (config.py), the rounds are the
    tree's waves."""
    if config.auto("tree_quant", procs[0].comparator.device):
        from guetzli_tpu_torch.search.quant_tree import \
            lockstep_select_quant_matrix_tree
        return lockstep_select_quant_matrix_tree(procs, jpgs, downsamples,
                                                 best_qs, imgs)
    sms = [_QuantSearch(p, j, d, q, i)
           for p, j, d, q, i in zip(procs, jpgs, downsamples, best_qs, imgs)]
    while True:
        active = [s for s in sms if not s.done]
        if not active:
            break
        for s in active:
            s.dispatch()
        for s in active:
            s.resolve()
    return [s.best[1] for s in sms]


def encode_corpus_lockstep(inputs, quality: float = 95,
                           force_420: bool = False, try_420: bool = False,
                           use_silver_screen: bool = False, threads: int = 1,
                           phase_walls=None, device=None, counters=None):
    """Encode a corpus of PNG and JPEG images with the search in lockstep.

    inputs: (name, bytes) pairs. Each pass of the reference encoder (4:4:4,
    and 4:2:0 under force_420 or try_420, or for a 4:2:0 JPEG input --
    processor.cc:986-1016) runs across the corpus: the quant search in
    lockstep rounds, then per masking pass one zeroing call over every
    image's blocks, then the back-end rounds. `threads` sizes the pool of
    the per-image host work. `phase_walls`, a dict, accumulates the
    seconds of "quant", "zeroing" (the per-image masking state and the
    zeroing call) and "backend". `counters`, a dict, accumulates
    "compares" (the comparators' whole-image compares, a wave's trials
    each), "batched" (those run by the CompareBatcher) and "flushes" (its
    stacked compares).

    Images under 32 pixels, JPEGs the search does not take (grayscale,
    CMYK, 4:2:2, ...) and qualities below 84 go to the serial encoder. An
    image that cannot be encoded (undecodable input) is recorded as None
    after a message on stderr; the corpus goes on.
    Runs on the CUDA device unless `device` says otherwise ("cpu");
    raises RuntimeError when no GPU is present and the CPU was not asked
    for. Returns [(name, jpeg_bytes or None)] in input order."""
    from guetzli_tpu_torch import api, consts
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                    ProcessStats, _copy_jpeg,
                                                    _is_grayscale,
                                                    decode_jpeg_to_rgb)
    dev = resolve(device)
    target = consts.butteraugli_score_for_quality(quality)
    padded = config.auto("pad", dev)
    batcher = cmp_mod.CompareBatcher()
    inputs = list(inputs)
    results = [None] * len(inputs)
    ctxs = []
    for i, (name, data) in enumerate(inputs):
        params = Params(force_420=force_420, try_420=try_420,
                        use_silver_screen=use_silver_screen)
        params.butteraugli_target = target
        input_is_420 = False
        rgb = jpg_in = None
        try:
            if api.is_jpeg(data):
                # processor.cc:1029-1066: a 4:4:4 or 4:2:0 YCbCr JPEG is
                # searched from its coefficients; a 4:2:0 one forces the
                # 4:2:0 pass for that image.
                jpg_in = reader.read_jpeg(data)
                if reader.check_jpeg_sanity(jpg_in):
                    rgb = decode_jpeg_to_rgb(jpg_in)
                input_is_420 = jpg_in.is_420()
                w, h = jpg_in.width, jpg_in.height
            else:
                rgb, w, h = read_png(data)
        except (reader.JpegError, ValueError) as e:
            sys.stderr.write("%s: %s\n" % (name, e))
            continue
        if rgb is None or w < 32 or h < 32 or target > 2.0:
            try:
                results[i] = api.encode_bytes(data, quality, params,
                                              device=dev)
            except ValueError as e:
                sys.stderr.write("%s: %s\n" % (name, e))
            continue
        comp = Comparator(rgb, w, h, target, dev, padded=padded, mesh=False)
        comp.batcher = batcher
        proc = Processor(params, comp, ProcessStats())
        if jpg_in is None:
            jpg_in = encode_rgb_to_jpeg(rgb, w, h)
        # Processor.process_jpeg_data's steps before the search; the
        # first compare is queued here and fetched below.
        encoded = proc.output_jpeg(jpg_in)
        proc.final.score = -1
        jpg0 = _copy_jpeg(jpg_in)
        q_in = st.remove_original_quantization(jpg0)
        img0 = st.CoeffImage.from_jpeg(jpg0)
        ds_lo = 1 if (input_is_420 or force_420) else 0
        ds_hi = 1 if (input_is_420 or force_420
                      or (try_420 and not _is_grayscale(jpg_in))) else 0
        ctxs.append({"index": i, "proc": proc, "jpg_in": jpg_in,
                     "q_in": q_in, "ds_lo": ds_lo, "ds_hi": ds_hi,
                     "first": (img0, encoded,
                               comp.dispatch_compare(img0))})
    for c in ctxs:
        proc = c["proc"]
        img0, encoded, pending = c.pop("first")
        d = proc._recoverable(
            lambda p=proc, m=img0: p.comparator.dispatch_compare(m),
            proc.comparator.fetch_compare_plain, pending)
        proc.stats.log(" BA[100.00%%] D[%6.4f]", d)
        proc.maybe_output(encoded)

    for downsample in (0, 1):
        batch = [c for c in ctxs if c["ds_lo"] <= downsample <= c["ds_hi"]]
        if not batch:
            continue
        procs, jpgs, imgs, best_qs = [], [], [], []
        for c in batch:
            jpg = _copy_jpeg(c["jpg_in"])
            st.remove_original_quantization(jpg)
            img = st.CoeffImage.from_jpeg(jpg)
            if downsample:
                if img.comps[1].factor_x == 1 and img.comps[1].factor_y == 1:
                    img.downsample(use_silver_screen=use_silver_screen)
                jpg = img.save_to_jpeg_data(jpg)
            procs.append(c["proc"])
            jpgs.append(jpg)
            imgs.append(img)
            best_qs.append(c["q_in"].copy())
        t0 = time.time()
        oks = lockstep_select_quant_matrix(
            procs, jpgs, [downsample != 0] * len(batch), best_qs, imgs)
        _add_wall(phase_walls, "quant", t0)
        for i, ok in enumerate(oks):
            if not ok:
                best_qs[i][:] = 1
            imgs[i].comps = st.CoeffImage.from_jpeg(jpgs[i]).comps
            imgs[i].apply_global_quantization(best_qs[i])
        trip = list(zip(procs, jpgs, imgs))
        if not downsample:
            _corpus_masking(trip, 7, [1.0] * len(batch), False, threads,
                            phase_walls)
        else:
            ymuls = [1.0 if len(j.components) == 1 else 0.97 for j in jpgs]
            _corpus_masking(trip, 1, ymuls, False, threads, phase_walls)
            _corpus_masking(trip, 6, [1.0] * len(batch), True, threads,
                            phase_walls)

    for c in ctxs:
        results[c["index"]] = c["proc"].final.jpeg_data
    if counters is not None:
        for key, n in (("compares", sum(c["proc"].comparator.compares
                                        for c in ctxs)),
                       ("batched", batcher.rows),
                       ("flushes", batcher.flushes)):
            counters[key] = counters.get(key, 0) + n
    return [(name, out) for (name, _data), out in zip(inputs, results)]


def _add_wall(phase_walls, key, t0):
    if phase_walls is not None:
        phase_walls[key] = phase_walls.get(key, 0.0) + (time.time() - t0)


def _pool_map(fn, items, threads):
    """list(map(fn, items)), on a pool of up to `threads` threads."""
    if threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(threads, len(items))) as pool:
        return list(pool.map(fn, items))


def _corpus_masking(trip, comp_mask, target_muls, stop_early, threads=1,
                    phase_walls=None):
    """One masking pass across the corpus: per-image inputs (on the pool)
    and frozen state (its device work on the calling thread), ONE zeroing
    call over the concatenated blocks with per-block limits, then the
    back-end loops in lockstep rounds. `trip`: (proc, jpg, img) per
    image. Per-block math is independent of the other blocks of the
    launch, so every image's candidates equal those of its own serial
    pass bit for bit."""
    t_zero = time.time()

    def prep(args):
        proc, jpg, img = args
        grid = img.comps[comp_mask.bit_length() - 1]
        blocks, orig, real = proc.padded_masking_inputs(
            *proc.masking_inputs(jpg, img, comp_mask), grid)
        if real is None:
            real = np.arange(len(blocks), dtype=np.int64)
        return blocks, orig, grid, real

    per = []
    for (proc, _jpg, img), (blocks, orig, grid, real) in zip(
            trip, _pool_map(prep, trip, threads)):
        mode, aux = proc.masking_aux(img, comp_mask, grid)
        per.append((blocks, orig, mode, aux,
                    np.float32(proc.comparator.block_error_limit()), real))
    # One image can keep 4:4:4 geometry in the 4:2:0 pass (a grayscale
    # image's all-zero chroma is not downsampled): one zeroing call per
    # mode.
    modes = sorted({p[2] for p in per})
    if len(modes) > 1:
        for m in modes:
            idx = [i for i, p in enumerate(per) if p[2] == m]
            _corpus_masking([trip[i] for i in idx], comp_mask,
                            [target_muls[i] for i in idx], stop_early,
                            threads, phase_walls)
        return
    mode = modes[0]
    # Each image's rows: its blocks (on its bucket grid when padded), of
    # which the real ones, `real`, give its rows of the CSR.
    rows = [len(p[0]) for p in per]
    counts = [len(p[5]) for p in per]
    cat_blocks = np.concatenate([p[0] for p in per])
    cat_orig = np.concatenate([p[1] for p in per])
    cat_aux = tuple(torch.cat([p[3][k] for p in per])
                    for k in range(len(per[0][3])))
    limits = np.concatenate([np.full(n, p[4], np.float32)
                             for n, p in zip(rows, per)])
    starts = np.cumsum([0] + rows[:-1])
    real_index = np.concatenate([s + p[5] for s, p in zip(starts, per)])
    p0 = trip[0][0]
    kw = dict(mode=mode, real_index=real_index,
              lookahead=p0.params.zeroing_greedy_lookahead,
              new_model=p0.params.new_zeroing_model,
              early_exit=p0.params.zeroing_early_exit)
    for attempt in range(runtime.ATTEMPTS):
        try:
            if config.staged_zeroing():
                cat_off, cat_idx, cat_err = zeroing.compute_zeroing_csr(
                    cat_blocks, cat_orig, limits, cat_aux, comp_mask,
                    p0.comparator.device, **kw)
            else:
                # The full-batch route (GUETZLI_TPU_STAGED_ZEROING=0),
                # its CSR on the host at each row's limit.
                out_idx, out_err, num = zeroing.compute_zeroing_order(
                    cat_blocks, cat_orig, limits, cat_aux, comp_mask,
                    p0.comparator.device, **kw)
                cat_off, cat_idx, cat_err = zeroing.csr_from_zeroing(
                    out_idx, out_err, num, limits[real_index])
                del out_idx, out_err, num
            break
        except runtime.RECOVERABLE:
            if attempt == runtime.ATTEMPTS - 1:
                raise
            # The operands stay referenced by cat_aux: free the cache
            # and run the call again.
            runtime.release_memory(p0.comparator.device, "corpus zeroing")
    del cat_blocks, cat_orig, cat_aux, per
    _add_wall(phase_walls, "zeroing", t_zero)
    t_back = time.time()

    gens = []
    row0 = 0
    for (proc, jpg, img), mul, n in zip(trip, target_muls, counts):
        lo, hi = cat_off[row0], cat_off[row0 + n]
        offsets = cat_off[row0:row0 + n + 1] - lo
        proc.stats.inc("zeroing_passes")
        proc.comparator.finish_block_comparisons()
        gens.append((proc, proc.back_end_steps(
            jpg, img, comp_mask, mul, stop_early, offsets,
            cat_idx[lo:hi], cat_err[lo:hi])))
        row0 += n

    def advance(item):
        """Run a generator to its next fetch point: its handle, or None
        when its loop has ended."""
        gen, result = item
        try:
            return gen.send(result) if result is not None else next(gen)
        except StopIteration:
            return None

    steps = _pool_map(advance, [(g, None) for _p, g in gens], threads)
    active = [(p, g, h) for (p, g), h in zip(gens, steps) if h is not None]
    while active:
        comps = [p.comparator for p, _g, _h in active]
        handles = [h for _p, _g, h in active]
        try:
            results = cmp_mod.fetch_compare_many(comps, handles)
        except runtime.RECOVERABLE:
            runtime.release_memory(comps[0].device, "the corpus back end")
            results = [p._recoverable(
                lambda p=p, h=h: p.comparator.replay(h),
                p.comparator.fetch_compare, h) for p, _g, h in active]
        steps = _pool_map(advance, [(g, r) for (_p, g, _h), r
                                    in zip(active, results)], threads)
        active = [(p, g, h) for (p, g, _h), h in zip(active, steps)
                  if h is not None]
    _add_wall(phase_walls, "backend", t_back)
