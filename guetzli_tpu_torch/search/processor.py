"""The Guetzli search: quant-matrix search + frequency masking, 4:4:4 and
4:2:0, from pixels or from a JPEG's coefficients.

Port of guetzli_tpu/search/processor.py (guetzli/processor.cc). The
orchestration (binary search over quant matrices, the up/down coefficient
adjustment loop, output selection) stays on the host as the reference
keeps it:

  * TryQuantMatrix (processor.cc:310-338) -> the trials of the next
    three search steps as batched compares that requantize on the device
    (search/quant_tree.py), replayed on the host in the serial loop's
    order;
  * ComputeBlockZeroingOrder loop (:376-487, :643-671) -> one greedy
    zeroing kernel over all blocks (search/zeroing.py): one pass for
    4:4:4, a Y pass and a chroma pass for 4:2:0;
  * the back-end up/down loop (:723-919) -> host loop with a device
    compare + block weights per iteration and native C++ flips; in the
    4:4:4 pass the coefficients stay on the device, updated by each
    iteration's flipped coefficients.

The route follows what the comparator can take: the waves where
Comparator.supports_quant_batch holds and the resident coefficients
where supports_sparse does, which is everywhere but under a mesh.
Under a mesh the quant search is the serial loop (one host
requantization and one whole-image compare per trial,
select_quant_matrix_serial) and every back-end compare uploads the
whole planes. Both routes give the same bytes.
"""

import ctypes
import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from guetzli_tpu_torch import config, consts, native, runtime, spans
from guetzli_tpu_torch.codec import histograms as hg
from guetzli_tpu_torch.codec import jpeg_data as jd
from guetzli_tpu_torch.codec import writer as jwriter
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.kernels import tile_compare
from guetzli_tpu_torch.search import quant_tree
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing

@dataclass
class Params:
    """processor.h:34-42."""
    butteraugli_target: float = 1.0
    clear_metadata: bool = True
    try_420: bool = False
    force_420: bool = False
    use_silver_screen: bool = False
    zeroing_greedy_lookahead: int = 3
    new_zeroing_model: bool = True
    # The reference's --c fast path stops each block's greedy zeroing once
    # its error reaches the block error limit (processor.cc:458-465).
    zeroing_early_exit: bool = False


@dataclass
class GuetzliOutput:
    jpeg_data: bytes = b""
    score: float = -1.0


@dataclass
class ProcessStats:
    counters: dict = field(default_factory=dict)
    timings: dict = field(default_factory=dict)
    debug: bool = False
    # Set when the search threw and the fallback output was emitted
    # instead (processor.cc:965-977 resilience model); a benchmark must
    # report this as a failure, not a timing.
    search_error: str = None
    # In-search butteraugli distance of the emitted output (None when the
    # image was too small to compare).
    final_distance: float = None

    def inc(self, name, amount=1):
        self.counters[name] = self.counters.get(name, 0) + amount

    def timed(self, name):
        """Accumulate the wall time of the block under timings[name]
        (spans.timed: a "phase.<name>" profiler range too while a
        profiler runs)."""
        return spans.timed(self.timings, name)

    def log(self, fmt, *args):
        if self.debug:
            sys.stderr.write(fmt % args if args else fmt)

    def log_quant(self, q):
        """GUETZLI_LOG_QUANT (debug_print.h:37-47)."""
        if not self.debug:
            return
        q = np.asarray(q).reshape(3, 64)
        for y in range(8):
            row = "   ".join(
                " ".join("%2d" % q[c, y * 8 + x] for x in range(8))
                for c in range(3))
            sys.stderr.write("  " + row + "\n")


# Host memory returns of a large encode (return_memory): every 8th
# back-end iteration from this many blocks (1.05 MPix), and once after a
# zeroing pass whose blocks' 192 coefficients take this many bytes
# (5.59 MPix).
RETURN_MEMORY_BLOCKS = 1 << 14
RETURN_MEMORY_PASS_BYTES = 16 << 20
# The spans every encode's timings hold from its start, at 0.0 until
# they run: a healthy large encode reads 0 for "recover", one whose
# compares all replay graphs cached before it 0 for "compare_capture";
# "compare_upload" and "input_decode" read 0 where nothing ran them (an
# image too small to compare; pixels api.encode_corpus decoded ahead).
ENCODE_SPANS = ("return_memory", "recover", "compare_capture",
                "compare_upload", "input_decode")
# ProcessStats.counters the corpus driver sums over its images.
SEARCH_COUNTERS = ("quant_waves", "quant_wave_trials", "oom_recoveries",
                   "return_memory_calls", "flips", "flip_code_rebuilds")


def return_memory(collect=True):
    """Hand freed host memory back to the OS: a garbage collection (with
    `collect`) and glibc's malloc_trim, which returns its arenas' free
    pages (JAX processor.py's two RSS returns of a large encode). A libc
    without malloc_trim is left alone."""
    if collect:
        gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def compare_quant_matrices(a, b):
    """processor.cc:168-190 lexicographic dominance compare on [192]."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    if np.array_equal(a, b):
        return 0
    if np.all(a <= b):
        return -1
    if np.all(a >= b):
        return 1
    return 2


def quant_matrix_heuristic_score(q):
    """processor.cc:196-204, accumulated in the reference's exact
    operation order (c-major, k-minor sequential double adds): a last-ulp
    difference flips `score > 0.0` decisions inside _q_for_score."""
    cs = 1.0 / (1.0 + consts.JPEG_ZIGZAG_ORDER.astype(np.float64) / 2.0)
    terms = 0.5 * (np.asarray(q, np.float64).reshape(3, 64) - 1.0) * cs
    score = 0.0
    for c in range(3):
        for k in range(64):
            score += terms[c, k]
    return score


class QuantMatrixGenerator:
    """Binary search over the heuristic CSF score (processor.cc:206-308)."""

    def __init__(self, downsample):
        self.downsample = downsample
        self.hscore_a = -1.0
        self.hscore_b = -1.0
        self.total_csf = consts.TOTAL_CSF
        self.quants = []          # list of (q, dist_ok)

    def _q_for_score(self, score):
        """processor.cc:284-294."""
        q = np.zeros((3, 64), dtype=np.int32)
        level = int(score / self.total_csf)
        score -= level * self.total_csf
        nat = consts.JPEG_NATURAL_ORDER
        cs = 1.0 / (1.0 + consts.JPEG_ZIGZAG_ORDER.astype(np.float64) / 2.0)
        for k in range(63, -1, -1):
            q[:, nat[k]] = 2 * level + (3 if score > 0.0 else 1)
            score -= 3.0 * cs[nat[k]]
        return q

    def get_next(self):
        for _ in range(1000):
            if self.hscore_b == -1.0:
                if self.hscore_a == -1.0:
                    hscore = 0.0 if self.downsample else self.total_csf
                else:
                    if self.hscore_a < 5.0 * self.total_csf:
                        hscore = self.hscore_a + self.total_csf
                    else:
                        hscore = 2 * (self.hscore_a + self.total_csf)
                if hscore > 100 * self.total_csf:
                    return None
            elif self.hscore_b == 0.0:
                return None
            elif self.hscore_a == -1.0:
                hscore = 0.0
            else:
                eps = 0.05
                mid = 0.5 * (self.hscore_a + self.hscore_b)
                lower = self._q_for_score((1 - eps) * self.hscore_a
                                          + eps * mid)
                upper = self._q_for_score((1 - eps) * self.hscore_b
                                          + eps * mid)
                if compare_quant_matrices(lower, upper) == 0:
                    return None
                hscore = mid
            q = self._q_for_score(hscore)
            retry = False
            for prev_q, dist_ok in self.quants:
                if compare_quant_matrices(q, prev_q) == 0:
                    if dist_ok:
                        self.hscore_a = hscore
                    else:
                        self.hscore_b = hscore
                    retry = True
                    break
            if not retry:
                return q
        return None

    def clone(self):
        g = QuantMatrixGenerator(self.downsample)
        g.hscore_a = self.hscore_a
        g.hscore_b = self.hscore_b
        g.quants = list(self.quants)
        return g

    def add(self, q, dist_ok):
        self.quants.append((q.copy(), dist_ok))
        hscore = quant_matrix_heuristic_score(q)
        if dist_ok:
            self.hscore_a = max(self.hscore_a, hscore)
        else:
            self.hscore_b = (hscore if self.hscore_b == -1.0
                             else min(self.hscore_b, hscore))


class Processor:
    def __init__(self, params: Params, comparator, stats: ProcessStats):
        self.params = params
        self.comparator: Comparator = comparator
        self.stats = stats
        self.final = GuetzliOutput()
        for name in ENCODE_SPANS if stats is not None else ():
            stats.timings.setdefault(name, 0.0)

    def output_jpeg(self, jpg, dc_histograms=None,
                    ac_histograms=None) -> bytes:
        return jwriter.write_jpeg(jpg, self.params.clear_metadata,
                                  dc_histograms, ac_histograms)

    def maybe_output(self, encoded: bytes):
        score = self.comparator.score_output_size(len(encoded))
        self.stats.log(" Score[%.4f]", score)
        if score < self.final.score or self.final.score < 0:
            self.final.jpeg_data = encoded
            self.final.score = score
            self.stats.final_distance = self.comparator.distance
            self.stats.log(" (*)")
        self.stats.log("\n")

    def _recoverable(self, dispatch_fn, fetch_fn, pending=None):
        """fetch_fn(pending), dispatching first when `pending` is None, with
        recovery from a recoverable device error (runtime.py): free the
        allocator's cache, rebuild the comparator's device state and replay
        the deterministic dispatch on the same device, up to
        runtime.ATTEMPTS tries. Any other error propagates, and under a
        mesh every error does: one rank's replay would leave its peers'
        collectives unmatched."""
        if self.comparator.mesh is not None:
            return fetch_fn(dispatch_fn() if pending is None else pending)
        for attempt in range(runtime.ATTEMPTS):
            try:
                if pending is None:
                    pending = dispatch_fn()
                return fetch_fn(pending)
            except runtime.RECOVERABLE:
                if attempt == runtime.ATTEMPTS - 1:
                    raise
                self.recover("a compare")
                pending = None

    def recover(self, what):
        """The recovery from a recoverable device error during `what`:
        free the device's memory and rebuild the comparator's device
        state, under the "recover" span, counted as oom_recoveries."""
        with self.stats.timed("recover"):
            runtime.release_memory(self.comparator.device, what)
            self.comparator.recover_device_state()
        self.stats.inc("oom_recoveries")

    def return_memory(self, collect=True):
        """return_memory(collect) under the "return_memory" span, counted
        as return_memory_calls."""
        with self.stats.timed("return_memory"):
            return_memory(collect)
        self.stats.inc("return_memory_calls")

    def _compare(self, img: st.CoeffImage):
        d = self._recoverable(
            lambda: self.comparator.dispatch_compare(img),
            self.comparator.fetch_compare_plain)
        self.stats.log(" BA[100.00%%] D[%6.4f]", d)
        return d

    # -- quant matrix selection (processor.cc:310-372) ----------------

    def try_quant_matrix(self, jpg_in, q, img, target_mul):
        """TryQuantMatrix (processor.cc:310-338): requantize, queue the
        trial's compare, serialize the candidate while the device works,
        then fetch the compare (with recovery), log and MaybeOutput, in
        the reference's program order. Returns (dist_ok, size)."""
        trial = st.CoeffImage.from_jpeg(jpg_in)
        trial.apply_global_quantization(q)
        pending = self.comparator.dispatch_compare(trial)
        encoded = self.output_jpeg(trial.save_to_jpeg_data(jpg_in))
        img.comps = trial.comps
        self.stats.inc("iters")
        self.stats.inc("quant_trials")
        self.stats.log("Iter %2d: %s quantization matrix:\n",
                       self.stats.counters["iters"], _frame_type_str(img))
        self.stats.log_quant(q)
        self.stats.log("Iter %2d: %s GQ[%5.2f] Out[%7d]",
                       self.stats.counters["iters"], _frame_type_str(img),
                       quant_matrix_heuristic_score(q), len(encoded))
        d = self._recoverable(
            lambda: self.comparator.dispatch_compare(img),
            self.comparator.fetch_compare_plain, pending)
        self.stats.log(" BA[100.00%%] D[%6.4f]", d)
        dist_ok = self.comparator.distance_ok(target_mul)
        self.maybe_output(encoded)
        return dist_ok, len(encoded)

    def select_quant_matrix(self, jpg_in, downsample, best_q,
                            img: st.CoeffImage):
        """SelectQuantMatrix (processor.cc:340-372): the tree's waves
        (search/quant_tree.py) where the comparator takes them, else the
        serial loop; the same trials, logs, outputs and result."""
        if self.comparator.supports_quant_batch():
            return quant_tree.select_quant_matrix_tree(
                self, jpg_in, downsample, best_q, img)
        return self.select_quant_matrix_serial(jpg_in, downsample, best_q,
                                               img)

    def select_quant_matrix_serial(self, jpg_in, downsample, best_q,
                                   img: st.CoeffImage):
        """SelectQuantMatrix as the reference runs it: one
        try_quant_matrix per trial. Returns dist_ok of the best trial
        and sets best_q."""
        qgen = QuantMatrixGenerator(downsample)
        target_mul_high = 0.97
        target_mul_low = 0.95
        cur_q = best_q.copy()
        dist_ok, size = self.try_quant_matrix(jpg_in, cur_q, img,
                                              target_mul_high)
        best = (cur_q.copy(), dist_ok, size)
        while True:
            cur_q = qgen.get_next()
            if cur_q is None:
                break
            dist_ok, size = self.try_quant_matrix(jpg_in, cur_q, img,
                                                  target_mul_high)
            qgen.add(cur_q, dist_ok)
            if ((dist_ok and not best[1])
                    or (dist_ok == best[1] and size < best[2])):
                best = (cur_q.copy(), dist_ok, size)
                if dist_ok and not self.comparator.distance_ok(
                        target_mul_low):
                    break
        best_q[:] = best[0]
        return best[1]

    # -- frequency masking (processor.cc:559-721) ---------------------

    def masking_inputs(self, jpg, img: st.CoeffImage, comp_mask):
        """Per-block current + original coefficients on the pass's grid;
        unmasked channels stay zero (processor.cc:645-658)."""
        last_c = comp_mask.bit_length() - 1
        grid = img.comps[last_c]
        nb = grid.bw * grid.bh
        blocks = np.zeros((nb, 3, 64), dtype=np.int32)
        orig = np.zeros((nb, 3, 64), dtype=np.int32)
        for c in range(3):
            if not (comp_mask & (1 << c)):
                continue
            if c >= len(jpg.components):
                # Grayscale-collapsed jpg: no data, no candidates.
                continue
            comp = img.comps[c]
            assert (comp.bw, comp.bh) == (grid.bw, grid.bh)
            blocks[:, c, :] = comp.coeffs
            jcomp = jpg.components[c]
            src = jcomp.coeffs.reshape(jcomp.height_in_blocks,
                                       jcomp.width_in_blocks, 64)
            orig[:, c, :] = src[:grid.bh, :grid.bw].reshape(nb, 64) \
                .astype(np.int32) \
                * jpg.quant[jcomp.quant_idx].values[None, :]
        return blocks, orig

    def masking_aux(self, img, comp_mask, grid):
        """The pass's zeroing mode and frozen per-block state (see
        zeroing.loop_inputs), on the bucket's grid for a padded
        comparator. Starts block comparisons on the comparator.
        GUETZLI_TPU_ZEROING_DEBUG=1 writes the whole-image mask's and the
        block state's walls to stderr, as JAX's masking_aux does."""
        comp = self.comparator
        t0 = time.time()
        comp.start_block_comparisons()
        t0 = zeroing.debug(comp.device, t0, "zeroing-aux: whole-image mask")
        if img.is_444():
            state = comp.block_state(1, 1)
            zeroing.debug(comp.device, t0, "zeroing-aux: block state")
            if config.pallas() == 1:
                # Opt-in: the staged loop with kernel C per step.
                xyb0_tiles, scales, ysel, xsel = state
                sy, sx = tile_compare.selection_matrices(ysel, xsel)
                return "444p", (xyb0_tiles, scales, sy, sx)
            return "444", state
        if comp_mask == 1:
            return "420y", ((comp.frozen_chroma_blocks(img),)
                            + comp.block_state(1, 1))
        return "420c", (comp.frozen_neighborhoods(img)
                        + (comp.frozen_y_16x16(img, grid.bw, grid.bh),)
                        + comp.children_state(grid.bw, grid.bh))

    def csr_from_zeroing(self, out_idx, out_err, num, nb):
        """CSR candidate arrays (processor.cc:694-716) of the full-batch
        route's host rails [nb, K], at the comparator's float32 block
        error limit (zeroing.csr_from_zeroing; JAX
        processor.csr_from_zeroing)."""
        assert len(num) == nb
        return zeroing.csr_from_zeroing(
            out_idx, out_err, num,
            np.float32(self.comparator.block_error_limit()))

    def padded_masking_inputs(self, blocks, orig, grid):
        """The pass's blocks on the comparator's bucket grid (the grid
        masking_aux's state has, JAX processor.py:567-600): (blocks, orig,
        real_index), real_index the padded rows of the real blocks; the
        inputs unchanged and None at exact geometry."""
        geom = self.comparator.geom
        if geom is None:
            return blocks, orig, None
        gbwp = geom.wp // (8 * grid.factor_x)
        gbhp = geom.hp // (8 * grid.factor_y)

        def pad(a):
            return geom.pad_blocks(a.reshape(len(a), -1), grid.bw, grid.bh,
                                   gbwp, gbhp).reshape(-1, 3, 64)
        return (pad(blocks), pad(orig),
                geom.real_index(grid.bw, grid.bh, gbwp))

    def select_frequency_masking(self, jpg, img: st.CoeffImage, comp_mask,
                                 target_mul, stop_early):
        lookahead = self.params.zeroing_greedy_lookahead
        grid = img.comps[comp_mask.bit_length() - 1]
        blocks, orig, real_index = self.padded_masking_inputs(
            *self.masking_inputs(jpg, img, comp_mask), grid)
        with self.stats.timed("zeroing_aux"):
            mode, aux = self.masking_aux(img, comp_mask, grid)
        limit32 = np.float32(self.comparator.block_error_limit())
        kw = dict(mode=mode, real_index=real_index, lookahead=lookahead,
                  new_model=self.params.new_zeroing_model,
                  early_exit=self.params.zeroing_early_exit,
                  bands=self.comparator.bands, factor=grid.factor_y)
        with self.stats.timed("zeroing_loop"):
            if config.staged_zeroing():
                offsets, cand_idx, cand_err = zeroing.compute_zeroing_csr(
                    blocks, orig, limit32, aux, comp_mask,
                    self.comparator.device, **kw)
            else:
                # GUETZLI_TPU_STAGED_ZEROING=0: the full-batch loop, and
                # the CSR on the host.
                out_idx, out_err, num = zeroing.compute_zeroing_order(
                    blocks, orig, limit32, aux, comp_mask,
                    self.comparator.device, **kw)
                offsets, cand_idx, cand_err = self.csr_from_zeroing(
                    out_idx, out_err, num, len(num))
                del out_idx, out_err, num
        self.stats.inc("zeroing_passes")
        self.comparator.finish_block_comparisons()
        nb = len(offsets) - 1
        del blocks, orig, aux
        if nb * 192 >= RETURN_MEMORY_PASS_BYTES:
            # The pass's inputs and frozen state are dead once the CSR
            # exists; at 8 MPix they are hundreds of MB that would sit in
            # RSS through the back end (JAX processor.py:642-654).
            self.return_memory()
        with self.stats.timed("back_end"):
            self.select_frequency_back_end(
                jpg, img, comp_mask, target_mul, stop_early,
                offsets, cand_idx, cand_err)

    # -- back-end up/down loop (processor.cc:723-919) -----------------

    def select_frequency_back_end(self, jpg, img: st.CoeffImage, comp_mask,
                                  target_mul, stop_early,
                                  offsets, cand_idx, cand_err):
        """Drive back_end_steps, fetching each yielded compare before the
        next iteration."""
        gen = self.back_end_steps(jpg, img, comp_mask, target_mul,
                                  stop_early, offsets, cand_idx, cand_err)
        result = None
        while True:
            try:
                pending = (gen.send(result) if result is not None
                           else next(gen))
            except StopIteration:
                return
            with self.stats.timed("backend_fetch"):
                result = self._recoverable(
                    lambda: self.comparator.replay(pending),
                    self.comparator.fetch_compare, pending)

    def back_end_steps(self, jpg, img: st.CoeffImage, comp_mask,
                       target_mul, stop_early,
                       offsets, cand_idx, cand_err):
        """SelectFrequencyBackEnd (processor.cc:723-919) as a generator:
        yields each iteration's dispatched compare and receives its
        (distance, weights4) via send(). The serial driver fetches at
        once; the lockstep corpus driver advances every image to its
        yield and fetches all compares in one copy.

        Where the comparator supports it (Comparator.supports_sparse: the
        4:4:4 pass without a mesh) the image's coefficients stay on the
        device (Comparator.backend_sync_full) and each iteration ships
        only its flipped coefficients: the native flip loop's triplets,
        or, after the Python flip loop, triplets rebuilt from the
        last_indexes deltas. Otherwise each compare uploads the whole
        planes."""
        ncomp = len(jpg.components)
        last_c = comp_mask.bit_length() - 1
        grid = img.comps[last_c]
        factor = grid.factor_x
        bw, bh = grid.bw, grid.bh
        nb = bw * bh

        jpg_out = img.save_to_jpeg_data(jpg)
        jpg_header_size = jwriter.jpeg_header_size(
            jpg_out, self.params.clear_metadata)
        dc_size = hg.estimate_dc_size(jpg_out)
        # DC coefficients are never zeroing candidates, so the DC
        # histograms are invariant across the flip loop; the AC histograms
        # are maintained exactly by the flips (UpdateACHistogram,
        # processor.cc:491-515). Reusing both in the per-iteration
        # serialization gives identical bytes without the full histogram
        # pass. Valid while the grayscale-collapse state cannot change.
        ncomp_out0 = len(jpg_out.components)
        dc_histograms0 = hg.build_dc_histograms(jpg_out)
        ac_histograms = hg.build_ac_histograms(jpg_out)
        # Collapse (3 -> 1 comps) needs both chroma channels all-zero; DC
        # never flips, so a nonzero chroma DC pins the state.
        can_collapse = (
            ncomp_out0 == 3
            and not img.comps[1].coeffs[:, 0].any()
            and not img.comps[2].coeffs[:, 0].any())
        flip_channels = [c for c in range(3) if (comp_mask >> c) & 1]
        while len(ac_histograms) < ncomp:
            ac_histograms.append(hg.new_histogram())
        ac_depths, ac_histogram_size = hg.compute_entropy_codes(ac_histograms)
        base_size = (jpg_header_size + dc_size + ac_histogram_size
                     + hg.entropy_coded_data_size(ac_histograms, ac_depths))
        prev_size = base_size

        max_block_error = np.zeros(nb, dtype=np.float32)
        last_indexes = np.zeros(nb, dtype=np.int64)
        first_up_iter = True
        cached_weights = None
        limit = self.comparator.block_error_limit()
        clamped_off = np.clip(offsets[:nb], 0, max(len(cand_err) - 1, 0))
        use_sparse = self.comparator.supports_sparse(img, comp_mask)
        if use_sparse:
            self.comparator.backend_sync_full(img)

        for direction in (1, -1):
            while True:
                if stop_early and direction == -1:
                    if prev_size > 1.01 * len(self.final.jpeg_data):
                        break
                # Build the global order (processor.cc:772-828),
                # vectorized: per block, candidates [last_index, num) for
                # up or [last_index) reversed for down, valued by error
                # delta over block weight.
                with self.stats.timed("backend_order"):
                    order_blocks, order_vals, block_weight, \
                        blocks_to_change = self._global_order(
                            direction, first_up_iter, cached_weights,
                            target_mul, factor, offsets, cand_err,
                            last_indexes, max_block_error, nb)
                if order_blocks is None:
                    break

                rel_size_delta = 0.01 if direction > 0 else 0.0005
                if direction > 0 and self.comparator.distance_ok(1.0):
                    rel_size_delta = 0.05
                min_size_delta = base_size * rel_size_delta
                coeffs_to_change_per_block = (
                    2.0 if direction > 0 else factor * factor * 0.2)
                min_coeffs_to_change = int(
                    coeffs_to_change_per_block * blocks_to_change)

                if first_up_iter:
                    # partition_point on the sorted values (:840-848).
                    cnt = int(np.searchsorted(order_vals,
                                              np.float32(0.75 * limit),
                                              side="left"))
                    min_coeffs_to_change = max(min_coeffs_to_change, cnt)
                    first_up_iter = False

                li_before = last_indexes.copy()
                with self.stats.timed("backend_flips"):
                    flips = self._run_flips_native(
                        img, jpg, bw, offsets, cand_idx, cand_err,
                        last_indexes, order_blocks, order_vals, direction,
                        min_coeffs_to_change, min_size_delta, prev_size,
                        jpg_header_size, dc_size, ac_histograms, ac_depths,
                        ac_histogram_size, nb)
                    if flips is not None:
                        (est_jpg_size, changed_coeffs, val_threshold,
                         n_changed_blocks, ac_depths,
                         ac_histogram_size, flip_triplets) = flips
                        bs, slots, vals = flip_triplets
                        changed = np.unique(bs.astype(np.int64))
                    else:
                        (est_jpg_size, changed_coeffs, val_threshold,
                         n_changed_blocks, ac_depths, ac_histogram_size) = \
                            self._run_flips_python(
                                img, jpg, bw, offsets, cand_idx, cand_err,
                                last_indexes, order_blocks, order_vals,
                                direction, min_coeffs_to_change,
                                min_size_delta, prev_size, jpg_header_size,
                                dc_size, ac_histograms, ac_depths,
                                ac_histogram_size)
                        changed = np.nonzero(last_indexes != li_before)[0]
                        if use_sparse:
                            bs, slots, vals = _flip_triplets(
                                img, changed, li_before, last_indexes,
                                clamped_off, cand_idx)
                max_block_error += (np.asarray(block_weight)
                                    * val_threshold * direction)

                self.stats.inc("iters")
                self.stats.inc("backend_iters")
                self.stats.inc("iters_up" if direction > 0
                               else "iters_down")
                with self.stats.timed("backend_dispatch"):
                    if use_sparse:
                        pending = self.comparator \
                            .dispatch_compare_sparse_coeffs(
                                img, bs, slots, vals, direction,
                                target_mul, factor, factor)
                    else:
                        pending = self.comparator \
                            .dispatch_compare_with_weights(
                                img, direction, target_mul, factor, factor)
                with self.stats.timed("backend_serialize"):
                    if not can_collapse:
                        img.update_jpeg_data(jpg_out, changed,
                                             flip_channels, bw)
                    else:
                        jpg_out = img.save_to_jpeg_data(jpg)
                    if len(jpg_out.components) == ncomp_out0:
                        encoded = self.output_jpeg(
                            jpg_out, dc_histograms0,
                            ac_histograms[:ncomp_out0])
                    else:
                        encoded = self.output_jpeg(jpg_out)
                if (nb >= RETURN_MEMORY_BLOCKS
                        and self.stats.counters["iters"] % 8 == 0):
                    # Multi-MPix flip loops churn tens of MB of numpy per
                    # iteration, which glibc keeps in its arenas (JAX
                    # processor.py:1024-1031).
                    self.return_memory(collect=False)
                self.stats.log(
                    "Iter %2d: (%d) %s Coeffs[%d/%d] Blocks[%d/%d/%d] "
                    "ValThres[%.4f] Out[%7d] EstErr[%.2f%%]",
                    self.stats.counters["iters"], comp_mask,
                    "up" if direction > 0 else "down", changed_coeffs,
                    len(order_blocks), n_changed_blocks,
                    blocks_to_change, nb, val_threshold, len(encoded),
                    100.0 - (100.0 * est_jpg_size) / len(encoded))
                d, w4 = yield pending
                cached_weights = (direction, w4)
                self.stats.log(" BA[100.00%%] D[%6.4f]", d)
                self.maybe_output(encoded)
                prev_size = est_jpg_size

    def _global_order(self, direction, first_up_iter, cached_weights,
                      target_mul, factor, offsets, cand_err, last_indexes,
                      max_block_error, nb):
        """The iteration's candidate order, vectorized (processor.cc:
        772-828): (order_blocks, order_vals sorted, block_weight,
        blocks_to_change), or (None, None, None, 0) when no block has
        candidates left in this direction."""
        ncand_total = len(cand_err)
        clamped_off = np.clip(offsets[:nb], 0, max(ncand_total - 1, 0))
        # True per-block counts from the unclamped offsets: a trailing
        # empty block must not alias the last real candidate.
        num_candidates = offsets[1:] - offsets[:nb]
        if first_up_iter:
            # Zero distmap: every block's max distance is 0 <= target, so
            # all weights are 1.
            weights4 = np.ones((4, nb), dtype=np.float32)
        elif cached_weights is not None and cached_weights[0] == direction:
            weights4 = cached_weights[1]
        else:
            weights4 = self.comparator.weights_all_radii(
                direction, target_mul, factor, factor)
        for rblock in range(1, 5):
            block_weight = weights4[rblock - 1]
            active = block_weight > 0
            if direction > 0:
                counts = np.where(active, np.maximum(
                    num_candidates - last_indexes, 0), 0)
                starts = clamped_off + last_indexes
                step = 1
            else:
                counts = np.where(active, np.maximum(last_indexes, 0), 0)
                starts = clamped_off + last_indexes - 1
                step = -1
            blocks_to_change = int(np.count_nonzero(counts))
            total = int(counts.sum())
            if total:
                order_blocks = np.repeat(np.arange(nb, dtype=np.int64),
                                         counts)
                within = (np.arange(total, dtype=np.int64)
                          - np.repeat(np.cumsum(counts) - counts, counts))
                pos = np.repeat(starts, counts) + step * within
                err = cand_err[pos]
                mbe = max_block_error[order_blocks]
                bwt = block_weight[order_blocks]
                order_vals = np.float32(direction) * (err - mbe) / bwt
                sort_ix = np.argsort(order_vals, kind="stable")
                return (order_blocks[sort_ix], order_vals[sort_ix],
                        block_weight, blocks_to_change)
        return None, None, None, 0

    def _run_flips_native(self, img, jpg, bw, offsets, cand_idx, cand_err,
                          last_indexes, order_blocks, order_vals,
                          direction, min_coeffs_to_change, min_size_delta,
                          prev_size, jpg_header_size, dc_size,
                          ac_histograms, ac_depths, ac_histogram_size, nb):
        """C++ flip loop (native.cc gt_backend_flips); None if no lib."""
        lib = native.get_lib()
        if lib is None:
            return None
        ncomp = len(ac_histograms)
        coeff_ptrs = (ctypes.POINTER(ctypes.c_int32) * 3)()
        jpg_ptrs = (ctypes.POINTER(ctypes.c_int16) * 3)()
        jpg_wib = (ctypes.c_int * 3)()
        quant = np.ascontiguousarray(img.quant, dtype=np.int32)
        jpg_quant = np.stack([
            jpg.quant[c.quant_idx].values.astype(np.int32)
            for c in jpg.components] + [np.zeros(64, np.int32)] * (
                3 - len(jpg.components)))
        jpg_bufs = []
        for c in range(3):
            comp = img.comps[c]
            comp.coeffs = np.ascontiguousarray(comp.coeffs, dtype=np.int32)
            coeff_ptrs[c] = comp.coeffs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32))
            if c < len(jpg.components):
                buf = np.ascontiguousarray(jpg.components[c].coeffs,
                                           dtype=np.int16)
                jpg_bufs.append(buf)
                jpg_ptrs[c] = buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int16))
                jpg_wib[c] = jpg.components[c].width_in_blocks
        histo = np.ascontiguousarray(np.stack(ac_histograms),
                                     dtype=np.int64)
        depths = np.ascontiguousarray(ac_depths, dtype=np.uint8)
        if depths.shape[0] < ncomp:
            depths = np.zeros((ncomp, 257), dtype=np.uint8)
        hist_size = ctypes.c_int64(int(ac_histogram_size))
        out_coeffs = ctypes.c_int64(0)
        out_thresh = ctypes.c_double(0.0)
        out_blocks = ctypes.c_int64(0)
        out_rebuilds = ctypes.c_int64(0)
        # Exact flip triplets, emitted by the loop itself (capacity = the
        # order length, an upper bound on flips this iteration).
        flip_b = np.empty(len(order_blocks), dtype=np.int32)
        flip_idx = np.empty(len(order_blocks), dtype=np.int32)
        flip_val = np.empty(len(order_blocks), dtype=np.int32)
        offsets64 = np.ascontiguousarray(offsets, dtype=np.int64)
        li = np.ascontiguousarray(last_indexes, dtype=np.int64)
        ob = np.ascontiguousarray(order_blocks, dtype=np.int32)
        ov = np.ascontiguousarray(order_vals, dtype=np.float32)
        ci = np.ascontiguousarray(cand_idx, dtype=np.int32)
        ce = np.ascontiguousarray(cand_err, dtype=np.float32)
        est = lib.gt_backend_flips(
            coeff_ptrs, quant.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            jpg_ptrs, jpg_quant.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            jpg_wib, ctypes.c_int(bw),
            offsets64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ce.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(len(ci)),
            li.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ov.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(len(ob)), ctypes.c_int(direction),
            ctypes.c_int64(int(min_coeffs_to_change)),
            ctypes.c_double(float(min_size_delta)),
            ctypes.c_int64(int(prev_size)),
            ctypes.c_int64(int(jpg_header_size)),
            ctypes.c_int64(int(dc_size)),
            histo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            depths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(hist_size), ctypes.c_int(ncomp),
            ctypes.c_int64(nb),
            ctypes.byref(out_coeffs), ctypes.byref(out_thresh),
            ctypes.byref(out_blocks),
            flip_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flip_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flip_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(out_rebuilds))
        last_indexes[:] = li
        for c in range(ncomp):
            ac_histograms[c][:] = histo[c]
        m = int(out_coeffs.value)
        # The loop's entropy-code rebuilds against its flips: a full
        # rebuild schedule runs one per 10 flips.
        self.stats.inc("flips", m)
        self.stats.inc("flip_code_rebuilds", int(out_rebuilds.value))
        return (int(est), m, float(out_thresh.value),
                int(out_blocks.value), depths, int(hist_size.value),
                (flip_b[:m], flip_idx[:m], flip_val[:m]))

    def _run_flips_python(self, img, jpg, bw, offsets, cand_idx, cand_err,
                          last_indexes, order_blocks, order_vals,
                          direction, min_coeffs_to_change, min_size_delta,
                          prev_size, jpg_header_size, dc_size,
                          ac_histograms, ac_depths, ac_histogram_size):
        """Pure-Python flip loop (processor.cc:854-889)."""
        changed_blocks = set()
        val_threshold = 0.0
        changed_coeffs = 0
        est_jpg_size = prev_size
        ncand_total = len(cand_idx)
        for i in range(len(order_blocks)):
            b = int(order_blocks[i])
            last_idx = int(last_indexes[b])
            offset = max(0, min(int(offsets[b]), ncand_total - 1))
            idx = int(cand_idx[offset + last_idx + min(direction, 0)])
            c = idx // 64
            k = idx % 64
            quant_c = img.comps[c].quant
            jcomp = jpg.components[c]
            jpg_block_ix = (b // bw) * jcomp.width_in_blocks + (b % bw)
            if direction > 0:
                newval = 0
            else:
                newval = int(st.quantize(
                    [int(jcomp.coeffs[jpg_block_ix, k])
                     * int(jpg.quant[jcomp.quant_idx].values[k])],
                    [int(quant_c[k])])[0])
            block = img.comps[c].coeffs[b].copy()
            hg.update_ac_histogram(-1, block, quant_c, ac_histograms[c])
            block[k] = newval
            hg.update_ac_histogram(1, block, quant_c, ac_histograms[c])
            img.comps[c].coeffs[b] = block
            last_indexes[b] += direction
            changed_blocks.add(b)
            val_threshold = float(order_vals[i])
            changed_coeffs += 1
            if i % 10 == 0:
                ac_depths, ac_histogram_size = \
                    hg.compute_entropy_codes(ac_histograms)
            est_jpg_size = (jpg_header_size + dc_size + ac_histogram_size
                            + hg.entropy_coded_data_size(ac_histograms,
                                                         ac_depths))
            if (changed_coeffs > min_coeffs_to_change
                    and abs(est_jpg_size - prev_size) > min_size_delta):
                break
        return (est_jpg_size, changed_coeffs, val_threshold,
                len(changed_blocks), ac_depths, ac_histogram_size)

    # -- top-level (processor.cc:931-1020) ----------------------------

    def process_jpeg_data(self, jpg_in: jd.JpegData) -> bool:
        if self.params.butteraugli_target > 2.0:
            sys.stderr.write(
                "Guetzli should be called with quality >= 84.\n")
            return False
        if len(jpg_in.components) != 3:
            sys.stderr.write("Only YUV color space input jpeg supported\n")
            return False
        if jpg_in.is_444():
            input_is_420 = False
        elif jpg_in.is_420():
            input_is_420 = True
        else:
            sys.stderr.write("Unsupported sampling factors\n")
            return False

        with self.stats.timed("image_setup"):
            encoded = self.output_jpeg(jpg_in)
            self.final.score = -1
            self.stats.log("Original Out[%7d]", len(encoded))
            if self.comparator is None:
                self.stats.log(" <image too small for Butteraugli>\n")
                self.final.jpeg_data = encoded
                self.final.score = len(encoded)
                return True

            jpg = _copy_jpeg(jpg_in)
            q_in = st.remove_original_quantization(jpg)
            img = st.CoeffImage.from_jpeg(jpg)
            self._compare(img)
            self.maybe_output(encoded)
        try_420 = 1 if (input_is_420 or self.params.force_420
                        or (self.params.try_420
                            and not _is_grayscale(jpg_in))) else 0
        force_420 = 1 if (input_is_420 or self.params.force_420) else 0
        try:
            self._run_search(jpg_in, q_in, force_420, try_420)
        except Exception as e:   # the reference's resilience model
            # The original/requantized output was emitted before the search
            # started, so a failed search still yields valid output
            # (processor.cc:965-977). stats.search_error records it. A
            # sticky CUDA error has lost the device: it propagates.
            if not self.final.jpeg_data or runtime.is_sticky(e):
                raise
            self.stats.search_error = "%s: %s" % (type(e).__name__, e)
            sys.stderr.write(
                "search failed (%s); emitting best output so far\n" % e)
        return True

    def _run_search(self, jpg_in, q_in, force_420, try_420):
        """processor.cc:986-1016: a 4:4:4 search, a 4:2:0 search, or both
        (try_420), each ending in MaybeOutput of its candidates. The 4:2:0
        search runs the Y pass, then the chroma pass."""
        for downsample in range(force_420, try_420 + 1):
            jpg = _copy_jpeg(jpg_in)
            st.remove_original_quantization(jpg)
            img = st.CoeffImage.from_jpeg(jpg)
            if downsample:
                if img.comps[1].factor_x == 1 and img.comps[1].factor_y == 1:
                    img.downsample(
                        use_silver_screen=self.params.use_silver_screen)
                jpg = img.save_to_jpeg_data(jpg)
            best_q = q_in.copy()
            with self.stats.timed("select_quant_matrix"):
                ok = self.select_quant_matrix(jpg, downsample != 0, best_q,
                                              img)
            if not ok:
                best_q[:] = 1
            img.comps = st.CoeffImage.from_jpeg(jpg).comps
            img.apply_global_quantization(best_q)
            with self.stats.timed("select_frequency_masking"):
                if not downsample:
                    self.select_frequency_masking(jpg, img, 7, 1.0, False)
                else:
                    ymul = 1.0 if len(jpg.components) == 1 else 0.97
                    self.select_frequency_masking(jpg, img, 1, ymul, False)
                    self.select_frequency_masking(jpg, img, 6, 1.0, True)


def _flip_triplets(img, changed, li_before, last_indexes, clamped_off,
                   cand_idx):
    """The Python flip loop's flips as (block, c*64+k, new value)
    triplets, rebuilt from the last_indexes deltas with the values read
    from the post-flip host image (JAX processor.py:984-1004): what the
    native loop emits itself, for the sparse dispatch."""
    lo = np.minimum(li_before, last_indexes)[changed]
    cnt = np.maximum(li_before, last_indexes)[changed] - lo
    tot = int(cnt.sum())
    bs = np.repeat(changed, cnt)
    within = (np.arange(tot, dtype=np.int64)
              - np.repeat(np.cumsum(cnt) - cnt, cnt))
    slots = cand_idx[np.repeat(clamped_off[changed] + lo, cnt) + within]
    vals = np.empty(tot, np.int32)
    for c in range(3):
        m = (slots >> 6) == c
        if m.any():
            vals[m] = img.comps[c].coeffs[bs[m], slots[m] & 63]
    return bs, slots, vals


def _frame_type_str(img) -> str:
    """OutputImage::FrameTypeStr (output_image.cc:718-725)."""
    return "f" + "".join("%d%d" % (c.factor_x, c.factor_y)
                         for c in img.comps)


def _copy_jpeg(jpg: jd.JpegData) -> jd.JpegData:
    import copy
    out = copy.copy(jpg)
    out.components = [
        jd.Component(id=c.id, h_samp_factor=c.h_samp_factor,
                     v_samp_factor=c.v_samp_factor, quant_idx=c.quant_idx,
                     width_in_blocks=c.width_in_blocks,
                     height_in_blocks=c.height_in_blocks,
                     coeffs=c.coeffs.copy())
        for c in jpg.components]
    out.quant = [jd.QuantTable(t.values.copy(), t.precision, t.index,
                               t.is_last) for t in jpg.quant]
    out.app_data = list(jpg.app_data)
    out.com_data = list(jpg.com_data)
    return out


def _is_grayscale(jpg: jd.JpegData) -> bool:
    return all(not np.any(jpg.components[c].coeffs) for c in (1, 2))


def decode_jpeg_to_rgb(jpg: jd.JpegData):
    """DecodeJpegToRGB (jpeg_data_decoder.cc:45-53): interleaved sRGB bytes
    [h, w, 3] uint8 of a 3-component YCbCr 4:4:4 or 4:2:0 JPEG, by the
    integer pixel path on the CPU; None for other colorspaces or
    samplings."""
    import torch

    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.ops import image as img_ops
    if len(jpg.components) != 3 or not reader.has_ycbcr_colorspace(jpg):
        return None
    img = st.CoeffImage.from_jpeg(jpg)
    if jpg.is_444():
        srgb = img_ops.coeffs_to_srgb(torch.as_tensor(img.coeffs), img.bw,
                                      img.bh, img.width, img.height)
    elif jpg.is_420():
        y, u, v = img.comps
        srgb = img_ops.coeffs420_to_srgb(
            torch.as_tensor(y.coeffs), torch.as_tensor(u.coeffs),
            torch.as_tensor(v.coeffs), y.bw, y.bh, u.bw, u.bh, img.width,
            img.height)
    else:
        return None
    return srgb.numpy().transpose(1, 2, 0).astype(np.uint8)


def process_jpeg_bytes(params: Params, data: bytes,
                       stats: ProcessStats = None, device="cuda", mesh=None):
    """guetzli::Process for JPEG input (processor.cc:1029-1066). Returns
    the JPEG bytes, or None (after a message on stderr) for an unreadable
    or unsupported input. `mesh`: the comparator's (comparator.py)."""
    from guetzli_tpu_torch.codec import reader
    stats = stats or ProcessStats()
    with stats.timed("image_setup"):
        with stats.timed("input_decode"):
            try:
                jpg = reader.read_jpeg(data)
            except reader.JpegError as e:
                sys.stderr.write("Can't read jpg data from input file: "
                                 "%s\n" % e)
                return None
            if not reader.check_jpeg_sanity(jpg):
                sys.stderr.write("Unsupported input JPEG (unexpectedly "
                                 "large coefficient values).\n")
                return None
            rgb = decode_jpeg_to_rgb(jpg)
        comparator = None
        if rgb is not None and jpg.width >= 32 and jpg.height >= 32:
            comparator = _comparator(rgb, jpg.width, jpg.height, params,
                                     stats, device, mesh)
    if rgb is None:
        # ProcessUnsupportedJpegData (processor.cc:1069-1153): CMYK/YCCK,
        # other samplings (4:2:2, 4:1:1), grayscale and RGB-tagged JPEGs
        # are decoded to RGB and re-encoded from pixels.
        return process_unsupported_jpeg_bytes(params, data, stats, device,
                                              mesh)
    proc = Processor(params, comparator, stats)
    if not proc.process_jpeg_data(jpg):
        return None
    return proc.final.jpeg_data


def process_unsupported_jpeg_bytes(params: Params, data: bytes,
                                   stats: ProcessStats = None,
                                   device="cuda", mesh=None):
    """ProcessUnsupportedJpegData (processor.cc:1069-1153): decode any
    JPEG the reader parses to RGB (codec/full_decode.py, libjpeg's integer
    semantics) and encode the pixels."""
    from guetzli_tpu_torch.codec import full_decode, reader
    stats = stats or ProcessStats()
    try:
        with stats.timed("image_setup"), stats.timed("input_decode"):
            jpg = reader.read_jpeg(data)
            rgb, w, h = full_decode.decode_any_to_rgb(jpg)
    except (reader.JpegError, ValueError) as e:
        sys.stderr.write("Can't decode unsupported JPEG: %s\n" % e)
        return None
    try:
        return process_rgb(params, rgb, w, h, stats, device, mesh)
    except ValueError:
        return None


def process_rgb(params: Params, rgb, w, h, stats: ProcessStats = None,
                device="cuda", mesh=None) -> bytes:
    """guetzli::Process for RGB input (processor.cc:1157-1185). `device`
    is where the comparator and the kernels run; `mesh` the ranks it
    runs over (comparator.Comparator: None reads GUETZLI_TPU_MESH)."""
    stats = stats or ProcessStats()
    with stats.timed("image_setup"):
        jpg = encode_rgb_to_jpeg(rgb, w, h)
        comparator = None
        if w >= 32 and h >= 32:
            comparator = _comparator(rgb, w, h, params, stats, device, mesh)
    proc = Processor(params, comparator, stats)
    if not proc.process_jpeg_data(jpg):
        raise ValueError("processing failed")
    return proc.final.jpeg_data


def _comparator(rgb, w, h, params, stats, device, mesh):
    """The image's Comparator, its compare spans (compare_dispatch,
    compare_wait, compare_capture, compare_upload) charged to
    stats.timings and its counters (compare_graph_captures,
    compare_graph_replays, compare_eager, compare_graph_shared,
    compare_graph_evictions, compare_upload_bytes) to stats.counters."""
    comparator = Comparator(rgb, w, h, params.butteraugli_target, device,
                            mesh=mesh)
    comparator.timings = stats.timings
    comparator.counters = stats.counters
    return comparator
