#!/usr/bin/env python3
"""Smoke run of guetzli_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from guetzli_tpu_torch/csrc with nvcc and holds
each of the seven entry points against its plain PyTorch version at the
main paths' shapes, and times them:

  * 4:4:4, on tests/corpus/photo_mosaic1.png (1444x908): the block compare
    A and the greedy zeroing kernel B (mode "444"), and the blocks-leading
    compare C on A's lanes (equal to A bit for bit), then the opt-in
    greedy pass "444p" (the staged loop with C per step) against B's CSR;
  * 4:2:0, on tests/corpus/photo_mosaic1-420.jpg read by the port's JPEG
    reader: the Y pass (A' and B', mode "420y", comp_mask 1) and the chroma
    pass over 16x16 macroblocks (A'' and B'', mode "420c", comp_mask 6).

Then it drives the paths end to end on the card, each with the launch
counts set to 0 just before it and read just after:

  * the main paths through guetzli_tpu_torch.api.encode_bytes at quality
    95: two PNGs (bees96x64, photo_mosaic1) and three JPEGs (bees_d-420,
    bees_d-progressive, photo_mosaic1-420), against the reference
    encoder's golden sizes (tests/golden_corpus.txt, tests/test_e2e.py);
  * the tooling: ``cli.main(["--checkcuda", ...])`` on bees96x64.png and
    bees_d-420.jpg (C and A at 0 mismatches, every stage within the
    counts tests/test_torch_tooling.py pins on the CPU), and the
    butteraugli CLI on bees96x64 against the reference's q95 JPEG;
  * GUETZLI_TPU_PALLAS=1 encodes of the two PNGs (mode "444p": C, not B),
    which must give the default path's bytes.

Every phase that fails makes the script exit nonzero. The last two lines
of standard output are the kernels' JSON record and {"ok": true,
"device": {...}}.

Without a CUDA device, or outside the repository, it exits nonzero and
prints no result.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent

# Golden sizes of the reference encoder at q95 (tests/test_e2e.py,
# tests/golden_corpus.txt), and the band the port is held to.
E2E = [("tests/fixtures/bees96x64.png", 2364),
       ("tests/corpus/photo_mosaic1.png", 393811),
       ("tests/corpus/bees_d-420.jpg", 1681),
       ("tests/corpus/bees_d-progressive.jpg", 1958),
       ("tests/corpus/photo_mosaic1-420.jpg", 348714)]
BAND = 0.02
QUALITY = 95
MODES = ("444", "420y", "420c")

# --checkcuda's per-stage mismatch counts on bees_d-420.jpg, as
# tests/test_torch_tooling.py pins them for the port on the CPU (JAX's
# _stage_checks gives 3 on the first CompareBlock line: one block sits
# across the 1e-3 tolerance, see that test). The card may count no more.
CHECKCUDA_420 = {"CompareBlock[104 blocks]": 2,
                 "CompareBlockLanes[104 blocks]": 3}
# The butteraugli CLI's distance of bees96x64.png against the reference
# encoder's q95 JPEG on the CPU (pinned by tests/test_torch_tooling.py),
# and the band the card is held to around it.
BUTTERAUGLI_CPU = 0.971314
BUTTERAUGLI_RTOL = 2e-3

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def compare_block_ops(mode):
    """Float and integer operations of one block evaluation in `mode`,
    counted from csrc/compare_block.cuh (an 8-term contraction output is 8
    multiplies and 7 adds)."""
    c8 = 15
    idct = 2 * 64 * c8                      # integer: two passes, 1 channel
    ycc = 64 * 12                           # integer color transform
    blur = 3 * 2 * 64 * c8
    clenshaw = 5 * 4 + 3
    gamma = 2 + 2 + 2 * clenshaw + 1
    opsin = 64 * 3 * (6 + gamma + 1 + 6 + 1 + 5)
    mhic = 64 * (6 + 12 + 3 + 2 + 7 + 3 * 4)
    means = 3 * (64 * 2 + 8) + 3 * 4 * 16
    low_freq = 5 * (9 + 9)
    fft = 64 * 2 * c8 + 64 * 4 * c8 + 64 * 6
    ac = 4 * fft + 3 * (64 * 2) + 64 * 20
    tail = 16
    finish = blur + opsin + mhic + means + low_freq + ac + tail
    if mode == "444":
        return {"float": finish, "int": 3 * idct + ycc}
    if mode == "420y":
        return {"float": finish, "int": idct + ycc}
    # 420c: two chroma IDCTs; per sub-block pixel, two upsampled dithered
    # chroma bytes (4 neighbourhood reads, 3 multiplies, 3 adds, 2 shifts
    # and the 2-op dither each) and the color transform; four float
    # stages and the max.
    if mode == "444p":
        # Kernel C: mode 444 plus the selection contractions, two passes
        # over three channels of 64 outputs.
        return {"float": finish, "int": 3 * idct + ycc + 2 * 3 * 64 * c8}
    up = 2 * 64 * 10
    return {"float": 4 * finish + 4, "int": 2 * idct + 4 * (up + ycc)}


def bound_ms(mode, n_evals, n_bytes):
    """The least time for the work: the larger of the operations over the
    float32 peak and the bytes over the memory rate. Returns (ms, by)."""
    ops = compare_block_ops(mode)
    t_ops = n_evals * (ops["float"] + ops["int"]) / PEAK_FP32
    t_bytes = n_bytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# Bytes per lane that each function must move: its operands read once
# (A' reads the Y plane of the candidates, A'' the two chroma planes) and
# its output written once. Greedy loops: coefficients, order, count and
# limit, the state, and the two [192] rails.
STATE_BYTES = {"444": 192 * 4 + 3 * 4 + 2 * 4,
               "420y": 128 * 4 + 192 * 4 + 3 * 4 + 2 * 4,
               "420c": 200 * 4 + 256 * 4 + 4 * 192 * 4 + 12 * 4 + 12 * 4}
CAND_BYTES = {"444": 192 * 4, "420y": 64 * 4, "420c": 128 * 4}
# Kernel C per lane: cand and xyb0 [3, 64], scales [3], sy and sx [8, 8].
STATE_BYTES["444p"] = 192 * 4 + 3 * 4 + 2 * 64 * 4
CAND_BYTES["444p"] = 192 * 4


def compare_bytes(mode):
    return CAND_BYTES[mode] + STATE_BYTES[mode] + 4


def greedy_bytes(mode):
    return 2 * 192 * 4 + 8 + STATE_BYTES[mode] + 192 * 8


def time_cuda(fn, reps=10):
    """Median milliseconds of fn() over `reps` warm runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % smi.stderr)
    log(smi.stdout.strip())
    log("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    t0 = time.time()
    build.build_all()
    log("nvcc build of %d sources (in parallel): %.1f s"
        % (len(build.SOURCES), time.time() - t0))
    for name, rec in build.build_log.items():
        info = [ln.strip().replace("ptxas info    : ", "")
                for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "stack frame" in ln
                or "Compiling entry function" in ln]
        log("  %s: %.1f s; %s" % (name, rec["seconds"], "; ".join(info)))


def mosaic444(dev):
    """photo_mosaic1's coefficients as the encoder starts from them and its
    comparator's frozen block state: (blocks, orig, mode, aux, mask)."""
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    rgb, w, h = read_png((REPO / E2E[1][0]).read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    comp = Comparator(rgb, w, h, target(), dev)
    comp.start_block_comparisons()
    aux = comp.block_state(1, 1)
    blocks = np.ascontiguousarray(img.coeffs.transpose(1, 0, 2))
    return {"444": (blocks, blocks, aux, 7)}


def mosaic420(dev):
    """photo_mosaic1-420.jpg read and decoded by the port, and the inputs of
    its two 4:2:0 zeroing passes as select_frequency_masking builds them
    (at the file's own quantization): mode -> (blocks, orig, aux, mask)."""
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.search import state as st
    from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                    decode_jpeg_to_rgb)
    jpg = reader.read_jpeg((REPO / E2E[4][0]).read_bytes())
    if not jpg.is_420():
        raise RuntimeError("photo_mosaic1-420.jpg is not 4:2:0")
    rgb = decode_jpeg_to_rgb(jpg)
    comp = Comparator(rgb, jpg.width, jpg.height, target(), dev)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    proc = Processor(Params(), comp, None)
    out = {}
    for mask in (1, 6):
        grid = img.comps[mask.bit_length() - 1]
        blocks, orig = proc.masking_inputs(jpg, img, mask)
        mode, aux = proc.masking_aux(img, mask, grid)
        out[mode] = (blocks, orig, aux, mask)
    log("photo_mosaic1-420: %dx%d, %d Y blocks, %d macroblocks"
        % (jpg.width, jpg.height, len(out["420y"][0]), len(out["420c"][0])))
    return out


def target():
    from guetzli_tpu_torch import consts
    return consts.butteraugli_score_for_quality(QUALITY)


def first_step(mode, state, dev):
    """The first greedy step's candidates of every block: its three
    best-scored coefficients each zeroed (lookahead 3). Returns (ct
    [3, 8, 8, 3NB] int32, the mode's lane-major state on those lanes, r:
    the block of each lane)."""
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    nb = blocks.shape[0]
    scores = zeroing.candidate_scores_host(blocks, orig, mask)
    order = zeroing._argsort_rows_stable(scores)[:, :3]
    cand = np.repeat(blocks.reshape(nb, 192), 3, axis=0)
    cand[np.arange(3 * nb), order.reshape(-1)] = 0
    r = torch.as_tensor(np.repeat(np.arange(nb), 3), device=dev)
    lanes = [a[..., r].contiguous() for a in tl.LANE_AUX[mode](*aux)]
    ct = torch.as_tensor(cand.T.copy(), device=dev).reshape(3, 8, 8, -1) \
        .contiguous()
    return ct, lanes, r


def phase_compare(mode, state, dev):
    """The mode's compare kernel (A, A', A'') on the first greedy step's
    candidates of every block, against its plain version."""
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    ct, lanes, _r = first_step(mode, state, dev)
    n = ct.shape[-1]
    got = ka.tile_compare_lanes(ct, *lanes, mode=mode)
    want = tl.COMPARE[mode](ct, *lanes)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    max_rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    equal = bool(torch.equal(got, want))
    name = ka.ENTRY[mode]
    log("%s vs plain on %d lanes: max abs %.3g, max rel %.3g, bit-equal %s"
        % (name, n, max_abs, max_rel, equal))
    if not max_rel <= 1e-5:
        raise RuntimeError("%s disagrees with its plain version" % name)
    ms = time_cuda(lambda: ka.tile_compare_lanes(ct, *lanes, mode=mode), 10)
    plain_ms = time_cuda(lambda: tl.COMPARE[mode](ct, *lanes), 3)
    b_ms, by = bound_ms(mode, n, n * compare_bytes(mode))
    log("%s: %.4f ms (median of 10), plain %.3f ms, bound %.4f ms (%s)"
        % (name, ms, plain_ms, b_ms, by))
    replaces = ("guetzli_tpu/kernels/tile_compare_lanes.py:119"
                if mode == "444" else
                "guetzli_tpu/ops/tiles_lanes.py:%d (XLA, no pallas_call)"
                % (331 if mode == "420y" else 380))
    return {"name": name, "route": "cuda",
            "source": "guetzli_tpu_torch/csrc/tile_compare_lanes.cu",
            "replaces": replaces, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


def phase_greedy(mode, state, dev, plain_reps):
    """The mode's greedy kernel (B, B', B'') fused against the staged loop
    (the mode's compare kernel per step) and against the plain greedy
    loop, all on the card."""
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    limit = np.float32(target())
    name = zl.ENTRY[mode]
    t0 = time.time()
    fused = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask, dev,
                                        mode=mode, fused=True)
    t1 = time.time()
    staged = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask, dev,
                                         mode=mode, fused=False)
    t2 = time.time()
    same = all(np.array_equal(a, b) for a, b in zip(fused, staged))
    log("%s: fused vs staged (compare kernel per step) CSR: %d blocks, %d "
        "candidates, bit-identical %s (%.2f s, %.2f s)"
        % (name, len(fused[0]) - 1, len(fused[1]), same, t1 - t0, t2 - t1))
    if not same:
        raise RuntimeError("%s: fused and staged zeroing CSR differ" % name)

    args, _perm, _inv, _lim = zeroing.loop_inputs(blocks, orig, limit, aux,
                                                  mask, dev, mode)
    k_idx, k_err = zl.zeroing_loop(*args, mode=mode)
    p_idx, p_err = zl.zeroing_loop_plain(*args, mode=mode)
    torch.cuda.synchronize()
    rows_same = (k_idx == p_idx).all(0) & ((k_err == p_err)
                                          | (k_err.isinf() & p_err.isinf())
                                          ).all(0)
    share = float(rows_same.float().mean())
    fin = torch.isfinite(k_err) & (k_idx == p_idx)
    max_abs = float((k_err[fin] - p_err[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    log("%s vs plain greedy loop: identical block rows %.4f%%, max abs err "
        "%.3g" % (name, 100 * share, max_abs))
    if share < 0.99:
        raise RuntimeError("%s agrees with its plain version on fewer than "
                           "99%% of blocks" % name)
    ms = time_cuda(lambda: zl.zeroing_loop(*args, mode=mode), 3)
    plain_ms = time_cuda(lambda: zl.zeroing_loop_plain(*args, mode=mode),
                         plain_reps)
    nrem = args[2].long()
    evals = int(torch.where(nrem >= 2, 3 * nrem - 3, nrem).sum())
    n = nrem.numel()
    b_ms, by = bound_ms(mode, evals, n * greedy_bytes(mode))
    log("%s: %.3f ms (median of 3) for %d blocks, %d evaluations; plain "
        "%.1f ms (median of %d); bound %.4f ms (%s)"
        % (name, ms, n, evals, plain_ms, plain_reps, b_ms, by))
    return {"name": name, "route": "cuda",
            "source": "guetzli_tpu_torch/csrc/zeroing_loop.cu",
            "replaces": "guetzli_tpu/kernels/zeroing_loop.py:301 (mode %s)"
            % mode, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def phase_tile_compare(state, dev):
    """Kernel C on the lanes of phase_compare("444"), moved to blocks
    leading, with the selection matrices of the block state: against its
    plain version and against kernel A on the same lanes, both bit for
    bit."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    ct, lanes, r = first_step("444", state, dev)
    n = ct.shape[-1]
    _x0, _sc, ysel, xsel = state[2]
    sy, sx = kc.selection_matrices(ysel[r], xsel[r])
    args = (ct.permute(3, 0, 1, 2).reshape(n, 3, 64).contiguous(),
            lanes[0].permute(3, 0, 1, 2).reshape(n, 3, 64).contiguous(),
            lanes[1].transpose(0, 1).contiguous(), sy, sx)
    got = kc.tile_compare(*args)
    want = kc.tile_compare_plain(*args)
    a = ka.tile_compare_lanes(ct, *lanes)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    same_plain = bool(torch.equal(got, want))
    same_a = bool(torch.equal(got, a))
    log("%s vs plain on %d lanes: max abs %.3g, bit-equal %s; bit-equal "
        "to %s %s" % (kc.ENTRY, n, max_abs, same_plain, ka.ENTRY["444"],
                      same_a))
    if not (same_plain and same_a):
        raise RuntimeError("%s disagrees with its plain version or with "
                           "kernel A" % kc.ENTRY)
    ms = time_cuda(lambda: kc.tile_compare(*args), 10)
    plain_ms = time_cuda(lambda: kc.tile_compare_plain(*args), 3)
    b_ms, by = bound_ms("444p", n, n * compare_bytes("444p"))
    log("%s: %.4f ms (median of 10), plain %.3f ms, bound %.4f ms (%s)"
        % (kc.ENTRY, ms, plain_ms, b_ms, by))
    return {"name": kc.ENTRY, "route": "cuda",
            "source": "guetzli_tpu_torch/csrc/tile_compare.cu",
            "replaces": "guetzli_tpu/kernels/tile_compare.py:430",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def phase_greedy_444p(state, dev):
    """The opt-in greedy pass "444p" on photo_mosaic1: the staged loop
    with kernel C per step, whose CSR must equal fused B's bit for bit.
    Returns C's launches in the pass."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    limit = np.float32(target())
    x0, sc, ysel, xsel = aux
    aux_p = (x0, sc) + kc.selection_matrices(ysel, xsel)
    fused = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask, dev,
                                        mode="444", fused=True)
    kc.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    staged = zeroing.compute_zeroing_csr(blocks, orig, limit, aux_p, mask,
                                         dev, mode="444p")
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = kc.launches
    same = all(np.array_equal(a, b) for a, b in zip(fused, staged))
    log("mode 444p (staged loop, %s per step): %.2f s, %d launches of %s; "
        "CSR (%d candidates) bit-identical to fused B's %s"
        % (kc.ENTRY, wall, n, kc.ENTRY, len(staged[1]), same))
    if not same or n == 0:
        raise RuntimeError("mode 444p: CSR differs from B's or C was not "
                           "launched")
    return n


def _launch_counts():
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    out = {ka.ENTRY[m]: ka.launches[m] for m in MODES}
    out.update({zl.ENTRY[m]: zl.launches[m] for m in MODES})
    out[kc.ENTRY] = kc.launches
    return out


def _reset_launches():
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    for m in MODES:
        ka.launches[m] = 0
        zl.launches[m] = 0
    kc.launches = 0


def _check_golden(path, out, golden):
    if abs(len(out) - golden) > BAND * golden:
        raise RuntimeError("%s: %d bytes, outside %d +- 2%%"
                           % (path, len(out), golden))


def phase_e2e(dev):
    """The main paths: api.encode_bytes on the card, PNG and JPEG in.
    Returns (launches, path -> output bytes)."""
    from guetzli_tpu_torch import api
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.search.processor import ProcessStats
    _reset_launches()
    outputs = {}
    for path, golden in E2E:
        data = (REPO / path).read_bytes()
        stats = ProcessStats()
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = api.encode_bytes(data, quality=QUALITY, stats=stats,
                               device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        c = stats.counters
        now = _launch_counts()
        delta = {k: now[k] - before[k] for k in now}
        log("%s q%d: %.2f s, %d bytes (golden %d, %+.2f%%), distance %.4f; "
            "quant trials %d, zeroing passes %d, back-end iterations %d; "
            "launches %s"
            % (path, QUALITY, wall, len(out), golden,
               100.0 * (len(out) - golden) / golden,
               stats.final_distance or -1, c.get("quant_trials", 0),
               c.get("zeroing_passes", 0), c.get("backend_iters", 0),
               ", ".join("%s %d" % kv for kv in delta.items())))
        log("  phases: " + ", ".join(
            "%s %.2f s" % kv for kv in sorted(stats.timings.items())))
        if stats.search_error is not None:
            raise RuntimeError("search failed: %s" % stats.search_error)
        _check_golden(path, out, golden)
        outputs[path] = out
        if "-420" in path:
            if not reader.read_jpeg(out).is_420():
                raise RuntimeError("%s: output is not 4:2:0" % path)
            if min(delta[zl.ENTRY["420y"]], delta[zl.ENTRY["420c"]]) == 0:
                raise RuntimeError("%s: a 4:2:0 greedy kernel was not "
                                   "launched: %s" % (path, delta))
        elif out[:2] != b"\xff\xd8":
            raise RuntimeError("%s: output is not a JPEG" % path)
    launches = _launch_counts()
    if launches.pop(kc.ENTRY):
        raise RuntimeError("kernel C was launched on the default path")
    if min(launches.values()) == 0:
        raise RuntimeError("a kernel was not launched on the main paths: %s"
                           % launches)
    return launches, outputs


_REPORT = re.compile(r"^checkcl (.+): (\d+)/(\d+) mismatches", re.M)


def phase_checkcuda(dev):
    """--checkcuda through the CLI on a PNG and on a 4:2:0 JPEG (the image
    on which the JAX package's run_checkcl fails on the padded block
    state). Returns C's launches."""
    from guetzli_tpu_torch import cli
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    c_launches = 0
    tmp = tempfile.TemporaryDirectory()
    out_path = pathlib.Path(tmp.name) / "out.jpg"
    for path, golden in (E2E[0], E2E[2]):
        _reset_launches()
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["--checkcuda", str(REPO / path), str(out_path)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        text = err.getvalue()
        log("--checkcuda %s: rc %d, %.2f s (check and encode), launches "
            "%s %d, %s %d\n%s" % (path, rc, wall, kc.ENTRY, kc.launches,
                                   ka.ENTRY["444"], ka.launches["444"],
                                   text.rstrip()))
        if rc != 0:
            raise RuntimeError("--checkcuda %s exited %d" % (path, rc))
        _check_golden(path, out_path.read_bytes(), golden)
        counts = {m.group(1): int(m.group(2))
                  for m in _REPORT.finditer(text)}
        for name in ("tile_compare(cuda)", "tile_compare_lanes(cuda)"):
            if counts.get(name) != 0:
                raise RuntimeError("--checkcuda %s: %s reports %s"
                                   % (path, name, counts.get(name)))
        if kc.launches == 0 or ka.launches["444"] == 0:
            raise RuntimeError("--checkcuda: C or A was not launched")
        pinned = CHECKCUDA_420 if "-420" in path else {}
        over = {k: v for k, v in counts.items() if v > pinned.get(k, 0)}
        # 9 blurs, 16 other stages, the two kernels.
        if len(counts) != 27 or over:
            raise RuntimeError("--checkcuda %s: %d stage lines, over the "
                               "pinned counts: %s" % (path, len(counts),
                                                      over))
        c_launches += kc.launches
    tmp.cleanup()
    return c_launches


def phase_butteraugli(dev):
    """The butteraugli CLI on the card: bees96x64 against the reference
    encoder's q95 JPEG of it."""
    from guetzli_tpu_torch import butteraugli_cli
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = butteraugli_cli.main([
            str(REPO / "tests/fixtures/bees96x64.png"),
            str(REPO / "tests/fixtures/bees96x64_ref_q95.jpg")])
    d = float(out.getvalue().strip()) if rc == 0 else float("nan")
    rel = abs(d - BUTTERAUGLI_CPU) / BUTTERAUGLI_CPU
    log("butteraugli_cli bees96x64 vs its reference q95 JPEG: %.6f (CPU "
        "%.6f, rel %.2e), %.2f s" % (d, BUTTERAUGLI_CPU, rel,
                                     time.time() - t0))
    if not (rel <= BUTTERAUGLI_RTOL and 0.5 < d < 1.2):
        raise RuntimeError("butteraugli distance %r outside its band" % d)


def phase_444p_e2e(dev, default_out):
    """GUETZLI_TPU_PALLAS=1 encodes of the two PNGs: mode "444p" runs C
    and not B, and gives the default path's bytes. Returns C's
    launches."""
    from guetzli_tpu_torch import api
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    old = os.environ.get("GUETZLI_TPU_PALLAS")
    os.environ["GUETZLI_TPU_PALLAS"] = "1"
    c_launches = 0
    try:
        for path, golden in E2E[:2]:
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            out = api.encode_bytes((REPO / path).read_bytes(),
                                   quality=QUALITY, device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t0
            log("GUETZLI_TPU_PALLAS=1 %s q%d: %.2f s, %d bytes (default "
                "path %d), launches %s %d, %s %d"
                % (path, QUALITY, wall, len(out), len(default_out[path]),
                   kc.ENTRY, kc.launches, zl.ENTRY["444"],
                   zl.launches["444"]))
            _check_golden(path, out, golden)
            if out != default_out[path]:
                raise RuntimeError("%s: mode 444p gives other bytes" % path)
            if kc.launches == 0 or zl.launches["444"] != 0:
                raise RuntimeError("%s: mode 444p must launch C and not B"
                                   % path)
            c_launches += kc.launches
    finally:
        if old is None:
            del os.environ["GUETZLI_TPU_PALLAS"]
        else:
            os.environ["GUETZLI_TPU_PALLAS"] = old
    return c_launches


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.kernels import build
    dev = resolve("cuda")
    phase_device(build)
    records = []
    for states in (mosaic444(dev), mosaic420(dev)):
        for mode, state in states.items():
            records.append(phase_compare(mode, state, dev))
            records.append(phase_greedy(mode, state, dev,
                                        1 if mode == "420c" else 3))
            if mode == "444":
                records.append(phase_tile_compare(state, dev))
                phase_greedy_444p(state, dev)
    launches, outputs = phase_e2e(dev)
    # Kernel C's paths: --checkcuda and the opt-in 444p search.
    launches["tile_compare"] = (phase_checkcuda(dev)
                                + phase_444p_e2e(dev, outputs))
    phase_butteraugli(dev)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
