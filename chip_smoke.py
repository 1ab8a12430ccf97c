#!/usr/bin/env python3
"""Smoke run of guetzli_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from guetzli_tpu_torch/csrc with nvcc and holds
each of the seven entry points against its plain PyTorch version at the
main paths' shapes, and times them:

  * 4:4:4, on tests/corpus/photo_mosaic1.png (1444x908): the block compare
    A and the greedy zeroing kernel B (mode "444"), and the blocks-leading
    compare C on A's lanes (equal to A bit for bit), then the opt-in
    greedy pass "444p" (the staged loop with C per step) against B's CSR,
    with the wall of the pass, C's launches in it, the summed event
    windows of its wrapper (the five operand moves of compare_lanes with
    the launch) and of the launch alone, and C's summed device time from a
    torch.profiler trace of a second pass;
  * 4:2:0, on tests/corpus/photo_mosaic1-420.jpg read by the port's JPEG
    reader: the Y pass (A' and B', mode "420y", comp_mask 1) and the chroma
    pass over 16x16 macroblocks (A'' and B'', mode "420c", comp_mask 6).

The greedy kernels' rails must equal the plain loop's on every block
row, and the team compares (A, A', A'' and C) must equal their plain
versions bit for bit. For every kernel (all seven are team kernels: B,
B', B'', A, A', A'' and C, one CTA per 8x8 block or 16x16 macroblock) it
also prints the launch geometry (threads and shared memory per CTA, CTAs
per SM) and ptxas's registers and stack, and records the share of the
operation bound; its log line sets the time beside the per-thread
design's.

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
    which must give the default path's bytes;
  * the search route (the JAX package's accelerator route), on
    photo_mosaic1.png and photo_mosaic1-420.jpg: a quant wave of each size
    of Comparator.quant_batch_sizes() against as many single compares of
    the same matrices, bit for bit, with its wall and peak device memory
    per trial and pixel; the wave at photo_mosaic1 tiled 2x2 (5.24 MPix),
    exact and on its bucket;
    a seeded wave of sparse coefficient deltas, whole and in chunks,
    against a full compare of the same host image (distance and weights
    bit for bit); then both mosaics encoded with every route knob off,
    with the auto defaults and with each knob forced on alone, in turns
    over ROUTE_ROUNDS rounds (2 since the padded phase came, 3 before),
    each giving the default path's bytes, with the select_quant_matrix,
    backend_dispatch, backend_fetch and back_end walls and their medians;
  * the corpus path, with the quant tree: ``corpus_cli.main`` with 6
    threads over six images (three PNGs, three 4:2:0 JPEGs), each output
    equal to its serial encode_bytes bytes and within 2% of golden, with
    exactly one launch of each of B, B', B'', A, A' and A'' for the whole
    corpus (one per masking pass), and the lockstep encoder on one thread
    giving the same bytes, as does ``corpus_cli --serial --threads 3``
    (its pool only decodes; every compare from the calling thread). It
    logs the corpus wall, images/min, MPix/s,
    the sum of the serial walls, the phase walls, the CTAs of each
    launch, and the peak device memory and RSS. It runs the default
    route, whose geometry (config.auto("pad")) is the serial encodes';
  * the padded bucket geometry and the CompareBatcher: a padded compare
    of each mosaic against the exact one (ms, the diffmap at the valid
    pixels); one stacked compare of the 10 images of bucket 128x96 (PNGs
    at 4:4:4, their -420.jpg twins at 4:2:0) against their 10 single
    padded compares (every row's score, diffmap and weights bit for bit;
    ms; CUDA launches and top-level aten ops from torch.profiler); B, B'
    and B'' on the bucket block grids of the mosaics against the exact
    grids at the same state (CSR after real_index bit for bit, ms each);
    phase_e2e's five encodes with the padding forced on (golden band,
    distance at or below target, every greedy kernel and compare
    launched), then both mosaics with the padding on and off in turns,
    the paired walls behind config.CUDA_AUTO["pad"]; and three corpora
    through the lockstep corpus driver, padding on and off in turns,
    medians of 2: the 17 images of buckets 128x96 and 160x128 as 4:2:0
    JPEGs (auto route) and as PNGs (sparse off), and the corpus phase's
    six images of different sizes (auto route), with the compares
    through the batcher and the rows per stacked compare, the padded
    corpus's bytes equal to each image's serial padded encode, and one
    launch of each greedy kernel and compare of its passes in the first
    padded run of each corpus;
  * the mesh phase, one image over several ranks and the sharded corpus
    search step (guetzli_tpu_torch/parallel/; the card machine has one
    H100): (a) a one-rank NCCL group: ``corpus_cli --distributed`` over
    the corpus phase's six images, photo_mosaic1 and photo_mosaic1-420
    through the mesh path at one rank, each with the serial bytes, and
    the search step (parallel/corpus.py) on photo_mosaic1 and its mirror;
    (b) two ranks sharing the card through gloo (pinned host staging):
    ``sharded_blur`` of every sigma on a 908x1444 plane against the
    single-rank blur, then q95 encodes of bees96x64, photo_mosaic1,
    photo_mosaic1-420 (bands of 480 and 428 rows) and bees_d-420 (48 and
    15 rows): golden band, distance at or below target, whether the bytes
    equal one rank's, each greedy kernel (B, or B' and B'') launched once
    per rank over its band's blocks, the walls against the serial
    encode's; (c) ``--checkcuda --mesh 2`` on bees96x64 (its
    blur(sharded) line); (d) the search step at (batch, tile) = (2, 1)
    and (1, 2) against the one-rank step (the scores' and errors' largest
    relative differences, within 1e-3; whether the new coefficients are
    equal; kernel C once per rank per step over its lanes; the walls),
    and dryrun_multichip over the two ranks; then bees96x64's memory
    envelope (memory_envelope) against the CLI's guard;
  * the knobs phase, the JAX package's remaining variables: the
    EXACT_LUT variants of A, A', A'', B, B', B'' (the DY reads by table)
    on the mosaics' states against their plain versions under the knob,
    bit for bit (B, B', B'' both rails over the whole pass), each timed
    beside its closed form, and kernel C unmoved by the knob; bees96x64
    and bees_d-420 encoded under each of KNOB_SETTINGS (golden band,
    distance at or below target; the route and opt-out settings with
    the default bytes), with each encode's wall, backend_serialize and
    zeroing_loop walls and launches; photo_mosaic1's 4:4:4 pass through
    the staged and full-batch zeroing routes against the fused kernel
    (CSR equal, walls); and a padded compare of photo_mosaic1 with the
    one-hot selections (bit for bit) and the lane-safe forms (within
    1e-4), ms each against the default's.

Every phase that fails makes the script exit nonzero. The last two lines
of standard output are the kernels' JSON record (the seven kernels and
the six EXACT_LUT variants, "+exact_lut", with their launches in the
knobs phase's EXACT_LUT=1 encodes) and {"ok": true, "device": {...}}.

Without a CUDA device, or outside the repository, it exits nonzero and
prints no result. ``python3 chip_smoke.py padded`` builds the kernels and
runs the padded phase alone, ``python3 chip_smoke.py mesh`` the mesh and
memory phases, ``python3 chip_smoke.py knobs`` the knobs phase,
``python3 chip_smoke.py kernels`` the seven kernels' phases (no result
lines).
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
# The suffix of an EXACT_LUT variant's name in the kernels' JSON record.
EXACT = "+exact_lut"

# The corpus phase's inputs and their golden sizes at q95
# (tests/golden_corpus.txt), and its threads.
CORPUS = [("tests/corpus/photo_mosaic1.png", 393811),
          ("tests/corpus/photo_mosaic2.png", 329315),
          ("tests/corpus/photo_hopper.png", 69027),
          ("tests/corpus/photo_mosaic1-420.jpg", 348714),
          ("tests/corpus/photo_hopper-420.jpg", 62786),
          ("tests/corpus/bees_d-420.jpg", 1681)]
CORPUS_THREADS = 6

# The padded phase's two buckets of tests/corpus/ (PNGs and their -420.jpg
# twins): 128x96 and 160x128.
BUCKET_128x96 = ["bees_g", "bees_j", "grad1", "noise0", "noise1",
                 "plasma3", "silver0", "silver1", "text0", "text1"]
BUCKET_160x128 = ["bees_a", "bees_b", "bees_f", "bees_h", "bees_up",
                  "grad3", "stripes1"]

# The route phase: the JAX package's accelerator search route (quant-tree
# waves, quant speculation, sparse back-end deltas, the back-end
# pipeline) on the two mosaics. Each encode runs with every route knob
# forced off, with the auto defaults (config.CUDA_AUTO), and with one
# knob forced on, in turns over ROUTE_ROUNDS rounds.
ROUTE = [("tests/corpus/photo_mosaic1.png", 393811),
         ("tests/corpus/photo_mosaic1-420.jpg", 348714)]
ROUTE_KNOBS = ("TREE_QUANT", "SPECULATE", "SPARSE", "PIPELINE")
ROUTE_CONFIGS = ([("off", dict.fromkeys(ROUTE_KNOBS, "0")), ("auto", {})]
                 + [(k.lower(), dict(dict.fromkeys(ROUTE_KNOBS, "0"),
                                     **{k: "1"})) for k in ROUTE_KNOBS])
ROUTE_ROUNDS = 2
# Seed and size of the route phase's sparse delta wave.
SPARSE_SEED = 9
SPARSE_FLIPS = 20000

# The mesh phase: one image's encode over the ranks of a group
# (guetzli_tpu_torch/parallel/), on the card's one H100: a one-rank NCCL
# group, and two ranks sharing the card through gloo.
MESH_ENCODES = ("tests/fixtures/bees96x64.png",
                "tests/corpus/photo_mosaic1.png",
                "tests/corpus/photo_mosaic1-420.jpg",
                "tests/corpus/bees_d-420.jpg")
# The sharded corpus search step (parallel/corpus.py): photo_mosaic1 and
# its left-right mirror, a batch of two same-geometry images; its
# (batch, tile) layouts over two ranks; and the relative difference from
# the one-rank step it is held to (the JAX package's own bar,
# tests/test_parallel.py).
STEP_IMAGE = "tests/corpus/photo_mosaic1.png"
STEP_LAYOUTS = (2, 1)
STEP_RTOL = 1e-3
MESH_PLANE = (908, 1444)
MESH_SEED = 11
MESH_TIMEOUT = 600.0

# The knobs phase: the JAX package's remaining variables, each forced on
# bees96x64 and bees_d-420 at q95. The numeric ones (EXACT_LUT,
# LANE_SAFE, SEL_MATMUL) may move bits; the route and opt-out ones must
# give the default bytes, but for LANES=0, whose blocks-leading compare
# (ops/tiles.py) is another rounding of the block error than the
# lane-major one, as in the JAX package (held to the golden band).
KNOB_ENCODES = (E2E[0], E2E[2])
KNOB_SETTINGS = [
    ("EXACT_LUT=1", {"EXACT_LUT": "1"}, False),
    ("LANE_SAFE=1", {"LANE_SAFE": "1"}, False),
    ("SEL_MATMUL=1", {"SEL_MATMUL": "1"}, False),
    ("ZEROING_FUSED=0", {"ZEROING_FUSED": "0"}, True),
    ("LANES=0 ZEROING_FUSED=0", {"LANES": "0", "ZEROING_FUSED": "0"}, False),
    ("STAGED_ZEROING=0", {"STAGED_ZEROING": "0"}, True),
    ("NO_NATIVE=1", {"NO_NATIVE": "1"}, True),
    ("NO_INCR_SAVE=1 NO_HISTO_REUSE=1",
     {"NO_INCR_SAVE": "1", "NO_HISTO_REUSE": "1"}, True),
    ("PALLAS=1 EXACT_LUT=1", {"PALLAS": "1", "EXACT_LUT": "1"}, False),
]
KNOB_VARS = ("EXACT_LUT", "LANE_SAFE", "SEL_MATMUL", "ZEROING_FUSED",
             "LANES", "STAGED_ZEROING", "NO_NATIVE", "NO_INCR_SAVE",
             "NO_HISTO_REUSE", "PALLAS", "ZEROING_DEBUG")

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

# The team kernels in their per-thread design (one thread runs a block's
# whole loop or compare), ms on an NVIDIA H100 80GB HBM3 at 700 W, at the
# shapes of phase_greedy, phase_compare and phase_tile_compare (PERF.md,
# section 6), for the log only: the kernels' JSON record holds this run's
# numbers alone.
PREV_MS = {"zeroing_loop": 150.3, "zeroing_loop_420c": 267.7,
           "zeroing_loop_420y": 57.25, "tile_compare_lanes_420c": 1.507,
           "tile_compare_lanes": 1.027, "tile_compare_lanes_420y": 1.021,
           "tile_compare": 1.097}


def log(*a):
    print(*a, flush=True)


def compare_block_ops(mode):
    """Float and integer operations of one block evaluation in `mode`,
    counted from csrc/compare_team.cuh (an 8-term contraction output is 8
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


def ptxas_report(text):
    """kernel -> {"registers", "stack_bytes", "spill_stores",
    "spill_loads"} from nvcc's -Xptxas -v output (entry functions only)."""
    out, entry, props = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = out.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and props is not None:
            props.update(stack_bytes=int(m.group(1)),
                         spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    return out


def team_report(rec, lib, geo, what):
    """Logs a team kernel's geometry and ptxas report (from the build of
    library `lib`) beside the per-thread design's time, and adds them and
    the bound share to its JSON record `rec`."""
    from guetzli_tpu_torch.kernels import build
    name = rec["name"]
    ptx = ptxas_report(build.build_log.get(lib, {}).get("ptxas", "")) \
        .get(name + "_kernel", {})
    log("%s (team kernel, one CTA per %s): %d threads and %d B of shared "
        "memory per CTA, %d CTAs per SM; ptxas %s; %.2fx the per-thread "
        "design's %.4g ms"
        % (name, what, geo["threads"], geo["smem_bytes"], geo["ctas_per_sm"],
           ptx or "not built in this run", PREV_MS[name] / rec["ms"],
           PREV_MS[name]))
    rec.update(bound_share=rec["bound_ms"] / rec["ms"],
               threads_per_cta=geo["threads"], smem_per_cta=geo["smem_bytes"],
               ctas_per_sm=geo["ctas_per_sm"], ptxas=ptx)


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
    if mode in ka.TEAM and not equal:
        raise RuntimeError("team compare %s is not bit-equal to its plain "
                           "version" % name)
    ms = time_cuda(lambda: ka.tile_compare_lanes(ct, *lanes, mode=mode), 10)
    plain_ms = time_cuda(lambda: tl.COMPARE[mode](ct, *lanes), 3)
    b_ms, by = bound_ms(mode, n, n * compare_bytes(mode))
    log("%s: %.4f ms (median of 10), plain %.3f ms, bound %.4f ms (%s)"
        % (name, ms, plain_ms, b_ms, by))
    replaces = ("guetzli_tpu/kernels/tile_compare_lanes.py:119"
                if mode == "444" else
                "guetzli_tpu/ops/tiles_lanes.py:%d (XLA, no pallas_call)"
                % (331 if mode == "420y" else 380))
    rec = {"name": name, "route": "cuda",
           "source": "guetzli_tpu_torch/csrc/tile_compare_lanes.cu",
           "replaces": replaces, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": None}
    if mode in ka.TEAM:
        team_report(rec, "tile_compare_lanes", ka.team_geometry(mode, dev),
                    "macroblock" if mode == "420c" else "block")
    return rec


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
    if not bool(rows_same.all()):
        raise RuntimeError("%s differs from its plain version on %d of %d "
                           "block rows" % (name, int((~rows_same).sum()),
                                           rows_same.numel()))
    ms = time_cuda(lambda: zl.zeroing_loop(*args, mode=mode), 3)
    plain_ms = time_cuda(lambda: zl.zeroing_loop_plain(*args, mode=mode),
                         plain_reps)
    nrem = args[2].long()
    evals = int(torch.where(nrem >= 2, 3 * nrem - 3, nrem).sum())
    n = nrem.numel()
    b_ms, by = bound_ms(mode, evals, n * greedy_bytes(mode))
    log("%s: %.3f ms (median of 3) for %d blocks, %d evaluations; plain "
        "%.1f ms (median of %d); bound %.4f ms (%s), %.2f%% of it"
        % (name, ms, n, evals, plain_ms, plain_reps, b_ms, by,
           100 * b_ms / ms))
    rec = {"name": name, "route": "cuda",
           "source": "guetzli_tpu_torch/csrc/zeroing_loop.cu",
           "replaces": "guetzli_tpu/kernels/zeroing_loop.py:301 (mode %s)"
           % mode, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    if mode in zl.TEAM:
        team_report(rec, "zeroing_loop", zl.team_geometry(mode, dev),
                    "block")
    return rec


def phase_tile_compare(state, dev):
    """Kernel C on the lanes of phase_compare("444"), moved to blocks
    leading, with the selection matrices of the block state: against its
    plain version and against kernel A on the same lanes, both bit for
    bit; and against its plain version with rows that no edge clamp
    gives."""
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
    # Rows that no edge clamp gives: one or two ones, or none.
    rng = np.random.default_rng(0)
    eye = np.eye(8, dtype=np.int32)

    def general(m):
        m = m.cpu().numpy()
        m = np.maximum(m, eye[rng.integers(0, 8, m.shape[:2])])
        m = m * (rng.random(m.shape[:2]) >= 0.125)[..., None]
        return torch.as_tensor(m.astype(np.int32), device=dev)
    gen = args[:3] + (general(sy), general(sx))
    same_gen = bool(torch.equal(kc.tile_compare(*gen),
                                kc.tile_compare_plain(*gen)))
    log("%s vs plain with general 0/1 selection rows: bit-equal %s"
        % (kc.ENTRY, same_gen))
    if not same_gen:
        raise RuntimeError("%s disagrees with its plain version on general "
                           "selection rows" % kc.ENTRY)
    ms = time_cuda(lambda: kc.tile_compare(*args), 10)
    plain_ms = time_cuda(lambda: kc.tile_compare_plain(*args), 3)
    b_ms, by = bound_ms("444p", n, n * compare_bytes("444p"))
    log("%s: %.4f ms (median of 10), plain %.3f ms, bound %.4f ms (%s)"
        % (kc.ENTRY, ms, plain_ms, b_ms, by))
    rec = {"name": kc.ENTRY, "route": "cuda",
           "source": "guetzli_tpu_torch/csrc/tile_compare.cu",
           "replaces": "guetzli_tpu/kernels/tile_compare.py:430",
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    team_report(rec, "tile_compare", kc.team_geometry(dev), "block")
    return rec


def _event_windows(module, names, windows):
    """Wraps module.<name> for each of `names` so that every call records
    CUDA events around it into windows[name]; returns the originals."""
    orig = {n: getattr(module, n) for n in names}

    def wrap(name):
        def call(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig[name](*a, **k)
            ev[1].record()
            windows[name].append(ev)
            return out
        return call
    for n in names:
        setattr(module, n, wrap(n))
    return orig


def phase_greedy_444p(state, dev):
    """The opt-in greedy pass "444p" on photo_mosaic1: the staged loop
    with kernel C per step, whose CSR must equal fused B's bit for bit.
    Logs the pass's wall and C's launches, then, from a second pass, the
    summed CUDA-event windows of compare_lanes (the five operand moves and
    the launch) and of tile_compare (the checks, the allocation and the
    kernel), and from a third under torch.profiler, C's summed device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    limit = np.float32(target())
    x0, sc, ysel, xsel = aux
    aux_p = (x0, sc) + kc.selection_matrices(ysel, xsel)
    fused = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask, dev,
                                        mode="444", fused=True)

    def run():
        return zeroing.compute_zeroing_csr(blocks, orig, limit, aux_p, mask,
                                           dev, mode="444p")
    kc.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    staged = run()
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
    names = ("compare_lanes", "tile_compare")
    windows = {k: [] for k in names}
    saved = _event_windows(kc, names, windows)
    try:
        run()
    finally:
        for k, fn in saved.items():
            setattr(kc, k, fn)
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in windows.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if "tile_compare_kernel" in e.key) / 1e3
    dev_n = sum(e.count for e in prof.key_averages()
                if "tile_compare_kernel" in e.key)
    log("mode 444p event windows over %d steps: compare_lanes %.2f ms, "
        "tile_compare %.2f ms; %s device time under torch.profiler %s"
        % (len(windows["tile_compare"]), ms["compare_lanes"],
           ms["tile_compare"], kc.ENTRY,
           "%.3f ms in %d launches" % (dev_ms, dev_n) if dev_n
           else "not measured (the trace holds no such kernel)"))
    return n


def _launch_counts(exact=False):
    """Kernel name -> launches since the last reset (exact: those of the
    EXACT_LUT variants of A, A', A'', B, B', B'')."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    if exact:
        out = {ka.ENTRY[m] + EXACT: ka.exact_launches[m] for m in MODES}
        out.update({zl.ENTRY[m] + EXACT: zl.exact_launches[m]
                    for m in MODES})
        return out
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
        ka.exact_launches[m] = 0
        zl.exact_launches[m] = 0
    kc.launches = 0


def _check_golden(path, out, golden):
    if abs(len(out) - golden) > BAND * golden:
        raise RuntimeError("%s: %d bytes, outside %d +- 2%%"
                           % (path, len(out), golden))


def _serial_encode(path, dev, stats=None):
    """api.encode_bytes of a file on the card at QUALITY: (bytes, wall
    seconds, ending in a sync)."""
    from guetzli_tpu_torch import api
    data = (REPO / path).read_bytes()
    torch.cuda.synchronize()
    t0 = time.time()
    out = api.encode_bytes(data, quality=QUALITY, stats=stats, device=dev)
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase_e2e(dev):
    """The main paths: api.encode_bytes on the card, PNG and JPEG in.
    Returns (launches, path -> output bytes, path -> wall seconds)."""
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.search.processor import ProcessStats
    _reset_launches()
    outputs, walls = {}, {}
    for path, golden in E2E:
        stats = ProcessStats()
        before = _launch_counts()
        out, wall = _serial_encode(path, dev, stats)
        walls[path] = wall
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
    return launches, outputs, walls


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


def _count_ctas(ctas):
    """Wraps the greedy and compare kernels' wrappers as the zeroing call
    reaches them, recording (entry, CTAs, CUDA events around the call) of
    each call (one CTA per block or macroblock, one per lane for a
    compare); returns an undo."""
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.search import zeroing
    loop, compare = zl.zeroing_loop, zeroing.tile_compare_lanes

    def timed(fn, name, n, *a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*a, **k)
        ev[1].record()
        ctas.append((name, n, ev))
        return out

    def loop_spy(coeffs_t, *a, mode="444", **k):
        return timed(loop, zl.ENTRY[mode], coeffs_t.shape[1], coeffs_t, *a,
                     mode=mode, **k)

    def compare_spy(ct, *a, mode="444", **k):
        return timed(compare, ka.ENTRY[mode], ct.shape[-1], ct, *a,
                     mode=mode, **k)
    zl.zeroing_loop, zeroing.tile_compare_lanes = loop_spy, compare_spy

    def undo():
        zl.zeroing_loop, zeroing.tile_compare_lanes = loop, compare
    return undo


def phase_corpus(dev, outputs, walls):
    """The corpus path on the card: corpus_cli.main over CORPUS with
    CORPUS_THREADS threads, against each image's serial bytes (phase_e2e's
    where it encoded the image) and golden size; then the lockstep encoder
    on one thread. Returns the corpus run's launches."""
    import resource
    from guetzli_tpu_torch import corpus_cli
    from guetzli_tpu_torch.api import _peek_geometry
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.parallel.lockstep import encode_corpus_lockstep
    for path, _golden in CORPUS:
        if path not in outputs:
            outputs[path], walls[path] = _serial_encode(path, dev)
            log("%s q%d serial: %.2f s, %d bytes"
                % (path, QUALITY, walls[path], len(outputs[path])))
    serial_sum = sum(walls[p] for p, _g in CORPUS)
    mpix = sum(int(np.prod(_peek_geometry((REPO / p).read_bytes())))
               for p, _g in CORPUS) / 1e6
    tmp = tempfile.TemporaryDirectory()
    out_dir = pathlib.Path(tmp.name)
    ctas = []
    undo = _count_ctas(ctas)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = corpus_cli.main(
                ["--threads", str(CORPUS_THREADS), "--quality", str(QUALITY),
                 "--verbose", "--out", str(out_dir)]
                + [str(REPO / p) for p, _g in CORPUS])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        undo()
    launches = _launch_counts()
    m = re.search(r"^phase walls: (.*)$", err.getvalue(), re.M)
    phase = json.loads(m.group(1)) if m else {}
    log("corpus_cli, %d images (%.3f MPix), %d threads, q%d: rc %d, %.2f s "
        "(%.2f images/min, %.4f MPix/s); the serial encodes' walls sum to "
        "%.2f s (%.2fx); phase walls %s; CLI line %s"
        % (len(CORPUS), mpix, CORPUS_THREADS, QUALITY, rc, wall,
           60.0 * len(CORPUS) / wall, mpix / wall, serial_sum,
           serial_sum / wall,
           ", ".join("%s %.2f s" % kv for kv in sorted(phase.items())),
           out.getvalue().strip()))
    log("corpus launches (CTAs, event window of the wrapper): %s; launches "
        "%s; peak device memory %.1f MiB (torch.cuda.max_memory_allocated), "
        "process peak RSS %.1f MiB"
        % (", ".join("%s %d CTAs %.3f ms" % (n, c, a.elapsed_time(b))
                     for n, c, (a, b) in ctas),
           ", ".join("%s %d" % kv for kv in launches.items()),
           torch.cuda.max_memory_allocated(dev) / 2**20,
           resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024))
    if rc != 0:
        raise RuntimeError("corpus_cli exited %d:\n%s" % (rc, err.getvalue()))
    c_launches = launches.pop(kc.ENTRY)
    if c_launches or set(launches.values()) != {1}:
        raise RuntimeError("the corpus run must launch each of B, B', B'', "
                           "A, A', A'' once and C never: %s" % launches)
    for path, golden in CORPUS:
        got = (out_dir / (pathlib.Path(path).stem + ".jpg")).read_bytes()
        log("  %s: %d bytes (serial %d, golden %d, %+.2f%%)"
            % (path, len(got), len(outputs[path]), golden,
               100.0 * (len(got) - golden) / golden))
        if got != outputs[path]:
            raise RuntimeError("%s: the corpus gives other bytes than the "
                               "serial encode" % path)
        _check_golden(path, got, golden)
    tmp.cleanup()
    walls1 = {}
    items = [(p, (REPO / p).read_bytes()) for p, _g in CORPUS]
    torch.cuda.synchronize()
    t0 = time.time()
    one = encode_corpus_lockstep(items, quality=QUALITY, threads=1,
                                 phase_walls=walls1, device=dev)
    torch.cuda.synchronize()
    log("encode_corpus_lockstep, 1 thread: %.2f s, phase walls %s, the "
        "same bytes as 6 threads: %s"
        % (time.time() - t0,
           ", ".join("%s %.2f s" % kv for kv in sorted(walls1.items())),
           all(d == outputs[p] for p, d in one)))
    if any(d != outputs[p] for p, d in one):
        raise RuntimeError("1 and %d threads give other bytes"
                           % CORPUS_THREADS)
    serial_threads(outputs)
    return launches


def serial_threads(outputs, threads=3):
    """corpus_cli --serial --threads 3 over CORPUS: api.encode_corpus's
    pool decodes while the encodes run one at a time on the calling
    thread; each output must be its serial encode's bytes, and every
    compare must come from the calling thread."""
    import threading

    from guetzli_tpu_torch import comparator as cmp_mod
    from guetzli_tpu_torch import corpus_cli
    tmp = tempfile.TemporaryDirectory()
    out_dir = pathlib.Path(tmp.name)
    seen = set()
    dispatch = cmp_mod.Comparator.dispatch_compare

    def spy(self, img):
        seen.add(threading.current_thread().name)
        return dispatch(self, img)
    cmp_mod.Comparator.dispatch_compare = spy
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = corpus_cli.main(
                ["--serial", "--threads", str(threads), "--quality",
                 str(QUALITY), "--out", str(out_dir)]
                + [str(REPO / p) for p, _g in CORPUS])
        torch.cuda.synchronize()
    finally:
        cmp_mod.Comparator.dispatch_compare = dispatch
    same = [(out_dir / (pathlib.Path(p).stem + ".jpg")).read_bytes()
            == outputs[p] for p, _g in CORPUS]
    log("corpus_cli --serial --threads %d: rc %d, %.2f s; the serial bytes: "
        "%s; compares issued from threads %s"
        % (threads, rc, time.time() - t0, same, sorted(seen)))
    if rc != 0 or not all(same) or seen != {threading.current_thread().name}:
        raise RuntimeError("corpus_cli --serial --threads %d failed:\n%s"
                           % (threads, err.getvalue()[-3000:]))
    tmp.cleanup()


@contextlib.contextmanager
def _route_env(env):
    """Set the route knobs' variables as `env` says (unset the others)
    for the block."""
    keys = ["GUETZLI_TPU_" + k for k in ROUTE_KNOBS]
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update({"GUETZLI_TPU_" + k: v for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _quant_start(path, dev, tile=1, padded=None):
    """A comparator (padded as `padded` says, None: the default) and the
    quant search's base image for `path` (tiled tile x tile), its
    downsample flag and its input matrix."""
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    from guetzli_tpu_torch.search.processor import (_copy_jpeg,
                                                    decode_jpeg_to_rgb)
    data = (REPO / path).read_bytes()
    if data[:2] == b"\xff\xd8":
        jpg_in = reader.read_jpeg(data)
        rgb, w, h = decode_jpeg_to_rgb(jpg_in), jpg_in.width, jpg_in.height
    else:
        rgb, w, h = read_png(data)
        if tile > 1:
            rgb = np.ascontiguousarray(np.tile(rgb, (tile, tile, 1)))
            w, h = tile * w, tile * h
        jpg_in = encode_rgb_to_jpeg(rgb, w, h)
    comp = Comparator(rgb, w, h, target(), dev, padded=padded)
    jpg = _copy_jpeg(jpg_in)
    q_in = st.remove_original_quantization(jpg)
    return comp, st.CoeffImage.from_jpeg(jpg), jpg_in.is_420(), q_in


def _subtree(downsample, q_in, n):
    """The first n matrices of the quant search's subtree from its start
    (search/quant_tree.py), depth 4."""
    from guetzli_tpu_torch.search.processor import QuantMatrixGenerator
    from guetzli_tpu_torch.search.quant_tree import _enumerate_subtree
    return _enumerate_subtree(QuantMatrixGenerator(downsample), q_in, True,
                              4)[:n]


def _wave(comp, base, qs):
    """One wave through dispatch_quant_batch: (scores, wall ms, peak
    device bytes above the memory allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.time()
    scores = comp.fetch_quant_scores(comp.dispatch_quant_batch(base, qs))
    torch.cuda.synchronize()
    return (scores, 1e3 * (time.time() - t0),
            torch.cuda.max_memory_allocated() - m0)


def route_waves(dev):
    """Each wave size of quant_batch_sizes() on both mosaics against as
    many single compares of the same matrices, bit for bit; the wave's
    wall and peak device memory per trial and pixel. Returns the largest
    peak per trial and pixel."""
    worst = 0.0
    for path, _golden in ROUTE:
        comp, img, ds, q_in = _quant_start(path, dev)
        sizes = comp.quant_batch_sizes()
        qs = _subtree(ds, q_in, max(sizes))
        if len(qs) < max(sizes):
            raise RuntimeError("%s: %d subtree matrices" % (path, len(qs)))
        trials = []
        for q in qs:
            t = img.copy()
            t.apply_global_quantization(q)
            trials.append(t)
        torch.cuda.synchronize()
        t0 = time.time()
        singles = [comp.compare_img(t) for t in trials]
        single_ms = 1e3 * (time.time() - t0) / len(trials)
        base = comp.quant_base_upload(img)
        npix = comp.width * comp.height
        for b in sizes:
            _wave(comp, base, qs[:b])              # warm-up
            scores, ms, peak = _wave(comp, base, qs[:b])
            same = [float(scores[i]) == singles[i] for i in range(b)]
            worst = max(worst, peak / b / npix)
            log("route wave %s, B=%d (sizes %s): %.2f ms (%.2f ms a trial; "
                "a single compare %.2f ms); peak %.1f MiB above the "
                "resident state, %.0f B per trial and pixel; scores equal "
                "the single compares bit for bit: %s"
                % (path, b, sizes, ms, ms / b, single_ms, peak / 2**20,
                   peak / b / npix, all(same)))
            if not all(same):
                raise RuntimeError("%s: wave B=%d scores %s, single %s"
                                   % (path, b, list(scores), singles[:b]))
    return worst


def route_wave_large(dev):
    """The wave at the 5.24 MPix of memory_envelope's tiled input, at the
    exact geometry and on its bucket: the size quant_batch_sizes() gives
    there must run."""
    for padded in (False, True):
        comp, img, ds, q_in = _quant_start(ROUTE[0][0], dev, tile=2,
                                           padded=padded)
        sizes = comp.quant_batch_sizes()
        qs = _subtree(ds, q_in, sizes[-1])
        base = comp.quant_base_upload(img)
        _scores, ms, peak = _wave(comp, base, qs)
        npix = (comp.geom.wp * comp.geom.hp if padded
                else comp.width * comp.height)
        log("route wave photo_mosaic1 tiled 2x2 (%dx%d, %s): sizes %s, "
            "B=%d: %.2f ms, peak %.1f MiB above the resident state (%.0f B "
            "per trial and pixel), card total %.1f MiB"
            % (comp.width, comp.height, "bucket %dx%d" % (
                comp.geom.wp, comp.geom.hp) if padded else "exact", sizes,
               len(qs), ms, peak / 2**20, peak / len(qs) / npix,
               torch.cuda.get_device_properties(0).total_memory / 2**20))
        del comp, img, base
        torch.cuda.empty_cache()


def route_sparse(dev):
    """A seeded wave of SPARSE_FLIPS coefficient deltas into the resident
    state of photo_mosaic1, unchunked and in chunks of 4096, against a
    full compare of the same host image: distance and [4, NB] weights bit
    for bit."""
    comp, img, _ds, q_in = _quant_start(ROUTE[0][0], dev)
    img.apply_global_quantization(q_in)
    before = img.copy()
    rng = np.random.RandomState(SPARSE_SEED)
    nb = img.bw * img.bh
    key = np.unique(rng.randint(0, nb, SPARSE_FLIPS) * 192
                    + rng.randint(0, 3, SPARSE_FLIPS) * 64
                    + rng.randint(1, 64, SPARSE_FLIPS))
    bs, cks = key // 192, key % 192
    for c in range(3):
        sel = (cks >> 6) == c
        img.comps[c].coeffs[bs[sel], cks[sel] & 63] = 0
    vals = np.zeros(len(key), np.int32)
    torch.cuda.synchronize()
    t0 = time.time()
    full = comp.fetch_compare(
        comp.dispatch_compare_with_weights(img, 1, 1.0, 1, 1))
    full_ms = 1e3 * (time.time() - t0)
    for top in (None, 4096):
        comp.backend_sync_full(before)
        if top:
            comp._SPARSE_COEFF_TOP = comp._SPARSE_COEFF_CHUNK = top
        torch.cuda.synchronize()
        t0 = time.time()
        got = comp.fetch_compare(comp.dispatch_compare_sparse_coeffs(
            img, bs, cks, vals, 1, 1.0, 1, 1))
        ms = 1e3 * (time.time() - t0)
        same = got[0] == full[0] and np.array_equal(got[1], full[1])
        log("route sparse wave, %d coefficients%s: %.2f ms (full upload "
            "and compare %.2f ms); distance %.6f, weights [4, %d]; equal "
            "to the full compare bit for bit: %s"
            % (len(key), ", chunks of %d" % top if top else "", ms,
               full_ms, got[0], nb, same))
        if not same:
            raise RuntimeError("sparse wave differs from the full compare")


def route_encodes(dev, outputs):
    """Both mosaics encoded under every ROUTE_CONFIGS entry, in turns
    (the order reversed every other round), with the launch counts set to
    0 before and read after: each encode's bytes must equal the
    default path's (phase_e2e) and lie within 2% of golden, and every
    kernel of the 4:4:4 and 4:2:0 paths must launch. Returns
    {config: {path: [(wall, timings, counters), ...]}}."""
    from guetzli_tpu_torch import config
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.search.processor import ProcessStats
    log("route auto on cuda: %s" % config.CUDA_AUTO)
    _reset_launches()
    runs = {name: {p: [] for p, _g in ROUTE} for name, _e in ROUTE_CONFIGS}
    for r in range(ROUTE_ROUNDS):
        order = ROUTE_CONFIGS if r % 2 == 0 else ROUTE_CONFIGS[::-1]
        for name, env in order:
            for path, golden in ROUTE:
                stats = ProcessStats()
                with _route_env(env):
                    out, wall = _serial_encode(path, dev, stats)
                t, c = stats.timings, stats.counters
                runs[name][path].append((wall, t, c))
                log("route %s, %s: %.2f s, %d bytes; select_quant_matrix "
                    "%.3f s (trials %d, waves %d of %d trials), back_end "
                    "%.3f s (backend_dispatch %.3f, backend_fetch %.3f, "
                    "iterations %d)"
                    % (name, path, wall, len(out),
                       t.get("select_quant_matrix", 0),
                       c.get("quant_trials", 0), c.get("quant_waves", 0),
                       c.get("quant_wave_trials", 0), t.get("back_end", 0),
                       t.get("backend_dispatch", 0),
                       t.get("backend_fetch", 0), c.get("backend_iters", 0)))
                if stats.search_error is not None:
                    raise RuntimeError("search failed: %s"
                                       % stats.search_error)
                _check_golden(path, out, golden)
                if out != outputs[path]:
                    raise RuntimeError("%s under %s: %d bytes, the default "
                                       "path gave %d" % (
                                           path, name, len(out),
                                           len(outputs[path])))
    launches = _launch_counts()
    launches.pop(kc.ENTRY)
    log("route launches: %s" % ", ".join("%s %d" % kv
                                         for kv in launches.items()))
    if min(launches.values()) == 0:
        raise RuntimeError("a kernel was not launched on the route's "
                           "encodes: %s" % launches)
    for name, _e in ROUTE_CONFIGS:
        for path, _g in ROUTE:
            rs = runs[name][path]
            med = {k: float(np.median([t.get(k, 0.0) for _w, t, _c in rs]))
                   for k in ("select_quant_matrix", "backend_dispatch",
                             "backend_fetch", "back_end")}
            log("route median %s, %s: wall %.3f s, %s" % (
                name, path, float(np.median([w for w, _t, _c in rs])),
                ", ".join("%s %.3f s" % kv for kv in med.items())))
    return runs


def phase_route(dev, outputs):
    """The accelerator search route: waves against single compares, the
    large wave, the sparse wave, then the paired encodes."""
    worst = route_waves(dev)
    log("route wave peak: at most %.0f B per trial and pixel "
        "(Comparator._QUANT_TRIAL_BYTES_PER_PIXEL %d)" % (
            worst, _trial_bytes()))
    route_wave_large(dev)
    route_sparse(dev)
    route_encodes(dev, outputs)


def _trial_bytes():
    from guetzli_tpu_torch.comparator import Comparator
    return Comparator._QUANT_TRIAL_BYTES_PER_PIXEL


def _pad_env(value):
    """GUETZLI_TPU_PAD set to `value` for the block (None: unset)."""
    return _env({"GUETZLI_TPU_PAD": value})


@contextlib.contextmanager
def _env(env):
    """Environment variables set as `env` says (None: unset) for the
    block."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _profile_counts(fn):
    """(CUDA kernel launches, top-level aten ops) of fn(), counted from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    aten = sum(1 for e in events if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    return launches, aten


def padded_single(dev):
    """One compare of each mosaic on its bucket against the exact
    geometry: ms each and the diffmap's largest relative difference at
    valid pixels."""
    for path, _golden in ROUTE:
        comps = {}
        for padded in (False, True):
            comp, img, _ds, _q = _quant_start(path, dev, padded=padded)
            comps[padded] = comp
            ms = time_cuda(lambda: comp.compare_img(img), 5)
            log("padded single %s, %s geometry (%dx%d%s): %.3f ms a "
                "compare (median of 5), distance %.6f"
                % (path, "bucket" if padded else "exact", comp.width,
                   comp.height, ", bucket %dx%d" % (comp.geom.wp,
                                                    comp.geom.hp)
                   if padded else "", ms, comp.distance))
        h, w = comps[False].height, comps[False].width
        ex = comps[False].distmap
        pd = comps[True].distmap
        diff = (pd[:h, :w] - ex).abs()
        rel = float((diff / ex.abs().clamp_min(1e-3)).max())
        close = bool((diff <= 1e-6 + 1e-5 * ex.abs()).all())
        outside = float(torch.cat([pd[h:].reshape(-1),
                                   pd[:, w:].reshape(-1)]).abs().max())
        log("padded single %s: diffmap at valid pixels: max abs "
            "difference %.3g, max relative %.3g (where the exact value is "
            ">= 1e-3), within rtol 1e-5 atol 1e-6: %s; max abs outside %.3g;"
            " distances %.6f / %.6f"
            % (path, float(diff.max()), rel, close, outside,
               comps[True].distance, comps[False].distance))
        if not close or outside != 0.0:
            raise RuntimeError("%s: the padded diffmap differs" % path)


def padded_stacked(dev):
    """One stacked compare of the 10 images of the 128x96 bucket, as PNGs
    (4:4:4, up, factor 1) and as 4:2:0 JPEGs (down, factor 2), against
    their single padded compares: rows bit for bit, ms, launches."""
    from guetzli_tpu_torch import comparator as cmp_mod
    for suffix, args in ((".png", (1, 1.0, 1, 1)),
                         ("-420.jpg", (-1, 1.0, 2, 2))):
        items = [_quant_start("tests/corpus/%s%s" % (n, suffix), dev,
                              padded=True) for n in BUCKET_128x96]
        comps = [c for c, _i, _d, _q in items]
        imgs = [i for _c, i, _d, _q in items]
        buckets = {(c.geom.wp, c.geom.hp) for c in comps}
        if buckets != {(128, 96)}:
            raise RuntimeError("buckets %s" % buckets)

        def singles():
            for c in comps:
                c.batcher = None
            return [c.fetch_compare(c.dispatch_compare_with_weights(m, *args))
                    + (c.distmap,) for c, m in zip(comps, imgs)]

        def stacked():
            b = cmp_mod.CompareBatcher()
            for c in comps:
                c.batcher = b
            hs = [c.dispatch_compare_with_weights(m, *args)
                  for c, m in zip(comps, imgs)]
            out = cmp_mod.fetch_compare_many(comps, hs)
            for c in comps:
                c.batcher = None
            return [o + (c.distmap,) for o, c in zip(out, comps)], b

        one = singles()
        many, b = stacked()
        same = [a[0] == s[0] and np.array_equal(a[1], s[1])
                and torch.equal(a[2], s[2]) for a, s in zip(many, one)]
        single_ms = [time_cuda(lambda c=c, m=m: c.fetch_compare(
            c.dispatch_compare_with_weights(m, *args)), 3)
            for c, m in zip(comps, imgs)]
        stacked_ms = time_cuda(stacked, 3)
        l1, a1 = _profile_counts(singles)
        ln, an = _profile_counts(stacked)
        log("padded stacked %s x%d (bucket 128x96, direction %d, factor "
            "%d): one stacked compare %.3f ms (median of 3; %d rows in %d "
            "flush) against %.3f ms for the %d single padded compares "
            "(%.3f ms each); CUDA launches %d against %d, top-level aten "
            "ops %d against %d; every row's score, diffmap and weights "
            "equal its single compare bit for bit: %s"
            % (suffix, len(comps), args[0], args[2], stacked_ms, b.rows,
               b.flushes, sum(single_ms), len(comps), np.mean(single_ms),
               ln, l1, an,
               a1, all(same)))
        if not all(same) or b.flushes != 1:
            raise RuntimeError("stacked %s rows differ from their single "
                               "compares: %s" % (suffix, same))


def _bucket_state(path, mask, dev):
    """(mode, blocks, orig, aux, real_index) of a zeroing pass on the
    bucket grid of `path`'s padded comparator, at the file's own
    quantization (as mosaic444 and mosaic420 build the exact grid's)."""
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                    decode_jpeg_to_rgb)
    data = (REPO / path).read_bytes()
    if data[:2] == b"\xff\xd8":
        jpg = reader.read_jpeg(data)
        rgb, w, h = decode_jpeg_to_rgb(jpg), jpg.width, jpg.height
    else:
        rgb, w, h = read_png(data)
        jpg = encode_rgb_to_jpeg(rgb, w, h)
    proc = Processor(Params(), Comparator(rgb, w, h, target(), dev,
                                          padded=True), None)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    grid = img.comps[mask.bit_length() - 1]
    blocks, orig, real = proc.padded_masking_inputs(
        *proc.masking_inputs(jpg, img, mask), grid)
    mode, aux = proc.masking_aux(img, mask, grid)
    return mode, blocks, orig, aux, real


def padded_greedy(dev, records):
    """B, B' and B'' on the bucket grid against the exact grid at the same
    state (the bucket state's real rows): CSR after real_index bit for
    bit, the padded rows without candidates, no NaN on a real row; the
    kernel's ms on each grid (added to its JSON record as bucket_ms and
    exact_grid_ms)."""
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.search import zeroing
    limit = np.float32(target())
    for path, mask in ((ROUTE[0][0], 7), (ROUTE[1][0], 1),
                       (ROUTE[1][0], 6)):
        mode, blocks, orig, aux, real = _bucket_state(path, mask, dev)
        real_t = torch.as_tensor(real, device=dev)
        aux_r = tuple(a[real_t] for a in aux)
        padded = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask,
                                             dev, mode=mode, real_index=real)
        exact = zeroing.compute_zeroing_csr(blocks[real], orig[real], limit,
                                            aux_r, mask, dev, mode=mode)
        same = all(np.array_equal(a, b) for a, b in zip(padded, exact))
        finite = bool(np.isfinite(padded[2]).all())
        args_p, perm, _inv, _l = zeroing.loop_inputs(blocks, orig, limit,
                                                     aux, mask, dev, mode)
        args_e = zeroing.loop_inputs(blocks[real], orig[real], limit, aux_r,
                                     mask, dev, mode)[0]
        pad_rows = np.setdiff1d(np.arange(len(blocks)), real)
        lane_of = np.argsort(perm)
        nrem_pad = int(args_p[2][torch.as_tensor(lane_of[pad_rows],
                                                 device=dev)].abs().sum()) \
            if len(pad_rows) else 0
        _k_idx, k_err = zl.zeroing_loop(*args_p, mode=mode)
        real_lanes = torch.as_tensor(lane_of[real], device=dev)
        nan_real = bool(torch.isnan(k_err[:, real_lanes]).any())
        ms_p = time_cuda(lambda: zl.zeroing_loop(*args_p, mode=mode), 3)
        ms_e = time_cuda(lambda: zl.zeroing_loop(*args_e, mode=mode), 3)
        name = zl.ENTRY[mode]
        log("padded greedy %s (%s, mode %s): bucket grid %d rows (%d real) "
            "%.3f ms, exact grid %.3f ms (median of 3); CSR after "
            "real_index equal to the exact grid's bit for bit: %s (%d "
            "candidates, finite %s); padded rows' candidates %d; NaN on a "
            "real row: %s"
            % (name, path, mode, len(blocks), len(real), ms_p, ms_e, same,
               len(padded[1]), finite, nrem_pad, nan_real))
        if not same or not finite or nrem_pad or nan_real:
            raise RuntimeError("%s on the bucket grid differs" % name)
        for rec in records:
            if rec["name"] == name:
                rec.update(bucket_ms=ms_p, exact_grid_ms=ms_e,
                           bucket_rows=len(blocks), real_rows=len(real))


def padded_encodes(dev, outputs):
    """The five golden rows of phase_e2e with the padded geometry forced
    on: bytes within 2% of golden, distance at or below the target, every
    greedy kernel and compare of the 4:4:4 and 4:2:0 paths launched. Then
    both mosaics in turns with the padding on and off (medians of 2 each,
    with phase_e2e's own run): the walls behind config.CUDA_AUTO["pad"].
    Returns {path: bytes} of the padded encodes."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.search.processor import ProcessStats
    _reset_launches()
    out_pad, walls = {}, {p: {"on": [], "off": []} for p, _g in ROUTE}
    first = {}
    for path, golden in E2E:
        stats = ProcessStats()
        with _pad_env("1"):
            out, wall = _serial_encode(path, dev, stats)
        out_pad[path] = out
        if path in walls:
            walls[path]["on"].append((wall, stats.timings))
        log("padded encode %s: %.2f s, %d bytes (golden %d, %+.2f%%; "
            "exact geometry %d), distance %.4f"
            % (path, wall, len(out), golden,
               100.0 * (len(out) - golden) / golden, len(outputs[path]),
               stats.final_distance))
        _check_golden(path, out, golden)
        if stats.search_error is not None or not (
                stats.final_distance <= target()):
            raise RuntimeError("%s padded: distance %s, error %s"
                               % (path, stats.final_distance,
                                  stats.search_error))
    launches = _launch_counts()
    launches.pop(kc.ENTRY)
    log("padded encodes' launches: %s"
        % ", ".join("%s %d" % kv for kv in launches.items()))
    if min(launches.values()) == 0:
        raise RuntimeError("a kernel was not launched on the padded "
                           "encodes: %s" % launches)
    for value in ("0", "1", "0"):
        for path, _g in ROUTE:
            stats = ProcessStats()
            with _pad_env(value):
                out, wall = _serial_encode(path, dev, stats)
            key = "on" if value == "1" else "off"
            walls[path][key].append((wall, stats.timings))
            want = first.setdefault((value, path), out_pad[path]
                                    if value == "1" else out)
            if out != want:
                raise RuntimeError("%s: pad %s gives other bytes on a "
                                   "second run" % (path, value))
            log("padded paired %s, pad %s: %.2f s, %d bytes (the default "
                "path's %d)" % (path, value, wall, len(out),
                                len(outputs[path])))
    for path, _g in ROUTE:
        for key in ("off", "on"):
            rs = walls[path][key]
            log("padded paired %s, pad %s: walls %s s, median %.3f s; "
                "select_quant_matrix median %.3f s, back_end median %.3f s"
                % (path, key, ", ".join("%.3f" % w for w, _t in rs),
                   float(np.median([w for w, _t in rs])),
                   float(np.median([t.get("select_quant_matrix", 0)
                                    for _w, t in rs])),
                   float(np.median([t.get("back_end", 0) for _w, t in rs]))))
    return out_pad


def padded_corpus(dev, known):
    """The lockstep corpus driver with the padding on (the CompareBatcher)
    and off, in turns, medians of 2, on three corpora: the 17 images of
    buckets 128x96 and 160x128 as 4:2:0 JPEGs under the card's auto
    route and as PNGs with GUETZLI_TPU_SPARSE=0 (small images that share
    buckets, the batcher's traffic), and CORPUS under the auto route
    (images of different sizes, one per bucket and kind). The padded
    corpus's bytes must equal each image's serial padded encode (`known`:
    those phase_e2e's rows already gave under the auto route), and its
    first run must launch each greedy kernel and compare of its passes
    once for the whole corpus."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.parallel.lockstep import encode_corpus_lockstep
    names = BUCKET_128x96 + BUCKET_160x128
    corpora = [
        ("-420.jpg x%d" % len(names),
         ["tests/corpus/%s-420.jpg" % n for n in names], {}),
        (".png x%d" % len(names),
         ["tests/corpus/%s.png" % n for n in names],
         {"GUETZLI_TPU_SPARSE": "0"}),
        ("mixed x%d" % len(CORPUS), [p for p, _g in CORPUS], {})]
    for label, paths, env in corpora:
        items = [(p, (REPO / p).read_bytes()) for p in paths]
        modes = set()
        for p in paths:
            modes.update(("420y", "420c") if "-420" in p else ("444",))
        want = {e[m]: int(m in modes) for m in MODES
                for e in (ka.ENTRY, zl.ENTRY)}
        want[kc.ENTRY] = 0
        serial, serial_walls = {}, []
        with _env(dict(env, GUETZLI_TPU_PAD="1")):
            for p in paths:
                if not env and p in known:
                    serial[p] = known[p]
                    continue
                serial[p], wall = _serial_encode(p, dev)
                serial_walls.append(wall)
        runs = {"1": [], "0": []}
        for value in ("1", "0", "0", "1"):
            walls, counters = {}, {}
            _reset_launches()
            with _env(dict(env, GUETZLI_TPU_PAD=value)):
                torch.cuda.synchronize()
                t0 = time.time()
                res = encode_corpus_lockstep(
                    items, quality=QUALITY, threads=CORPUS_THREADS,
                    phase_walls=walls, device=dev, counters=counters)
                torch.cuda.synchronize()
                wall = time.time() - t0
            launches = _launch_counts()
            runs[value].append(wall)
            log("padded corpus %s, pad %s: %.2f s (phase walls %s); "
                "compares %d, through the batcher %d in %d stacked "
                "compares (%.2f rows each); launches %s"
                % (label, value, wall,
                   ", ".join("%s %.2f s" % kv for kv in sorted(walls.items())),
                   counters.get("compares", 0), counters.get("batched", 0),
                   counters.get("flushes", 0),
                   counters.get("batched", 0) / max(1, counters.get(
                       "flushes", 0)),
                   ", ".join("%s %d" % kv for kv in launches.items())))
            if value == "1":
                bad = [p for p, d in res if d != serial[p]]
                if bad:
                    raise RuntimeError("padded corpus bytes differ from the "
                                       "serial padded encodes: %s" % bad)
                if len(runs["1"]) == 1 and launches != want:
                    raise RuntimeError(
                        "the padded corpus %s must launch each greedy "
                        "kernel and compare of its passes once: %s, want %s"
                        % (label, launches, want))
        on, off = float(np.median(runs["1"])), float(np.median(runs["0"]))
        log("padded corpus %s: pad on median %.3f s, off median %.3f s "
            "(on/off %.3f); serial padded encodes sum %.2f s (%d encoded "
            "here); corpus bytes equal the serial padded bytes: True"
            % (label, on, off, on / off, sum(serial_walls),
               len(serial_walls)))


def phase_padded(dev, outputs, records):
    """The padded bucket geometry and the CompareBatcher."""
    padded_single(dev)
    padded_stacked(dev)
    padded_greedy(dev, records)
    padded_corpus(dev, padded_encodes(dev, outputs))


def _mesh_sigmas():
    """(sigma, border ratio) of every blur of the compare (consts.py)."""
    from guetzli_tpu_torch import consts
    return ([(consts.OPSIN_SIGMA, 0.0)]
            + [(s, 0.0) for s in consts.EDGE_DETECTOR_SIGMAS]
            + [(consts.EDGE_LF_SIGMA, 0.0)]
            + [(s, 0.0) for s in consts.MASK_SIGMAS]
            + [(consts.DIFFMAP_SIGMA, consts.DIFFMAP_BORDER_RATIO)])


def _mesh_blur(group):
    """parallel/halo.sharded_blur of a seeded MESH_PLANE over the ranks
    against ops/blur.blur of the whole plane, every sigma: {sigma: (max
    abs difference, ms of the sharded blur)}."""
    from guetzli_tpu_torch.ops.blur import blur
    from guetzli_tpu_torch.parallel.halo import sharded_blur
    from guetzli_tpu_torch.parallel.mesh import RowBands
    rng = np.random.RandomState(MESH_SEED)
    plane = torch.as_tensor(rng.rand(*MESH_PLANE).astype(np.float32) * 255,
                            device=group.device)
    px = RowBands(MESH_PLANE[0], group).pixels()
    out = {}
    for sigma, ratio in _mesh_sigmas():
        got = sharded_blur(plane[px.lo:px.hi], sigma, ratio, px)
        torch.cuda.synchronize()
        group.barrier()
        t0 = time.time()
        sharded_blur(plane[px.lo:px.hi], sigma, ratio, px)
        torch.cuda.synchronize()
        ms = 1e3 * (time.time() - t0)
        full = group.all_gather_rows(got, px.counts())
        diff = float((full - blur(plane, sigma, ratio)).abs().max())
        out[repr(sigma)] = (diff, ms)
    return out


def _mesh_encode(group, path, out_dir):
    """One rank's q95 encode of `path` (a PNG, or a JPEG searched from its
    coefficients) over the group's mesh, the launch counts set to 0 just
    before it and read just after."""
    from guetzli_tpu_torch.api import is_jpeg
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_jpeg_bytes,
                                                    process_rgb)
    data = (REPO / path).read_bytes()
    if is_jpeg(data):
        def encode():
            return process_jpeg_bytes(params, data, stats, group.device,
                                      group)
    else:
        rgb, w, h = read_png(data)

        def encode():
            return process_rgb(params, rgb, w, h, stats, group.device,
                               group)
    params = Params()
    params.butteraugli_target = target()
    stats = ProcessStats()
    ctas = []
    undo = _count_ctas(ctas)
    _reset_launches()
    torch.cuda.synchronize()
    group.barrier()
    t0 = time.time()
    try:
        out = encode()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        undo()
    launches = _launch_counts()
    if group.rank == 0:
        (out_dir / (pathlib.Path(path).name + ".jpg")).write_bytes(out)
    return {"wall": wall, "bytes": len(out),
            "distance": stats.final_distance,
            "compares": stats.counters.get("iters", 0),
            "launches": {k: v for k, v in launches.items() if v},
            "ctas": [(n, c) for n, c, _ev in ctas]}


def _step_inputs(dev):
    """The search step's operands (parallel/corpus.step_inputs) of
    STEP_IMAGE and its left-right mirror."""
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.parallel import corpus
    rgb, _w, _h = read_png((REPO / STEP_IMAGE).read_bytes())
    return corpus.step_inputs([rgb, np.ascontiguousarray(rgb[:, ::-1])],
                              dev)


def _mesh_step(group, batch, args, out_dir):
    """The sharded search step at (batch, world / batch) on STEP_IMAGE's
    batch, twice (cold, then warm): its walls, kernel C's launches and
    lanes of the warm step (the counts set to 0 just before it and read
    just after), its outputs saved to out_dir."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.parallel import corpus
    mesh = corpus.make_mesh(group, batch)
    h, w = args[2].shape[-2:]
    step = corpus.make_search_step(mesh, -(-w // 8), -(-h // 8), w, h)
    lanes, real = [], kc.tile_compare

    def spy(cand, *a):
        lanes.append(cand.shape[0])
        return real(cand, *a)
    walls = []
    kc.tile_compare = spy
    try:
        for _ in range(2):
            del lanes[:]
            _reset_launches()
            torch.cuda.synchronize()
            group.barrier()
            t0 = time.time()
            out = step(*args, np.float32(1.0))
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    finally:
        kc.tile_compare = real
    torch.save([o.cpu() for o in out], out_dir / (
        "step_w%d_b%d_rank%d.pt" % (group.world, batch, group.rank)))
    return {"walls": walls, "launches": kc.launches, "lanes": lanes,
            "place": [mesh.b, mesh.t]}


def _mesh_job(group, jobs, out_dir):
    """One rank of the mesh phase (run by cli.run_ranks): each job is
    ("blur",), ("encode", path), ("step", batch) or ("dryrun",); the
    rank's results go to out_dir/rank<r>.json."""
    from guetzli_tpu_torch.parallel import corpus
    out_dir = pathlib.Path(out_dir)
    res = {"rank": group.rank, "mode": group.mode}
    args = None
    for job in jobs:
        if job[0] == "blur":
            res["blur"] = _mesh_blur(group)
        elif job[0] == "step":
            if args is None:
                t0 = time.time()
                args = _step_inputs(group.device)
                res["step_inputs_s"] = time.time() - t0
            res["step%d" % job[1]] = _mesh_step(group, job[1], args, out_dir)
        elif job[0] == "dryrun":
            t0 = time.time()
            res["dryrun"] = corpus.dryrun_multichip(group)
            res["dryrun"]["wall"] = time.time() - t0
        else:
            res[job[1]] = _mesh_encode(group, job[1], out_dir)
    (out_dir / ("rank%d.json" % group.rank)).write_text(json.dumps(res))
    return 0


def _run_mesh(n, jobs, out_dir):
    """cli.run_ranks of _mesh_job over n ranks on the card: every rank's
    results, in rank order."""
    from guetzli_tpu_torch import cli
    if cli.run_ranks(n, _mesh_job, jobs, str(out_dir),
                     timeout=MESH_TIMEOUT) != 0:
        raise RuntimeError("the mesh phase's %d-rank run failed" % n)
    return [json.loads((out_dir / ("rank%d.json" % r)).read_text())
            for r in range(n)]


def _band_ctas(path, world):
    """{greedy entry: [CTAs of each rank]} of a mesh encode of `path` over
    `world` ranks: one CTA per block of the band's rows of the pass's grid
    (8x8 blocks for B and B', 16x16 macroblocks for B'')."""
    from guetzli_tpu_torch.api import _peek_geometry
    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    w, h = _peek_geometry((REPO / path).read_bytes())
    passes = ((("444", 8),) if path.endswith(".png")
              else (("420y", 8), ("420c", 16)))
    return {zl.ENTRY[m]: [b.span(d).n * -(-w // d)
                          for b in _bands(h, world)] for m, d in passes}


def _bands(h, world):
    """parallel/mesh.RowBands of every rank of `world` over h rows."""
    from guetzli_tpu_torch.parallel.mesh import RowBands

    class _Shape:
        def __init__(self, r):
            self.world, self.rank = world, r
    return [RowBands(h, _Shape(r)) for r in range(world)]


def _check_mesh_encode(path, ranks, root, outputs, walls, golden):
    """Golden band, distance at or below target, whether the bytes equal
    one rank's, each greedy kernel launched once per rank over its band's
    blocks; logged with the walls against the serial encode's."""
    out = (root / (pathlib.Path(path).name + ".jpg")).read_bytes()
    recs = [r[path] for r in ranks]
    want = _band_ctas(path, len(ranks))
    got = {e: [[c for n, c in rc["ctas"] if n == e] for rc in recs]
           for e in want}
    log("mesh (b): %s q%d over %d ranks: %d bytes (golden %d, %+.2f%%; "
        "one rank %d, equal: %s), distance %.4f; walls %s s against %.2f s "
        "serial; greedy launches per rank, CTAs %s (band blocks %s); "
        "launches %s"
        % (path, QUALITY, len(ranks), len(out), golden,
           100.0 * (len(out) - golden) / golden, len(outputs[path]),
           out == outputs[path], recs[0]["distance"],
           " / ".join("%.2f" % rc["wall"] for rc in recs), walls[path], got,
           want, [rc["launches"] for rc in recs]))
    _check_golden(path, out, golden)
    if recs[0]["distance"] > target():
        raise RuntimeError("%s: distance %.6f above target"
                           % (path, recs[0]["distance"]))
    if got != {e: [[c] for c in cs] for e, cs in want.items()}:
        raise RuntimeError("%s: each greedy kernel must launch once per "
                           "rank over its band's blocks" % path)


def _check_steps(root, world, ranks):
    """The search step of each layout of STEP_LAYOUTS on every rank
    against the one-rank step: the scores' and errors' largest relative
    differences, whether the new coefficients are equal, kernel C's
    launches and lanes per rank (3 per block of the band of each of the
    rank's images), the walls."""
    base = torch.load(root / "step_w1_b1_rank0.pt")
    nimg = base[0].shape[0]
    h, w = _step_inputs_shape()
    for batch in STEP_LAYOUTS:
        tile = world // batch
        bands = _bands(h, tile)
        for r in ranks:
            rec = r["step%d" % batch]
            got = torch.load(root / ("step_w%d_b%d_rank%d.pt"
                                     % (world, batch, r["rank"])))
            rel = [float(((g - b).abs() / b.abs().clamp(min=1e-30)).max())
                   for g, b in ((got[0], base[0]), (got[2], base[2]))]
            same = torch.equal(got[1], base[1])
            bt, tt = rec["place"]
            lanes = [3 * bands[tt].blocks().n * -(-w // 8)
                     * len(range(bt, nimg, batch))]
            log("mesh (d): search step at (batch %d, tile %d), rank %d at "
                "%s: scores %s, max rel. difference from one rank: scores "
                "%.3g, errors %.3g; new coefficients equal: %s; C launches "
                "%d, lanes %s (want %s); walls %s s (cold, warm)"
                % (batch, tile, r["rank"], rec["place"],
                   ["%.6f" % v for v in got[0].tolist()], rel[0], rel[1],
                   same, rec["launches"], rec["lanes"], lanes,
                   ["%.3f" % v for v in rec["walls"]]))
            if rec["launches"] != 1 or rec["lanes"] != lanes:
                raise RuntimeError("the search step must launch C once per "
                                   "rank over its lanes")
            for g, b in ((got[0], base[0]), (got[2], base[2])):
                if not bool(((g - b).abs() <= STEP_RTOL
                             + STEP_RTOL * b.abs()).all()):
                    raise RuntimeError("the search step at (%d, %d) is off "
                                       "the one-rank step" % (batch, tile))


def _step_inputs_shape():
    """(h, w) of STEP_IMAGE."""
    from guetzli_tpu_torch.api import _peek_geometry
    w, h = _peek_geometry((REPO / STEP_IMAGE).read_bytes())
    return h, w


def phase_mesh(dev, outputs, walls):
    """One image over several ranks, and the sharded corpus search step
    (guetzli_tpu_torch/parallel/): (a) a one-rank NCCL group:
    corpus_cli --distributed over CORPUS, the mesh path at one rank on
    photo_mosaic1 and photo_mosaic1-420, each with the serial bytes, and
    the search step; (b) two ranks sharing the card through gloo: the
    sharded blur of every sigma against the single-rank blur, then q95
    encodes of MESH_ENCODES (golden band, distance at or below target;
    whether the bytes equal one rank's; each greedy kernel (B, or B' and
    B'') once per rank over its band's blocks; the wall against the
    serial encode's); (c) --checkcuda with two ranks (its blur(sharded)
    line); (d) the search step at (batch, tile) = (2, 1) and (1, 2)
    against the one-rank step, kernel C once per rank per step, and
    dryrun_multichip over the two ranks."""
    tmp = tempfile.TemporaryDirectory()
    root = pathlib.Path(tmp.name)
    # (a) One rank: corpus_cli --distributed in its own process.
    cdir = root / "corpus"
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "guetzli_tpu_torch.corpus_cli",
         "--distributed", "--coordinator", "file://%s" % (root / "store"),
         "--num-hosts", "1", "--host-index", "0", "--threads",
         str(CORPUS_THREADS), "--quality", str(QUALITY), "--out", str(cdir)]
        + [str(REPO / p) for p, _g in CORPUS],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    log("mesh (a): corpus_cli --distributed, 1 rank: rc %d, %.2f s; %s; %s"
        % (r.returncode, time.time() - t0, r.stdout.strip(),
           " ".join(ln for ln in r.stderr.splitlines()
                    if ln.startswith("parallel:"))))
    if r.returncode != 0 or "transport nccl" not in r.stderr:
        raise RuntimeError("corpus_cli --distributed (1 rank, NCCL) failed:"
                           "\n%s" % r.stderr[-3000:])
    for path, _g in CORPUS:
        got = (cdir / (pathlib.Path(path).stem + ".jpg")).read_bytes()
        if got != outputs[path]:
            raise RuntimeError("%s: corpus_cli --distributed gives other "
                               "bytes than the serial encode" % path)
    one_paths = MESH_ENCODES[1:3]
    one = _run_mesh(1, [("encode", p) for p in one_paths] + [("step", 1)],
                    root)[0]
    for path in one_paths:
        rec = one[path]
        same = (root / (pathlib.Path(path).name + ".jpg")).read_bytes() \
            == outputs[path]
        log("mesh (a): %s over a one-rank %s group: %.2f s (serial %.2f s), "
            "%d bytes, the serial bytes: %s; launches %s; greedy CTAs %s"
            % (path, one["mode"], rec["wall"], walls[path], rec["bytes"],
               same, rec["launches"], rec["ctas"]))
        if one["mode"] != "nccl" or not same:
            raise RuntimeError("the one-rank mesh encode must run on NCCL "
                               "and give the serial bytes")
    rec = one["step1"]
    log("mesh (a): search step on %s and its mirror over a one-rank group: "
        "inputs %.2f s; C launches %d, lanes %s; walls %s s (cold, warm)"
        % (STEP_IMAGE, one["step_inputs_s"], rec["launches"], rec["lanes"],
           ["%.3f" % v for v in rec["walls"]]))
    if rec["launches"] != 1:
        raise RuntimeError("the one-rank search step must launch C once")
    # (b) Two ranks sharing the card.
    ranks = _run_mesh(2, [("blur",)] + [("encode", p) for p in MESH_ENCODES]
                      + [("step", b) for b in STEP_LAYOUTS] + [("dryrun",)],
                      root)
    log("mesh (b): 2 ranks, transport %s" % ranks[0]["mode"])
    for sigma, (diff, ms) in ranks[0]["blur"].items():
        log("  sharded_blur sigma %s on %dx%d: max abs difference %.3g from "
            "the single-rank blur; %s ms"
            % (sigma, MESH_PLANE[1], MESH_PLANE[0], diff,
               " / ".join("%.2f" % r["blur"][sigma][1] for r in ranks)))
        if not diff <= 1e-3:
            raise RuntimeError("sharded_blur sigma %s: %g" % (sigma, diff))
    golden = dict(E2E)
    for path in MESH_ENCODES:
        _check_mesh_encode(path, ranks, root, outputs, walls, golden[path])
    # (c) --checkcuda with two ranks.
    out_path = root / "check.jpg"
    r = subprocess.run(
        [sys.executable, "-m", "guetzli_tpu_torch", "--mesh", "2",
         "--checkcuda", str(REPO / MESH_ENCODES[0]), str(out_path)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    counts = {m.group(1): int(m.group(2))
              for m in _REPORT.finditer(r.stderr)}
    line = [ln for ln in r.stderr.splitlines() if "blur(sharded)" in ln]
    log("mesh (c): --checkcuda --mesh 2 %s: rc %d; %s"
        % (MESH_ENCODES[0], r.returncode, line))
    if (r.returncode != 0 or counts.get("blur(sharded)") != 0
            or counts.get("tile_compare(cuda)") != 0):
        raise RuntimeError("--checkcuda --mesh 2 failed:\n%s"
                           % r.stderr[-3000:])
    _check_golden(MESH_ENCODES[0], out_path.read_bytes(), golden[
        MESH_ENCODES[0]])
    # (d) The search step over two ranks, and the dry run.
    _check_steps(root, 2, ranks)
    for r in ranks:
        log("mesh (d): dryrun_multichip, rank %d: %s" % (r["rank"],
                                                        r["dryrun"]))
    tmp.cleanup()


def phase_memory():
    """The memory envelope of bees96x64 on the card (memory_envelope, a
    fresh process), against the CLI's guard at the default limit."""
    from guetzli_tpu_torch import cli
    r = subprocess.run(
        [sys.executable, "-m", "guetzli_tpu_torch.memory_envelope",
         str(REPO / E2E[0][0])], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    if r.returncode != 0:
        raise RuntimeError("memory_envelope failed:\n%s" % r.stderr[-3000:])
    row = json.loads(r.stdout.strip().splitlines()[-1])["rows"][0]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli._check_memory(row["pixels"], cli.K_DEFAULT_MEMLIMIT_MB)
    log("memory_envelope %s: peak RSS %.1f MB (%.1f MB before the encode), "
        "device peak %.1f MB; the CLI's guard at %d MB: %s"
        % (E2E[0][0], row["rss_peak_mb"], row["rss_before_mb"],
           row["device_peak_mb"], cli.K_DEFAULT_MEMLIMIT_MB,
           "warns" if err.getvalue() else "silent"))
    if bool(err.getvalue()) != (row["rss_peak_mb"]
                                >= cli.K_DEFAULT_MEMLIMIT_MB):
        raise RuntimeError("the CLI's guard disagrees with the measured "
                           "peak RSS of %s" % E2E[0][0])


def knob_compare(mode, state, dev):
    """The EXACT_LUT variant of the mode's compare (A, A', A'') on the
    first greedy step's lanes against its plain version under the knob,
    bit for bit; its time beside the closed form's. Returns its record."""
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    ct, lanes, _r = first_step(mode, state, dev)
    n = ct.shape[-1]
    got = ka.tile_compare_lanes(ct, *lanes, mode=mode, exact_lut=True)
    want = tl.COMPARE[mode](ct, *lanes, exact_lut=True)
    closed = ka.tile_compare_lanes(ct, *lanes, mode=mode, exact_lut=False)
    torch.cuda.synchronize()
    name = ka.ENTRY[mode] + EXACT
    max_abs = float((got - want).abs().max())
    moved = int((got != closed).sum())
    log("%s vs plain (EXACT_LUT) on %d lanes: bit-equal %s, max abs %.3g; "
        "differs from the closed form on %d lanes"
        % (name, n, bool(torch.equal(got, want)), max_abs, moved))
    if not torch.equal(got, want):
        raise RuntimeError("%s is not bit-equal to its plain version" % name)
    ms = time_cuda(lambda: ka.tile_compare_lanes(ct, *lanes, mode=mode,
                                                 exact_lut=True), 10)
    closed_ms = time_cuda(lambda: ka.tile_compare_lanes(
        ct, *lanes, mode=mode, exact_lut=False), 10)
    plain_ms = time_cuda(lambda: tl.COMPARE[mode](ct, *lanes,
                                                  exact_lut=True), 3)
    b_ms, by = bound_ms(mode, n, n * compare_bytes(mode))
    log("%s: %.4f ms (median of 10) against the closed form's %.4f ms; "
        "plain %.3f ms; bound %.4f ms (%s)"
        % (name, ms, closed_ms, plain_ms, b_ms, by))
    replaces = ("guetzli_tpu/kernels/tile_compare_lanes.py:119"
                if mode == "444" else
                "guetzli_tpu/ops/tiles_lanes.py:%d (XLA, no pallas_call)"
                % (331 if mode == "420y" else 380))
    return {"name": name, "route": "cuda",
            "source": "guetzli_tpu_torch/csrc/tile_compare_lanes.cu",
            "replaces": replaces + ", GUETZLI_TPU_EXACT_LUT=1",
            "max_abs_err": max_abs, "ms": ms, "closed_form_ms": closed_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


def knob_greedy(mode, state, dev):
    """The EXACT_LUT variant of the mode's greedy kernel (B, B', B'') on
    the whole pass against the plain loop under the knob, both rails bit
    for bit; its time beside the closed form's. Returns its record."""
    from functools import partial

    from guetzli_tpu_torch.kernels import zeroing_loop as zl
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    args, _perm, _inv, _lim = zeroing.loop_inputs(
        blocks, orig, np.float32(target()), aux, mask, dev, mode)
    k_idx, k_err = zl.zeroing_loop(*args, mode=mode, exact_lut=True)
    torch.cuda.synchronize()
    t0 = time.time()
    p_idx, p_err = zl.zeroing_loop_plain(
        *args, mode=mode, evaluate=partial(tl.COMPARE[mode], exact_lut=True))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    name = zl.ENTRY[mode] + EXACT
    same = torch.equal(k_idx, p_idx) and torch.equal(k_err, p_err)
    fin = torch.isfinite(k_err) & (k_idx == p_idx)
    max_abs = float((k_err[fin] - p_err[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    c_idx, c_err = zl.zeroing_loop(*args, mode=mode, exact_lut=False)
    moved = int(((c_idx != k_idx) | (c_err != k_err)).any(0).sum())
    log("%s vs plain loop (EXACT_LUT): both rails bit-equal %s on %d "
        "blocks; %d blocks' rails differ from the closed form's"
        % (name, same, k_idx.shape[1], moved))
    if not same:
        raise RuntimeError("%s differs from its plain version" % name)
    ms = time_cuda(lambda: zl.zeroing_loop(*args, mode=mode,
                                           exact_lut=True), 3)
    closed_ms = time_cuda(lambda: zl.zeroing_loop(*args, mode=mode,
                                                  exact_lut=False), 3)
    nrem = args[2].long()
    evals = int(torch.where(nrem >= 2, 3 * nrem - 3, nrem).sum())
    n = nrem.numel()
    b_ms, by = bound_ms(mode, evals, n * greedy_bytes(mode))
    log("%s: %.3f ms (median of 3) against the closed form's %.3f ms; "
        "plain %.1f ms (one run); bound %.4f ms (%s)"
        % (name, ms, closed_ms, plain_ms, b_ms, by))
    return {"name": name, "route": "cuda",
            "source": "guetzli_tpu_torch/csrc/zeroing_loop.cu",
            "replaces": "guetzli_tpu/kernels/zeroing_loop.py:301 (mode %s), "
            "GUETZLI_TPU_EXACT_LUT=1" % mode, "max_abs_err": max_abs,
            "ms": ms, "closed_form_ms": closed_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def knob_tile_compare(state, dev):
    """Kernel C on A's lanes with GUETZLI_TPU_EXACT_LUT=1 and unset: the
    same errors (C keeps its closed forms, as the JAX kernel)."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    blocks, _orig, aux, _mask = state
    x0, sc, ysel, xsel = aux
    sy, sx = kc.selection_matrices(ysel, xsel)
    cand = torch.as_tensor(blocks, device=dev)
    x0, sc = x0.contiguous(), sc.contiguous()
    outs = []
    for value in (None, "1"):
        with _env({"GUETZLI_TPU_EXACT_LUT": value}):
            outs.append(kc.tile_compare(cand, x0, sc, sy, sx))
    same = torch.equal(outs[0], outs[1])
    log("tile_compare with GUETZLI_TPU_EXACT_LUT=1 and unset on %d blocks: "
        "equal %s" % (len(blocks), same))
    if not same:
        raise RuntimeError("kernel C depends on GUETZLI_TPU_EXACT_LUT")


def knob_encodes(dev, outputs):
    """KNOB_ENCODES under each KNOB_SETTINGS entry (the other knob
    variables unset), the launch counts set to 0 before and read after
    each: golden band and distance at or below target for all; the
    default bytes for the route and opt-out settings. The PNG is decoded
    before the variables are set (under NO_NATIVE the PNG reader
    raises). Returns the EXACT_LUT variants' launches in the EXACT_LUT=1
    encodes."""
    from guetzli_tpu_torch import api
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search.processor import ProcessStats
    clear = dict.fromkeys(("GUETZLI_TPU_" + k for k in KNOB_VARS))
    inputs = {}
    for path, _g in KNOB_ENCODES:
        data = (REPO / path).read_bytes()
        inputs[path] = (data, None if api.is_jpeg(data) else read_png(data))
    exact = {}
    for label, env, same_bytes in KNOB_SETTINGS:
        _reset_launches()
        for path, golden in KNOB_ENCODES:
            stats = ProcessStats()
            with _env(dict(clear, **{"GUETZLI_TPU_" + k: v
                                     for k, v in env.items()})):
                torch.cuda.synchronize()
                t0 = time.time()
                out = api._encode(*inputs[path], QUALITY, None, stats, dev)
                torch.cuda.synchronize()
                wall = time.time() - t0
            equal = out == outputs[path]
            log("knob %s, %s: %.2f s, %d bytes, default bytes %s, distance "
                "%.4f, backend_serialize %.3f s, zeroing_loop %.3f s"
                % (label, path, wall, len(out), equal,
                   stats.final_distance or -1,
                   stats.timings.get("backend_serialize", 0.0),
                   stats.timings.get("zeroing_loop", 0.0)))
            if stats.search_error is not None:
                raise RuntimeError("search failed: %s" % stats.search_error)
            _check_golden(path, out, golden)
            if not stats.final_distance <= target():
                raise RuntimeError("%s under %s: distance %.4f above target"
                                   % (path, label, stats.final_distance))
            if same_bytes and not equal:
                raise RuntimeError("%s under %s: %d bytes, not the default "
                                   "%d" % (path, label, len(out),
                                           len(outputs[path])))
        counts = dict(_launch_counts(), **_launch_counts(exact=True))
        log("knob %s launches: %s" % (label, ", ".join(
            "%s %d" % kv for kv in counts.items() if kv[1])))
        if label == "EXACT_LUT=1":
            exact = _launch_counts(exact=True)
            if min(exact.values()) == 0 or max(_launch_counts().values()):
                raise RuntimeError("EXACT_LUT=1 encodes launched %s" % counts)
    return exact


def knob_routes(state, dev):
    """photo_mosaic1's 4:4:4 pass through the staged route
    (ZEROING_FUSED=0: A per step) and the full-batch route
    (STAGED_ZEROING=0: the host CSR) against the fused kernel B: the CSR
    arrays equal, the zeroing walls side by side."""
    from guetzli_tpu_torch.search import zeroing
    blocks, orig, aux, mask = state
    limit = np.float32(target())
    csrs, walls = {}, {}
    for label, env in (("fused", {}), ("staged", {"ZEROING_FUSED": "0"}),
                       ("full-batch", {"STAGED_ZEROING": "0"})):
        with _env({"GUETZLI_TPU_" + k: env.get(k)
                   for k in ("ZEROING_FUSED", "STAGED_ZEROING")}):
            torch.cuda.synchronize()
            t0 = time.time()
            if label == "full-batch":
                csr = zeroing.csr_from_zeroing(*zeroing.compute_zeroing_order(
                    blocks, orig, limit, aux, mask, dev), limit)
            else:
                csr = zeroing.compute_zeroing_csr(blocks, orig, limit, aux,
                                                  mask, dev)
            torch.cuda.synchronize()
            walls[label] = time.time() - t0
        csrs[label] = csr
    for label in ("staged", "full-batch"):
        same = all(np.array_equal(a, b)
                   for a, b in zip(csrs["fused"], csrs[label]))
        log("knob routes photo_mosaic1 %s: zeroing %.3f s against the "
            "fused kernel's %.3f s; CSR (%d candidates) equal %s"
            % (label, walls[label], walls["fused"], len(csrs[label][1]),
               same))
        if not same:
            raise RuntimeError("the %s zeroing route's CSR differs" % label)


def knob_compares(dev):
    """One padded compare of photo_mosaic1 (the _dyn chain, where
    SEL_MATMUL and LANE_SAFE's block diff act) by default, with the
    one-hot selections and with the lane-safe forms: ms each; SEL_MATMUL
    bit for bit the default, LANE_SAFE within 1e-4 relative on the
    diffmap (another rounding of the block diff)."""
    comp, img, _ds, _q = _quant_start(ROUTE[0][0], dev, padded=True)
    maps, mss = {}, {}
    for label, env in (("default", {}), ("SEL_MATMUL=1",
                                          {"SEL_MATMUL": "1"}),
                       ("LANE_SAFE=1", {"LANE_SAFE": "1"})):
        with _env({"GUETZLI_TPU_" + k: env.get(k)
                   for k in ("SEL_MATMUL", "LANE_SAFE")}):
            mss[label] = time_cuda(lambda: comp.compare_img(img), 3)
            maps[label] = comp.distmap.clone()
    ref = maps["default"]
    for label in ("SEL_MATMUL=1", "LANE_SAFE=1"):
        diff = (maps[label] - ref).abs()
        rel = float((diff / ref.abs().clamp_min(1e-3)).max())
        log("knob compare %s (padded photo_mosaic1): %.3f ms against the "
            "default's %.3f ms (median of 3); diffmap max relative "
            "difference %.3g, equal %s" % (label, mss[label],
                                           mss["default"], rel,
                                           bool(torch.equal(maps[label],
                                                            ref))))
        if label == "SEL_MATMUL=1" and not torch.equal(maps[label], ref):
            raise RuntimeError("SEL_MATMUL=1 moved the padded diffmap")
        if label == "LANE_SAFE=1" and not rel <= 1e-4:
            raise RuntimeError("LANE_SAFE=1 diffmap off by %.3g" % rel)


def phase_knobs(dev, states, outputs):
    """The JAX package's remaining knobs on the card: the EXACT_LUT
    variants of A, A', A'', B, B', B'' against their plain versions (C
    unmoved), the encodes under each knob, the staged and full-batch
    zeroing routes on photo_mosaic1, the one-hot and lane-safe compares.
    Returns the variants' records."""
    t0 = time.time()
    records = []
    for mode in MODES:
        records.append(knob_compare(mode, states[mode], dev))
        records.append(knob_greedy(mode, states[mode], dev))
    knob_tile_compare(states["444"], dev)
    exact = knob_encodes(dev, outputs)
    for rec in records:
        rec["launches"] = exact[rec["name"]]
    knob_routes(states["444"], dev)
    knob_compares(dev)
    log("knobs phase: %.1f s" % (time.time() - t0))
    return records


def main(argv=()):
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.kernels import build
    dev = resolve("cuda")
    phase_device(build)
    if list(argv) == ["padded"]:
        # The padded phase alone, against default-path encodes of E2E.
        phase_padded(dev, {p: _serial_encode(p, dev)[0] for p, _g in E2E},
                     [])
        return 0
    if list(argv) == ["kernels"]:
        # The kernel phases alone (no 444p pass, one run of each plain
        # loop): the seven kernels against their plain versions, timed.
        for mode, state in dict(mosaic444(dev), **mosaic420(dev)).items():
            phase_compare(mode, state, dev)
            phase_greedy(mode, state, dev, 1)
            if mode == "444":
                phase_tile_compare(state, dev)
        return 0
    if list(argv) == ["knobs"]:
        # The knobs phase alone, against default-path encodes of its
        # images; exits nonzero if it fails.
        states = dict(mosaic444(dev), **mosaic420(dev))
        phase_knobs(dev, states, {p: _serial_encode(p, dev)[0]
                                  for p, _g in KNOB_ENCODES})
        return 0
    if list(argv) == ["mesh"]:
        # The mesh phase alone, against serial encodes of its images.
        serial = {p: _serial_encode(p, dev)
                  for p in dict.fromkeys([p for p, _g in CORPUS]
                                         + list(MESH_ENCODES))}
        phase_mesh(dev, {p: o for p, (o, _w) in serial.items()},
                   {p: w for p, (_o, w) in serial.items()})
        phase_memory()
        return 0
    records = []
    states = dict(mosaic444(dev), **mosaic420(dev))
    for mode, state in states.items():
        records.append(phase_compare(mode, state, dev))
        records.append(phase_greedy(mode, state, dev,
                                    1 if mode == "420c" else 3))
        if mode == "444":
            records.append(phase_tile_compare(state, dev))
            phase_greedy_444p(state, dev)
    launches, outputs, walls = phase_e2e(dev)
    # Kernel C's paths: --checkcuda and the opt-in 444p search.
    launches["tile_compare"] = (phase_checkcuda(dev)
                                + phase_444p_e2e(dev, outputs))
    phase_butteraugli(dev)
    phase_route(dev, outputs)
    # The corpus phase runs the default route (config.auto("pad") is the
    # serial encodes' geometry too); the padded corpus is phase_padded's.
    with _route_env({"TREE_QUANT": "1"}):
        corpus_launches = phase_corpus(dev, outputs, walls)
    phase_padded(dev, outputs, records)
    phase_mesh(dev, outputs, walls)
    phase_memory()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["corpus_launches"] = corpus_launches.get(rec["name"], 0)
    records += phase_knobs(dev, states, outputs)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
