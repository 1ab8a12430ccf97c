"""The knobs of guetzli_tpu/config.py, all of which the port reads but
the four Pallas sizes (below).

Each reads its GUETZLI_TPU_* variable at call time, as the JAX package's
``config.current()`` does, so a change of the environment (or a
monkeypatched test) takes effect at the next encode. The parsing is the
JAX package's: a flag is on for any value but "0", an int is int(value).

Knob (env var)           | Unset ("auto")         | Forced
-------------------------|------------------------|---------------------
pallas (PALLAS)          | fused greedy kernel B  | 1: mode "444p", the
                         |                        | staged loop with C
pipeline_lag (PIPELINE)  | see auto() below       | N: back-end lag N
speculate (SPECULATE)    | see auto() below       | quant speculation
tree_quant (TREE_QUANT)  | see auto() below       | quant-tree waves
sparse (SPARSE)          | see auto() below       | resident back-end
                         |                        | state, sparse deltas
pad (PAD)                | see auto() below       | padded bucket
                         |                        | geometry; a corpus
                         |                        | stacks compares
mesh (MESH)              | 0: one device          | N: one image over
                         |                        | N ranks (--mesh N)
exact_lut (EXACT_LUT)    | closed forms           | =1: the reference's
                         |                        | tables (sRGB, colour
                         |                        | diff, masking) in the
                         |                        | torch chain and in
                         |                        | A, A', A'', B, B', B''
                         |                        | (never in C)
lane_safe (LANE_SAFE)    | off on CPU and card    | 1: one-hot upsample
                         |                        | columns; the padded
                         |                        | block diff lane-major
sel_matmul (SEL_MATMUL)  | gather                 | =1: the padded chain's
                         |                        | selections as one-hot
                         |                        | matmuls (exact)
zeroing_fused            | fused B, B', B''       | 0: the staged loop,
  (ZEROING_FUSED)        | (PALLAS=0: 4:4:4       | A, A', A'' per step
                         | staged)                |
staged_zeroing           | sorted, device CSR     | 0: full-batch loop,
  (STAGED_ZEROING)       |                        | no count sort, host
                         |                        | CSR
lanes (LANES)            | lane-major evaluation  | 0: the staged and
                         |                        | full-batch loops
                         |                        | evaluate blocks-leading
                         |                        | (ops/tiles.py); fused:
                         |                        | no change
native (NO_NATIVE)       | C++ host library       | any value: the Python
                         |                        | codec, histograms and
                         |                        | flip loop (the PNG
                         |                        | reader raises)
incr_save (NO_INCR_SAVE) | incremental jpeg_data  | =1: whole save per
                         |                        | flip iteration
histo_reuse              | DC histograms reused   | =1: rebuilt per flip
  (NO_HISTO_REUSE)       |                        | iteration
zeroing_debug            | silent                 | =1: stage walls on
  (ZEROING_DEBUG)        |                        | stderr

The ten knobs from exact_lut down act alike on the CPU and on the card
(where a CUDA kernel runs on the card, its plain version runs on the
CPU). LANE_SAFE's auto is on for a TPU in the JAX package: its T(8,128)
tiled layout pads a narrow minor dimension up to 128 lanes, and the
lane-safe forms keep every plane-scale tensor wide. A GPU has no such
layout, so auto is off on the card as on the CPU, and =1 forces the
JAX package's accelerator formulation. The zeroing routes and the
opt-outs give the default's CSR arrays and bytes, but LANES=0: its
blocks-leading compare is another rounding of the block error, as in
JAX; EXACT_LUT and (on the padded geometry) LANE_SAFE change the
rounding too, as they do in JAX.

Four fields of the JAX package's config size a TPU grid step:
PALLAS_TILE, PALLAS_TILE_N, PALLAS_VMEM_MB and ZEROING_TILE_N (a Pallas
tile of blocks and its VMEM budget). The team kernels run one CTA per
block or macroblock and have no such tile, so the port reads none of
them.

The search route knobs (PIPELINE, SPECULATE, TREE_QUANT, SPARSE, PAD)
are tri-state: None (unset) is "auto", which the
call site decides per device through ``auto``, as the JAX package decides
per backend (search/processor.py). On the CPU auto is off for all of them,
as in JAX for the first three (JAX keeps sparse and the padded geometry
on there; padding may move the diffmap's last bits, 3.45e-7 relative on
the card, so the CPU keeps the exact geometry every earlier byte and
tolerance was pinned at). On the card auto is ``CUDA_AUTO``, set from paired
runs of each knob on alone against all off on an NVIDIA H100
(chip_smoke.py's route phase; PERF.md): a knob whose forced-on median
was slower than all-off on both mosaics, on the wall of the phase it
changes, in most runs stays off (speculation, the pipeline); the tree
and sparse deltas are on.

The padded geometry (``pad``) is one knob for every entry point: the
encoders of one image (api.encode_bytes, the CLI, api.encode_corpus) and
the lockstep corpus driver, where padding is what lets the
CompareBatcher stack the compares of different images of one bucket, so
both corpus entries give the same bytes. --checkcuda always runs at
exact geometry (the JAX package's padded run_checkcl is a recorded fault,
ROADMAP.md section 3). Its card value follows the same rule, from
chip_smoke.py's padded phase on an NVIDIA H100 (PERF.md): one image's
encode wall with the padding was slower than without it on each mosaic
in most of six calls (medians of 2), so "pad" is off. 17 small images
of two buckets ran 1.43-1.86x faster with it in every call, but that
gain is the traffic's: the corpus of six images of different sizes ran
1.05-1.125x slower with it (every stack one row, more pixels), so a
corpus stays at exact geometry too unless GUETZLI_TPU_PAD=1 asks.
"""

import os

_PREFIX = "GUETZLI_TPU_"

# Each route knob's auto value on a CUDA device.
CUDA_AUTO = {"pipeline_lag": 0, "speculate": False, "tree_quant": True,
             "sparse": True, "pad": False}


def _opt_int(name):
    v = os.environ.get(_PREFIX + name)
    return None if v in (None, "") else int(v)


def _flag(name, default):
    v = os.environ.get(_PREFIX + name)
    return default if v is None else v != "0"


def _opt_flag(name):
    v = os.environ.get(_PREFIX + name)
    return None if v is None else v != "0"


def pallas():
    """GUETZLI_TPU_PALLAS as an int, None when unset or empty. Only the
    value 1 changes behaviour: 4:4:4 zeroing passes run in mode "444p",
    the staged greedy loop with kernel C per step. Any other value, or
    none, keeps the default, the fused greedy kernel B (the counterpart
    of the JAX package's accelerator default)."""
    return _opt_int("PALLAS")


def pipeline_lag():
    """GUETZLI_TPU_PIPELINE: the back end's pipeline lag (0: serial)."""
    return _opt_int("PIPELINE")


def speculate():
    """GUETZLI_TPU_SPECULATE: one-deep quant-trial speculation."""
    return _opt_flag("SPECULATE")


def tree_quant():
    """GUETZLI_TPU_TREE_QUANT: the quant search in subtree waves."""
    return _opt_flag("TREE_QUANT")


def sparse():
    """GUETZLI_TPU_SPARSE: device-resident back-end coefficients updated
    by sparse deltas."""
    return _opt_flag("SPARSE")


def pad():
    """GUETZLI_TPU_PAD: padded bucket geometry (ops/padgeom.py)."""
    return _opt_flag("PAD")


def exact_lut():
    """GUETZLI_TPU_EXACT_LUT=1: the reference's tables in place of the
    closed forms (ops/blockdiff.py, ops/image.py, the kernels' table
    buffer)."""
    return os.environ.get(_PREFIX + "EXACT_LUT") == "1"


def lane_safe():
    """GUETZLI_TPU_LANE_SAFE as a flag, None when unset (ops/layout.py
    decides)."""
    return _opt_flag("LANE_SAFE")


def sel_matmul():
    """GUETZLI_TPU_SEL_MATMUL=1: one-hot matmul selections
    (ops/diffmap._select_yx)."""
    return os.environ.get(_PREFIX + "SEL_MATMUL") == "1"


def zeroing_fused():
    """GUETZLI_TPU_ZEROING_FUSED as a flag, None when unset
    (search/zeroing.route decides)."""
    return _opt_flag("ZEROING_FUSED")


def staged_zeroing():
    """GUETZLI_TPU_STAGED_ZEROING: False only for "0" (the full-batch loop
    and the host CSR)."""
    return _flag("STAGED_ZEROING", True)


def lanes():
    """GUETZLI_TPU_LANES: False only for "0" (blocks-leading evaluation in
    the staged and full-batch loops)."""
    return _flag("LANES", True)


def native():
    """False when GUETZLI_TPU_NO_NATIVE holds any non-empty value."""
    return not os.environ.get(_PREFIX + "NO_NATIVE")


def incr_save():
    """False under GUETZLI_TPU_NO_INCR_SAVE=1."""
    return os.environ.get(_PREFIX + "NO_INCR_SAVE") != "1"


def histo_reuse():
    """False under GUETZLI_TPU_NO_HISTO_REUSE=1."""
    return os.environ.get(_PREFIX + "NO_HISTO_REUSE") != "1"


def zeroing_debug():
    """GUETZLI_TPU_ZEROING_DEBUG=1: stage walls on stderr."""
    return os.environ.get(_PREFIX + "ZEROING_DEBUG") == "1"


def mesh():
    """GUETZLI_TPU_MESH: the number of ranks one image is encoded over
    (parallel/mesh.py; the CLI's --mesh N). 0 when unset."""
    return _opt_int("MESH") or 0


def auto(knob, device):
    """The value of route knob `knob` ("pipeline_lag", "speculate",
    "tree_quant", "sparse" or "pad") for an encode on
    `device`: the variable's value when set, else off on the CPU and
    CUDA_AUTO[knob] on a CUDA device."""
    value = globals()[knob]()
    if value is not None:
        return max(0, value) if knob == "pipeline_lag" else value
    if getattr(device, "type", device) == "cuda":
        return CUDA_AUTO[knob]
    return 0 if knob == "pipeline_lag" else False
