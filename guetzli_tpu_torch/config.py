"""The knobs of guetzli_tpu/config.py that the port reads: eleven
GUETZLI_TPU_* variables, none with a per-device default.

Each reads its GUETZLI_TPU_* variable at call time, as the JAX package's
``config.current()`` does, so a change of the environment (or a
monkeypatched test) takes effect at the next encode. The parsing is the
JAX package's: a flag is on for any value but "0", an int is int(value).

Knob (env var)           | Unset                  | Forced
-------------------------|------------------------|---------------------
pallas (PALLAS)          | fused greedy kernel B  | 1: mode "444p", the
                         |                        | staged loop with C
pad (PAD)                | exact geometry         | 1: padded bucket
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
lane_safe (LANE_SAFE)    | off                    | 1: one-hot upsample
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
zeroing_debug            | silent                 | =1: stage walls on
  (ZEROING_DEBUG)        |                        | stderr

Every knob acts alike on the CPU and on the card (where a CUDA kernel
runs on the card, its plain version runs on the CPU). LANE_SAFE is on
for a TPU in the JAX package: its T(8,128) tiled layout pads a narrow
minor dimension up to 128 lanes, and the lane-safe forms keep every
plane-scale tensor wide. A GPU has no such layout, so it is off unless
=1 forces the JAX package's accelerator formulation. The zeroing routes
and NO_NATIVE give the default's CSR arrays and bytes, but LANES=0: its
blocks-leading compare is another rounding of the block error, as in
JAX; EXACT_LUT and (on the padded geometry) LANE_SAFE change the
rounding too, as they do in JAX.

Four fields of the JAX package's config size a TPU grid step:
PALLAS_TILE, PALLAS_TILE_N, PALLAS_VMEM_MB and ZEROING_TILE_N (a Pallas
tile of blocks and its VMEM budget). The team kernels run one CTA per
block or macroblock and have no such tile, so the port reads none of
them.

The search's route is no knob: it follows what the comparator can take
(search/processor.py). The quant search runs in waves and the 4:4:4
back end on device-resident coefficients wherever the comparator
supports them, which is everywhere but under a mesh.

The padded geometry (``pad``) is one knob for every entry point: the
encoders of one image (api.encode_bytes, the CLI, api.encode_corpus) and
the lockstep corpus driver, where padding is what lets the
CompareBatcher stack the compares of different images of one bucket, so
both corpus entries give the same bytes. --checkcuda always runs at
exact geometry (the JAX package's padded run_checkcl is a recorded fault,
ROADMAP.md section 3). It is off unless GUETZLI_TPU_PAD=1 asks, on the
CPU and on the card alike. Padding may move the diffmap's last bits
(3.45e-7 relative on the card), so the CPU keeps the exact geometry
every earlier byte and tolerance was pinned at. On an NVIDIA H100
(chip_smoke.py's padded phase, PERF.md) one image's encode wall with
the padding was slower than without it on each mosaic in most of six
calls (medians of 2). 17 small images of two buckets ran 1.43-1.86x
faster with it in every call, but that gain is the traffic's: the
corpus of six images of different sizes ran 1.05-1.125x slower with it
(every stack one row, more pixels), so a corpus stays at exact geometry
too unless GUETZLI_TPU_PAD=1 asks.
"""

import os

_PREFIX = "GUETZLI_TPU_"


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


def pad():
    """GUETZLI_TPU_PAD: padded bucket geometry (ops/padgeom.py); None
    when unset. The call sites take it only when True."""
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


def zeroing_debug():
    """GUETZLI_TPU_ZEROING_DEBUG=1: stage walls on stderr."""
    return os.environ.get(_PREFIX + "ZEROING_DEBUG") == "1"


def mesh():
    """GUETZLI_TPU_MESH: the number of ranks one image is encoded over
    (parallel/mesh.py; the CLI's --mesh N). 0 when unset."""
    return _opt_int("MESH") or 0
