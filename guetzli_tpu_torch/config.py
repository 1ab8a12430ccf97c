"""The knobs of guetzli_tpu/config.py that the port reads.

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

The route knobs are tri-state: None (unset) is "auto", which the
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
