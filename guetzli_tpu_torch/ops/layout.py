"""The lane-safe formulation switch (JAX guetzli_tpu/ops/layout.py).

The JAX package turns the lane-safe forms on for a TPU, whose T(8,128)
tiled layout pads a tensor's narrow minor dimension to 128 lanes: the
one-hot column pass of the blurs' nearest upsample (ops/blur.py) and
the lane-major whole-image block diff of the padded chain
(ops/diffmap.block_diff_map_dyn). A GPU has no tiled layout, so the
port's auto is off on the card as on the CPU; GUETZLI_TPU_LANE_SAFE=1
forces the accelerator formulation, =0 keeps the default.
"""

from guetzli_tpu_torch import config


def lane_safe():
    """True when GUETZLI_TPU_LANE_SAFE is set to anything but "0"."""
    return bool(config.lane_safe())
