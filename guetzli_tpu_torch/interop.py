"""Carry a comparator's frozen state across from numpy arrays.

For this encoder the "weights" are the comparator's frozen state: the
original image's opsin planes ``xyb0``, the whole-image mask, the
per-block state ``(xyb0_tiles, scales, ysel, xsel)`` of
``Comparator.block_state``, and for the 4:2:0 zeroing passes the frozen
chroma bytes, Y bytes, chroma neighborhoods and macroblock children. Any
implementation that produces them (the JAX package's Comparator, for
one) can hand them over as numpy arrays, so that both implementations
evaluate against the same state.
"""

import numpy as np
import torch

from guetzli_tpu_torch.comparator import Comparator


def comparator_state_from_numpy(rgb, width, height, target_distance,
                                xyb0, mask_xyz=None, block_state=None,
                                frozen_420=None, device="cpu"):
    """A Comparator on `device` whose state comes from numpy arrays.

    rgb: uint8 [h, w, 3]; xyb0: float32 [3, h, w]; mask_xyz: float32
    [3, h, w] (the whole-image mask of start_block_comparisons) or None;
    block_state: (xyb0_tiles [NB, 3, 64] f32, scales [NB, 3] f32,
    ysel [NB, 8] int, xsel [NB, 8] int) or None; frozen_420: a dict with
    any of "chroma_bytes" ([NBy, 2, 8, 8], Comparator.frozen_chroma_blocks),
    "y16" ([NBc, 16, 16], frozen_y_16x16), "neighborhoods" (a pair of
    [NBc, 10, 10], frozen_neighborhoods) and "children" (the five arrays
    of children_state), or None."""
    dev = torch.device(device)

    def up(a, dtype=None):   # a copy: JAX hands out read-only arrays
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)

    comp = Comparator(rgb, width, height, target_distance, dev,
                      xyb0=up(xyb0, np.float32), mesh=False)
    if mask_xyz is not None:
        comp._mask_xyz = up(mask_xyz, np.float32)
    if block_state is not None:
        tiles, scales, ysel, xsel = block_state
        comp._block_state[(1, 1)] = (up(tiles, np.float32),
                                     up(scales, np.float32),
                                     up(ysel, np.int32), up(xsel, np.int32))
    for key, value in (frozen_420 or {}).items():
        comp.frozen_state[key] = (tuple(up(a) for a in value)
                                  if isinstance(value, (tuple, list))
                                  else up(value))
    return comp
