"""One image's encode over the ranks of a group: the row bands.

Port of guetzli_tpu/parallel/mesh.py. The JAX package shards an image's
planes by rows and its per-block arrays by blocks and lets XLA GSPMD
insert the collectives. PyTorch has no GSPMD, so the port runs SPMD by
hand: every rank runs the same host search, each rank's device work
covers its own band of pixel rows and block rows, and the collectives
carry the halos (parallel/halo.py), the score's max and the per-band
results every rank's host search reads (parallel/dist.py).

Band starts fall on multiples of UNIT = 48 rows: the lcm of 8 (a
block), 16 (a 4:2:0 macroblock), the strided blurs' steps 2, 3 and 4,
and the step-3 grid of ops/diffmap._res_positions, so every grid a
stage samples is the whole image's grid cut at band edges. The image's
48-row units are dealt out in order, the same number to each rank but
the last ranks, so any empty bands come at the end (3 ranks on 64 rows
hold 48, 16 and 0). Every band but the last one with rows holds a
multiple of 48 rows, more than the widest halo (32 rows at sigma
14.26), so a stage reads rows only from its nearest neighbours that
hold rows. A rank with an empty band still takes part in every
collective.

Enable with ``--mesh N`` on the CLI or GUETZLI_TPU_MESH=N (config.mesh).
"""

import numpy as np
import torch

from guetzli_tpu_torch import config
from guetzli_tpu_torch.parallel import dist
from guetzli_tpu_torch.parallel.halo import Span

UNIT = 48


def band_ranges(height, world):
    """[(lo, hi)] pixel rows of each of `world` ranks."""
    units = -(-height // UNIT)
    per = -(-units // world)
    return [(min(height, r * per * UNIT), min(height, (r + 1) * per * UNIT))
            for r in range(world)]


class RowBands:
    """This rank's share of an image of `height` rows: its pixel rows
    [lo, hi), its block rows, and the same of every rank, on `group`
    (parallel/dist.Group)."""

    def __init__(self, height, group):
        self.height = height
        self.group = group
        self.rank = group.rank
        self.world = group.world
        self.ranges = band_ranges(height, group.world)
        self.lo, self.hi = self.ranges[self.rank]

    def span(self, div=1, shift=0, size=None):
        """The bands in another row unit: row y of the image is row
        (y - shift) / div there (8 for block rows, 3 for the res grid, a
        shift of 2 for the diffmap's inner region), on an axis of `size`
        rows (default: the image's rows in that unit)."""
        if size is None:
            size = -(-(self.height - shift) // div)

        def cut(y):
            return min(size, max(0, -(-(y - shift) // div)))
        return Span([(cut(lo), cut(hi)) for lo, hi in self.ranges],
                    self.rank, size, self.group)

    def pixels(self):
        return self.span()

    def blocks(self):
        """Rows of 8x8 blocks."""
        return self.span(8)

    def __repr__(self):
        return "RowBands(%d:%d of %d, rank %d of %d)" % (
            self.lo, self.hi, self.height, self.rank, self.world)


def mesh_from_env():
    """The group one image is encoded over (the JAX package's 1-D
    ('tile',) mesh) for GUETZLI_TPU_MESH=N: this process's group
    (parallel/dist.init), which must have N ranks; None when the
    variable is unset, 0 or 1."""
    n = config.mesh()
    if n <= 1:
        return None
    group = dist.current()
    if group is None:
        raise RuntimeError("GUETZLI_TPU_MESH=%d but this process belongs "
                           "to no group (parallel/dist.init)" % n)
    if group.world != n:
        raise RuntimeError("GUETZLI_TPU_MESH=%d but the group has %d ranks"
                           % (n, group.world))
    return group


def put_blocks(bands, a, device, axis=0, div=8):
    """This rank's block rows of a host per-block array (row-major blocks
    of `div` pixel rows on `axis`: 8, or 16 for a 4:2:0 image's chroma
    and macroblocks) on `device`: the counterpart of the JAX package's
    upload sharded over the mesh's block axis."""
    s = bands.span(div)
    bw = a.shape[axis] // s.size
    part = np.take(a, np.arange(s.lo * bw, s.hi * bw), axis=axis)
    return torch.as_tensor(np.ascontiguousarray(part), device=device)
