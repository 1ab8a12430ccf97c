"""Shape buckets: padded image geometry.

Port of guetzli_tpu/ops/padgeom.py. The JAX package rounds every image
up to a bucket (Wp, Hp) so that XLA compiles one program per bucket, not
per image size. PyTorch compiles nothing, but the bucket is what lets
compares of images of different sizes stack on one image axis
(comparator.CompareBatcher): every shape depends only on the bucket,
and the true size (w, h) of each row is a tensor from which every
position and validity mask is computed on the device.

The only size-dependent values that are not recomputed on the device
are the blur border weights (float64 host accumulation,
butteraugli.cc:76-89): each image carries them as one float32 vector
(PadGeom.scales_flat), split per blur by scale_slices.
"""

from functools import lru_cache

import numpy as np

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops.blur import blur_step, border_scales


def bucket_dim(n: int) -> int:
    """Round a dimension up to its bucket: multiples of 32 up to 512,
    of 64 up to 1024, of 128 beyond (at most 2x for tiny images,
    typically 10% or less)."""
    n = max(n, 32)
    if n <= 512:
        q = 32
    elif n <= 1024:
        q = 64
    else:
        q = 128
    return -(-n // q) * q


# (name, sigma, shrink, border_ratio): every blur of the diffmap. The
# blurred extent is (w - shrink, h - shrink): the diffmap's clustered
# blur runs on the inner (w-5, h-5) region (butteraugli.cc:1028-1037).
_SCALE_SPECS = (
    ("opsin", consts.OPSIN_SIGMA, 0, 0.0),
    ("ed0", consts.EDGE_DETECTOR_SIGMAS[0], 0, 0.0),
    ("ed1", consts.EDGE_DETECTOR_SIGMAS[1], 0, 0.0),
    ("ed2", consts.EDGE_DETECTOR_SIGMAS[2], 0, 0.0),
    ("edlf", consts.EDGE_LF_SIGMA, 0, 0.0),
    ("mask0", consts.MASK_SIGMAS[0], 0, 0.0),
    ("mask1", consts.MASK_SIGMAS[1], 0, 0.0),
    ("mask2", consts.MASK_SIGMAS[2], 0, 0.0),
    ("diffmap", consts.DIFFMAP_SIGMA, 5, consts.DIFFMAP_BORDER_RATIO),
)


@lru_cache(maxsize=64)
def _scales_np(w: int, h: int, wp: int, hp: int):
    out = {}
    for name, sigma, shrink, br in _SCALE_SPECS:
        out[name] = (border_scales(w - shrink, wp, sigma, br),
                     border_scales(h - shrink, hp, sigma, br))
    return out


@lru_cache(maxsize=None)
def scale_slices(wp: int, hp: int):
    """{name: (slice_x, slice_y)} into a bucket's flat scale vector."""
    out, pos = {}, 0
    for name, sigma, _shrink, _br in _SCALE_SPECS:
        step = blur_step(sigma)
        nx, ny = -(-wp // step), -(-hp // step)
        out[name] = (slice(pos, pos + nx), slice(pos + nx, pos + nx + ny))
        pos += nx + ny
    return out


def split_scales(flat, wp, hp):
    """Rows of flat scale vectors [B, S] -> {name: (scale_x [B, nx],
    scale_y [B, ny])}, views of `flat`."""
    return {name: (flat[:, sx], flat[:, sy])
            for name, (sx, sy) in scale_slices(wp, hp).items()}


class PadGeom:
    """One image's padded geometry: the bucket and the real block grids."""

    def __init__(self, w: int, h: int, wp: int = None, hp: int = None):
        self.w = int(w)
        self.h = int(h)
        self.wp = int(wp) if wp else bucket_dim(w)
        self.hp = int(hp) if hp else bucket_dim(h)
        assert self.wp % 16 == 0 and self.hp % 16 == 0
        assert self.wp >= w and self.hp >= h
        self.bw = -(-w // 8)          # real block grid
        self.bh = -(-h // 8)
        self.bwp = self.wp // 8       # padded block grid
        self.bhp = self.hp // 8

    def scales(self):
        """{name: (scale_x, scale_y)} float32 numpy arrays."""
        return _scales_np(self.w, self.h, self.wp, self.hp)

    def scales_flat(self):
        """Every blur's scales in one float32 vector (scale_slices)."""
        sc = self.scales()
        return np.concatenate([a for name, *_r in _SCALE_SPECS
                               for a in sc[name]])

    # -- host-side padding ----------------------------------------------

    def pad_plane(self, a, fill=0):
        """[..., h, w] -> [..., hp, wp]."""
        a = np.asarray(a)
        pads = [(0, 0)] * (a.ndim - 2) + [(0, self.hp - a.shape[-2]),
                                          (0, self.wp - a.shape[-1])]
        return np.pad(a, pads, constant_values=fill)

    def pad_blocks(self, coeffs, bw=None, bh=None, bwp=None, bhp=None):
        """Row-major block array [..., bh*bw, K] -> [..., bhp*bwp, K] with
        the real blocks in the top-left of the padded grid, zeros
        elsewhere."""
        bw = bw or self.bw
        bh = bh or self.bh
        bwp = bwp or self.bwp
        bhp = bhp or self.bhp
        c = np.asarray(coeffs)
        lead = c.shape[:-2]
        k = c.shape[-1]
        out = np.zeros(lead + (bhp * bwp, k), dtype=c.dtype)
        og = out.reshape(lead + (bhp, bwp, k))
        og[..., :bh, :bw, :] = c.reshape(lead + (bh, bw, k))
        return out

    def unpad_blocks(self, a, bw=None, bh=None, bwp=None, bhp=None):
        """Inverse of pad_blocks on the leading block axis: [bhp*bwp, ...]
        -> [bh*bw, ...]."""
        bw = bw or self.bw
        bh = bh or self.bh
        bwp = bwp or self.bwp
        bhp = bhp or self.bhp
        a = np.asarray(a)
        g = a.reshape((bhp, bwp) + a.shape[1:])
        return g[:bh, :bw].reshape((bh * bw,) + a.shape[1:])

    def unpad_grid(self, a, gbw, gbh, gbwp, gbhp):
        """[..., gbhp*gbwp] -> [..., gbh*gbw] (e.g. the [4, NB] weight
        rows of a factor grid)."""
        a = np.asarray(a)
        g = a.reshape(a.shape[:-1] + (gbhp, gbwp))
        return np.ascontiguousarray(g[..., :gbh, :gbw]).reshape(
            a.shape[:-1] + (gbh * gbw,))

    def real_index(self, gbw, gbh, gbwp):
        """Rows of a padded grid (gbwp wide) that hold the real gbh x gbw
        blocks, in row-major order: int64 [gbh*gbw]."""
        r = np.arange(gbw * gbh, dtype=np.int64)
        return (r // gbw) * gbwp + r % gbw
