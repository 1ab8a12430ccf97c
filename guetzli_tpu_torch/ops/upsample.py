"""Fancy (libjpeg 3x3 triangle) chroma upsampling for YUV420.

Port of guetzli_tpu/ops/upsample.py, integer and bit-exact, at exact
geometry and on padded buckets (fancy_upsample_dyn). Reference semantics:
OutputImageComponent::UpdatePixelsForBlock (output_image.cc:147-204)
keeps a full-resolution x16 pixel cache for factor-2 components by
upsampling a 10x10 subsampled neighborhood around each changed block. Here the cache is rebuilt from the whole subsampled
plane at once.
"""

import numpy as np
import torch

from guetzli_tpu_torch.ops import devconst

_X16 = np.arange(16)
_CX16 = (_X16 >> 1) + 1
_CX16_2 = (_X16 >> 1) + 1 + (_X16 & 1) * 2 - 1


def fancy_upsample(sub, w, h, y0=0, hs=None, s0=0):
    """x16 subsampled plane [..., hs, ws] int32 -> full-res x16 pixels
    [..., h, w].

    out[y,x] = (9*s[cy,cx] + 3*s[cy2,cx] + 3*s[cy,cx2] + s[cy2,cx2]) >> 4
    with (cx, cy) = (x>>1, y>>1) and cx2/cy2 the parity-directed neighbor,
    clamped at the plane's border (the kSubsampledEdgeSize edge fill).

    On a band of rows (parallel/banded.py): the output's rows [y0, y0 +
    h) of an image whose subsampled plane has `hs` rows, `sub` holding
    the plane's rows from s0 on (every row those output rows read)."""
    ws = sub.shape[-1]
    if hs is None:
        hs = sub.shape[-2]
    dev = sub.device
    x = torch.arange(w, device=dev)
    y = torch.arange(y0, y0 + h, device=dev)
    cx = x >> 1
    cy = y >> 1
    cx2 = (cx + (x & 1) * 2 - 1).clamp(0, ws - 1)
    cy2 = (cy + (y & 1) * 2 - 1).clamp(0, hs - 1)
    r1 = sub[..., cy - s0, :]
    r2 = sub[..., cy2 - s0, :]
    return (9 * r1[..., cx] + 3 * r1[..., cx2] + 3 * r2[..., cx]
            + r2[..., cx2]) >> 4


def fancy_upsample_dyn(sub, ws, hs):
    """fancy_upsample of B padded subsampled planes [B, hsp, wsp] with
    true subsampled extents ws, hs (int tensors [B]) -> [B, 2*hsp, 2*wsp]
    x16 pixels, garbage outside each valid region (JAX
    fancy_upsample_dyn): the border clamps are per image."""
    nb, hsp, wsp = sub.shape
    dev = sub.device
    x = torch.arange(2 * wsp, device=dev)
    y = torch.arange(2 * hsp, device=dev)
    cx = x >> 1
    cy = y >> 1
    cx2 = torch.minimum((cx + (x & 1) * 2 - 1).clamp(min=0)[None],
                        ws[:, None] - 1)                    # [B, 2wsp]
    cy2 = torch.minimum((cy + (y & 1) * 2 - 1).clamp(min=0)[None],
                        hs[:, None] - 1)                    # [B, 2hsp]
    r1 = sub[:, cy, :]
    r2 = torch.gather(sub, 1, cy2[:, :, None].expand(nb, 2 * hsp, wsp))
    ix2 = cx2[:, None, :].expand(nb, 2 * hsp, 2 * wsp)
    return (9 * r1[..., cx] + 3 * torch.gather(r1, 2, ix2)
            + 3 * r2[..., cx] + torch.gather(r2, 2, ix2)) >> 4


def neighborhoods_10x10(sub, bw, bh, by0=0, hs=None, s0=0):
    """Per-block 10x10 subsampled neighborhoods [..., NB, 10, 10] of a
    plane [..., hs, ws] (clamped):
    rows/cols -1..8 of each 8x8 block of the plane, border entries clamped
    to the plane (clguetzli.cl:3440-3639).

    On a band of rows: the blocks of block rows [by0, by0 + bh) of a
    plane of `hs` rows, `sub` holding its rows from s0 on."""
    ws = sub.shape[-1]
    if hs is None:
        hs = sub.shape[-2]

    def make():
        bx = np.tile(np.arange(bw), bh)
        by = np.repeat(np.arange(by0, by0 + bh), bw)
        ix = np.arange(-1, 9)
        gx = np.clip(bx[:, None] * 8 + ix[None, :], 0, ws - 1)  # [NB, 10]
        gy = np.clip(by[:, None] * 8 + ix[None, :], 0, hs - 1) - s0
        return gx, gy
    gx, gy = devconst.get(("neighborhoods_10x10", bw, bh, by0, ws, hs, s0),
                          sub.device, make)
    return sub[..., gy[:, :, None], gx[:, None, :]]


def upsample_16x16_from_neighborhood(neigh):
    """[..., 10, 10] x16 subsampled neighborhoods -> [..., 16, 16] x16
    full-res pixels of the block's own 16x16 area."""
    cx = devconst.array(_CX16, neigh.device)
    cx2 = devconst.array(_CX16_2, neigh.device)
    r1 = neigh[..., cx, :]
    r2 = neigh[..., cx2, :]
    return (9 * r1[..., cx] + 3 * r1[..., cx2] + 3 * r2[..., cx]
            + r2[..., cx2]) >> 4
