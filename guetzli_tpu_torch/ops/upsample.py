"""Fancy (libjpeg 3x3 triangle) chroma upsampling for YUV420.

Port of guetzli_tpu/ops/upsample.py (exact geometry), integer and
bit-exact. Reference semantics: OutputImageComponent::UpdatePixelsForBlock
(output_image.cc:147-204) keeps a full-resolution x16 pixel cache for
factor-2 components by upsampling a 10x10 subsampled neighborhood around
each changed block. Here the cache is rebuilt from the whole subsampled
plane at once.
"""

import numpy as np
import torch


def fancy_upsample(sub, w, h):
    """x16 subsampled plane [hs, ws] int32 -> full-res x16 pixels [h, w].

    out[y,x] = (9*s[cy,cx] + 3*s[cy2,cx] + 3*s[cy,cx2] + s[cy2,cx2]) >> 4
    with (cx, cy) = (x>>1, y>>1) and cx2/cy2 the parity-directed neighbor,
    clamped at the plane's border (the kSubsampledEdgeSize edge fill)."""
    hs, ws = sub.shape
    dev = sub.device
    x = torch.arange(w, device=dev)
    y = torch.arange(h, device=dev)
    cx = x >> 1
    cy = y >> 1
    cx2 = (cx + (x & 1) * 2 - 1).clamp(0, ws - 1)
    cy2 = (cy + (y & 1) * 2 - 1).clamp(0, hs - 1)
    r1 = sub[cy]
    r2 = sub[cy2]
    return (9 * r1[:, cx] + 3 * r1[:, cx2] + 3 * r2[:, cx]
            + r2[:, cx2]) >> 4


def neighborhoods_10x10(sub, bw, bh):
    """Per-block 10x10 subsampled neighborhoods [NB, 10, 10] (clamped):
    rows/cols -1..8 of each 8x8 block of the plane, border entries clamped
    to the plane (clguetzli.cl:3440-3639)."""
    hs, ws = sub.shape
    bx = np.tile(np.arange(bw), bh)
    by = np.repeat(np.arange(bh), bw)
    ix = np.arange(-1, 9)
    gx = np.clip(bx[:, None] * 8 + ix[None, :], 0, ws - 1)   # [NB, 10]
    gy = np.clip(by[:, None] * 8 + ix[None, :], 0, hs - 1)
    gx = torch.as_tensor(gx, device=sub.device)
    gy = torch.as_tensor(gy, device=sub.device)
    return sub[gy[:, :, None], gx[:, None, :]]


def upsample_16x16_from_neighborhood(neigh):
    """[..., 10, 10] x16 subsampled neighborhoods -> [..., 16, 16] x16
    full-res pixels of the block's own 16x16 area."""
    x = np.arange(16)
    cx = torch.as_tensor((x >> 1) + 1, device=neigh.device)
    cx2 = torch.as_tensor((x >> 1) + 1 + (x & 1) * 2 - 1,
                          device=neigh.device)
    r1 = neigh[..., cx, :]
    r2 = neigh[..., cx2, :]
    return (9 * r1[..., cx] + 3 * r1[..., cx2] + 3 * r2[..., cx]
            + r2[..., cx2]) >> 4
