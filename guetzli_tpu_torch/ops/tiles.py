"""Per-8x8-tile state and the blocks-leading CompareBlock.

Frozen per-block state (SwitchBlock, butteraugli_comparator.cc:85-111):
each 8x8 pixel block of the original image gets its own opsin tile
(pixels sampled with coordinates clamped to the image, then an
8x8-confined opsin transform), and the right/bottom image-edge
replication of ToPixels (output_image.cc:86-97) is encoded per block as
clamped index vectors.

The blocks-leading compare (port of guetzli_tpu/ops/tiles.py,
tiles_to_linear_rgb and compare_blocks): candidate coefficients ->
integer IDCT -> edge replication -> YCbCr->RGB bytes -> linear RGB ->
8x8 opsin -> MaskHighIntensityChange confined to the tile -> block diff
-> masked error, batched over a leading block axis, and its two 4:2:0
twins (compare_blocks_420y, compare_blocks_420c). It is the whole-tensor
form (matmul contractions, tensor means); the per-lane fixed-order form
that the CUDA kernels equal is ops/tiles_lanes.py. --checkcuda holds
kernels C and A against this one; the zeroing loops evaluate with it
under GUETZLI_TPU_LANES=0 (search/zeroing.py).
"""

import numpy as np
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import fp
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops.diffmap import _mhic_mix
from guetzli_tpu_torch.ops.opsin import opsin_dynamics_blocks
from guetzli_tpu_torch.ops.tiles_lanes import BLOCK_EDGE_W, ONE_MINUS_EDGE_W


def original_opsin_tiles(rgb, w, h, bw, bh, device):
    """rgb uint8 [h, w, 3] (numpy) -> [bh*bw, 3, 64] float32 opsin tiles
    on `device`. The sRGB->linear step is the exact 256-entry table, as
    the JAX package uses for the original image."""
    lut = torch.as_tensor(consts.SRGB_TO_LINEAR.astype(np.float32),
                          device=device)
    xs = torch.as_tensor(np.minimum(np.arange(bw * 8), w - 1),
                         device=device)
    ys = torch.as_tensor(np.minimum(np.arange(bh * 8), h - 1),
                         device=device)
    img = torch.as_tensor(np.ascontiguousarray(rgb, dtype=np.uint8),
                          device=device)
    lin = lut[img[ys][:, xs].long()]                    # [8bh, 8bw, 3]
    tiles = (lin.reshape(bh, 8, bw, 8, 3).permute(0, 2, 4, 1, 3)
             .reshape(bh * bw, 3, 8, 8))
    return opsin_dynamics_blocks(tiles).reshape(bh * bw, 3, 64)


def edge_gather_indices(bw, bh, w, h):
    """Per-block (ysel, xsel) int32 numpy arrays [bh*bw, 8]: the clamped
    pixel index min(i, max) of the edge replication."""
    bx = np.tile(np.arange(bw, dtype=np.int32), bh)
    by = np.repeat(np.arange(bh, dtype=np.int32), bw)
    ix = np.arange(8, dtype=np.int32)
    xmax = np.minimum(7, (w - 1) - 8 * bx)
    ymax = np.minimum(7, (h - 1) - 8 * by)
    xsel = np.minimum(ix[None, :], xmax[:, None])
    ysel = np.minimum(ix[None, :], ymax[:, None])
    return ysel, xsel


def _tile_border_masks():
    """Validity masks [8, 8] of the four 1-pixel shifts inside a tile:
    neighbour at x-1, x+1, y-1, y+1."""
    ones = np.ones((8, 8), dtype=bool)
    left = ones.copy()
    left[:, 0] = False
    right = ones.copy()
    right[:, -1] = False
    up = ones.copy()
    up[0, :] = False
    down = ones.copy()
    down[-1, :] = False
    return left, right, up, down


_BORDER_MASKS = _tile_border_masks()


def mask_high_intensity_change_tiles(t0, t1):
    """MaskHighIntensityChange on [..., 3, 8, 8] tiles (butteraugli.cc:791
    at xsize=ysize=8, as CompareBlock calls it: neighbour visibility stops
    at the tile border)."""
    ave = (t0 + t1) * 0.5
    y = ave[..., 1, :, :]

    def sq_shift(dy, dx, valid):
        shifted = torch.roll(y, shifts=(-dy, -dx), dims=(-2, -1))
        d = shifted - y
        return torch.where(torch.as_tensor(valid, device=y.device), d * d,
                           torch.full_like(d, -1.0))

    left, right, up, down = _BORDER_MASKS
    sqr_max = torch.maximum(
        torch.maximum(sq_shift(0, -1, left), sq_shift(0, 1, right)),
        torch.maximum(sq_shift(-1, 0, up), sq_shift(1, 0, down)))
    mix = _mhic_mix(y, sqr_max).movedim(0, -3)
    return mix * t0 + (1.0 - mix) * ave, mix * t1 + (1.0 - mix) * ave


def edge_replicate(v, ysel, xsel):
    """Right/bottom image-edge byte replication of ToPixels
    (output_image.cc:86-97) on integer tiles v [..., 8, 8]: rows past the
    tile's ymax copy row ymax, then columns past xmax copy column xmax.
    ysel, xsel: [...sel, 8] clamped index vectors min(i, max); their
    leading dims are v's minus any channel-like axes between them and the
    trailing [8, 8] (broadcast over those)."""
    extra = v.dim() - ysel.dim() - 1
    iy = torch.arange(8, dtype=torch.int32, device=v.device)
    ymax = ysel[..., 7:8]
    xmax = xsel[..., 7:8]
    oh_y = (iy == ymax).to(v.dtype)                      # [...sel, 8]
    oh_x = (iy == xmax).to(v.dtype)
    my = iy <= ymax
    mx = iy <= xmax
    for _ in range(extra):
        oh_y, oh_x = oh_y.unsqueeze(-2), oh_x.unsqueeze(-2)
        my, mx = my.unsqueeze(-2), mx.unsqueeze(-2)
    row = (oh_y[..., :, None] * v).sum(-2)               # [..., 8] over x
    v = torch.where(my[..., :, None], v, row[..., None, :])
    col = (oh_x[..., None, :] * v).sum(-1)               # [..., 8] over y
    return torch.where(mx[..., None, :], v, col[..., None])


def tiles_to_linear_rgb(coeff_tiles, xsel, ysel):
    """Dequantized coefficient tiles [..., 3, 64] int32 (YCbCr) -> linear
    RGB tiles [..., 3, 8, 8] float32. xsel, ysel: [..., 8] int32 clamped
    pixel indices of the edge replication. For factor-1 components the
    x16 pixel cache and its parity dither round-trip to the IDCT bytes, so
    the bytes are the IDCT values."""
    v = img_ops.idct_blocks(coeff_tiles)
    v = edge_replicate(v.reshape(v.shape[:-1] + (8, 8)), ysel, xsel)
    rgb = img_ops.ycbcr_to_rgb(v[..., 0, :, :], v[..., 1, :, :],
                               v[..., 2, :, :])           # stacks on axis 0
    return img_ops.srgb_to_linear(rgb.movedim(0, -3))


def compare_blocks(xyb0_tiles, cand_lin, scale):
    """Batched CompareBlock core (butteraugli_comparator.cc:113-163).

    xyb0_tiles: [N, 3, 64] original opsin tiles (stored flat); cand_lin:
    [N, 3, 8, 8] linear RGB of the candidates; scale: [N, 3] whole-image
    mask values at each block's top-left pixel. Returns [N] float32."""
    xyb0 = xyb0_tiles.reshape(xyb0_tiles.shape[:-1] + (8, 8))
    xyb1 = opsin_dynamics_blocks(cand_lin)
    m0, m1 = mask_high_intensity_change_tiles(xyb0, xyb1)
    dc, ac, edge = bd.block_diff(m0.reshape(m0.shape[:-2] + (64,)),
                                 m1.reshape(m1.shape[:-2] + (64,)))
    diff = ((dc + ac) * scale).sum(-1)
    diff_edge = (edge * scale).sum(-1)
    return fp.sqrt(ONE_MINUS_EDGE_W * diff + BLOCK_EDGE_W * diff_edge)


def compare_blocks_420y(cand_y, chroma_bytes, xyb0_tiles, scales, ysel,
                        xsel):
    """The 4:2:0 Y-pass CompareBlock, blocks leading (JAX
    ops/tiles.compare_blocks_420y): candidate Y coefficients [N, 64]
    int32 against the frozen, edge-replicated Cb/Cr bytes chroma_bytes
    [N, 2, 8, 8]; the rest as compare_blocks and tiles_to_linear_rgb.
    Returns [N] float32."""
    yv = img_ops.idct_blocks(cand_y).reshape(cand_y.shape[:-1] + (8, 8))
    yv = edge_replicate(yv, ysel, xsel)
    rgb = img_ops.ycbcr_to_rgb(yv, chroma_bytes[:, 0], chroma_bytes[:, 1])
    lin = img_ops.srgb_to_linear(rgb.movedim(0, -3))
    return compare_blocks(xyb0_tiles, lin, scales)


def compare_blocks_420c(cand_u, cand_v, neigh_u, neigh_v, y_bytes16,
                        xyb0_sub, scales_sub, ysel_sub, xsel_sub, valid_sub):
    """The 4:2:0 chroma-pass CompareBlock over 16x16 macroblocks, blocks
    leading (JAX ops/tiles.compare_blocks_420c; clguetzli.cl:3440-3639):
    each candidate's chroma IDCT bytes go << 4 into the interior of its
    frozen 10x10 x16 neighbourhood, which is fancy-upsampled to the
    macroblock's 16x16 area and dithered; its four 8x8 sub-blocks are
    compared against the original with the frozen Y bytes, and the
    result is the max over the valid ones (from 0).

    cand_u, cand_v: [N, 64] int32; neigh_u, neigh_v: [N, 10, 10] int32;
    y_bytes16: [N, 16, 16] int32; xyb0_sub: [N, 2, 2, 3, 64] float32;
    scales_sub: [N, 2, 2, 3]; ysel_sub, xsel_sub: [N, 2, 2, 8] int32;
    valid_sub: [N, 2, 2] bool. Returns [N] float32."""
    from guetzli_tpu_torch.ops import upsample as us

    def chroma16(cand, neigh):
        v = img_ops.idct_blocks(cand).reshape(cand.shape[:-1] + (8, 8))
        filled = neigh.clone()
        filled[..., 1:9, 1:9] = v << 4
        return us.upsample_16x16_from_neighborhood(filled)   # x16 pixels

    # ToPixels' dither: x = 16 * bx + ix, so the parity is ix's.
    dith = 8 - (torch.arange(16, device=cand_u.device) & 1)
    ub = (chroma16(cand_u, neigh_u) + dith) >> 4
    vb = (chroma16(cand_v, neigh_v) + dith) >> 4

    def split(p):                     # [N, 16, 16] -> [N, 2, 2, 8, 8]
        return p.reshape(p.shape[0], 2, 8, 2, 8).permute(0, 1, 3, 2, 4)

    def rep(p):
        return edge_replicate(split(p), ysel_sub, xsel_sub)

    rgb = img_ops.ycbcr_to_rgb(rep(y_bytes16), rep(ub), rep(vb))
    lin = img_ops.srgb_to_linear(rgb.movedim(0, -3))
    errs = compare_blocks(xyb0_sub, lin, scales_sub)       # [N, 2, 2]
    errs = torch.where(valid_sub, errs, torch.zeros_like(errs))
    return errs.amax(dim=(1, 2))
