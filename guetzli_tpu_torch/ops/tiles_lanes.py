"""Lane-major (tiles-last) per-block compare: the plain PyTorch version of
the CUDA block compare (csrc/compare_team.cuh).

Blocks are the last axis: candidates [3, 8, 8, N], original opsin tiles
[3, 8, 8, N], scales [3, N], edge clamps [N]. The chain is CompareBlock
(butteraugli_comparator.cc:113-163): integer IDCT -> edge replication ->
fixed-point YCbCr->RGB -> sRGB->linear -> 8x8 opsin -> MaskHighIntensity-
Change against the original -> DFT block diff -> weighted error.

Every contraction and every reduction is written out in a fixed order
(``_mat_axis``, ``_sum_seq``): each product and each sum is its own
float32 operation, so each lane rounds the same at any batch size and on
any device, and the CUDA kernel (built with ``--fmad=false``) performs the
same operations in the same order.
"""

import numpy as np
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import fp
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops.blur import blur_matrix
from guetzli_tpu_torch.ops.diffmap import _mhic_mix
from guetzli_tpu_torch.ops.opsin import opsin_from_blurred

_F32 = np.float32
_IDCT = consts.IDCT_MATRIX.astype(np.int32)
_BLUR8 = blur_matrix(8, consts.OPSIN_SIGMA, 0.0)
BLOCK_EDGE_W = float(_F32(consts.BLOCK_EDGE_WEIGHT))
ONE_MINUS_EDGE_W = float(_F32(1.0) - _F32(consts.BLOCK_EDGE_WEIGHT))

_CSF64 = np.zeros(64, dtype=np.float32)
_CSF64[:37] = consts.CSF8X8.astype(np.float32)
_CSF_MASK = np.zeros(64, dtype=np.float32)
_CSF_MASK[4:37] = 1.0
# Masked CSF indexed [xfreq*8 + yfreq], matching the [xf, yf, N] DFT output.
CSF_D = (_CSF64 * _CSF_MASK).reshape(8, 8)


def _mat_axis(mat, x, axis):
    """out[.., i, ..] = sum_j mat[i][j] * x[.., j, ..] over `axis` (integer
    or float32): all 64 products at once, each rounded on its own, then
    summed over j in order, ((p0 + p1) + p2) + ..."""
    xm = x.movedim(axis, 0)                        # [8(j), ...]
    m = torch.as_tensor(np.asarray(mat), dtype=x.dtype, device=x.device)
    prod = m.view((8, 8) + (1,) * (xm.dim() - 1)) * xm.unsqueeze(0)
    acc = prod[:, 0]
    for j in range(1, 8):
        acc = acc + prod[:, j]                     # [8(i), ...]
    return acc.movedim(0, axis)


def _sum_seq(x, axis):
    """Sequential sum over a small axis: ((x0 + x1) + x2) + ..."""
    acc = x.select(axis, 0)
    for i in range(1, x.shape[axis]):
        acc = acc + x.select(axis, i)
    return acc


def idct_lanes(c):
    """Integer IDCT of [..., 8(u), 8(x), N] int32 coefficient tiles
    (ComputeBlockIDCT, idct.cc:139-161)."""
    col = _mat_axis(_IDCT, c.to(torch.int32), -3)
    col = (col + (1 << 10)) >> 11
    row = _mat_axis(_IDCT, col, -2)
    row = (row + (257 << 17)) >> 18
    return row.clamp(0, 255)


def edge_replicate_lanes(v, ymax, xmax):
    """ToPixels right/bottom edge replication (output_image.cc:86-97) on
    [..., 8, 8, N] tiles with per-tile clamp maxima [N]: rows past ymax
    copy row ymax, then columns past xmax copy column xmax."""
    rows = [v[..., i, :, :] for i in range(8)]
    edge_row = sum(rows[i] * (ymax == i) for i in range(8))
    v = torch.stack([torch.where(ymax >= i, rows[i], edge_row)
                     for i in range(8)], dim=-3)
    cols = [v[..., :, i, :] for i in range(8)]
    edge_col = sum(cols[i] * (xmax == i) for i in range(8))
    return torch.stack([torch.where(xmax >= i, cols[i], edge_col)
                        for i in range(8)], dim=-2)


def ycbcr_to_rgb_lanes(yy, cb, cr):
    """color_transform.h integer YCbCr -> RGB on [8, 8, N] byte planes ->
    [3, 8, 8, N] clamped to 0..255."""
    cb = cb - 128
    cr = cr - 128
    r = yy + ((91881 * cr + 32768) >> 16)
    b = yy + ((116130 * cb + 32768) >> 16)
    g = yy + (((-46802) * cr + (-22554) * cb + 32768) >> 16)
    return torch.stack([r, g, b]).clamp(0, 255)


def opsin_blocks_lanes(rgb):
    """Per-tile opsin of [3, 8, 8, N] linear RGB (the blur stays inside
    the tile)."""
    blurred = _mat_axis(_BLUR8, _mat_axis(_BLUR8, rgb, -3), -2)
    return opsin_from_blurred(rgb, blurred)


def mhic_lanes(t0, t1):
    """MaskHighIntensityChange confined to [3, 8, 8, N] tiles
    (butteraugli.cc:791 at xsize=ysize=8)."""
    ave = (t0 + t1) * 0.5
    y = ave[1]                                     # [8, 8, N]
    dev = y.device
    row = torch.arange(8, device=dev)[:, None, None]
    col = torch.arange(8, device=dev)[None, :, None]

    def sq_shift(dy, dx, valid):
        shifted = torch.roll(y, shifts=(-dy, -dx), dims=(0, 1))
        d = shifted - y
        return torch.where(valid, d * d, torch.full_like(d, -1.0))

    sqr_max = torch.maximum(
        torch.maximum(sq_shift(0, -1, col >= 1), sq_shift(0, 1, col <= 6)),
        torch.maximum(sq_shift(-1, 0, row >= 1), sq_shift(1, 0, row <= 6)))
    mix = _mhic_mix(y, sqr_max)
    return mix * t0 + (1.0 - mix) * ave, mix * t1 + (1.0 - mix) * ave


def _fft8_sq_lanes(x):
    """|2-D DFT|^2 of real [8(y), 8(x), N] -> [8(xf), 8(yf), N] with the
    global scale (ButteraugliFFTSquared, butteraugli.cc:574-597)."""
    a = x.transpose(0, 1)                          # [x, y, N]
    t1r = _mat_axis(bd.DFT8_RE, a, -3)
    t1i = _mat_axis(bd.DFT8_IM, a, -3)
    gr = _mat_axis(bd.DFT8_RE, t1r, -2) - _mat_axis(bd.DFT8_IM, t1i, -2)
    gi = _mat_axis(bd.DFT8_IM, t1r, -2) + _mat_axis(bd.DFT8_RE, t1i, -2)
    return (gr * gr + gi * gi) * float(_F32(consts.FFT_GLOBAL_MUL))


def _mean8_axis1(x):
    """[C, 8, M] -> [C, M] mean over the 8-axis."""
    return _sum_seq(x, 1) * 0.125


def block_diff_lanes(b0, b1, exact_lut=None):
    """ButteraugliBlockDiff (butteraugli.cc:602-684) on [3, 8, 8, N]
    pairs -> (diff_dc, diff_ac, diff_edge), each [3, N]. Its two table
    reads (LF and HF DY) follow GUETZLI_TPU_EXACT_LUT unless `exact_lut`
    says (blockdiff.color_diff_dy_hf)."""
    csf0 = float(_F32(consts.CSF8X8[0]))
    diff = b0 - b1
    avg = _mean8_axis1(_mean8_axis1(diff))         # [3, N]
    dcx, dcy, dcz = bd.xyb_diff_low_freq_squared(avg[0], avg[1], avg[2],
                                                 exact_lut)
    diff_dc = torch.stack([dcx, dcy, dcz]) * csf0

    edges = torch.stack([
        _mean8_axis1(diff[:, :, 0, :]),            # column x = 0
        _mean8_axis1(diff[:, 0, :, :]),            # row y = 0
        _mean8_axis1(diff[:, :, 7, :]),            # column x = 7
        _mean8_axis1(diff[:, 7, :, :]),            # row y = 7
    ], dim=1)                                      # [3, 4, N]
    ex, ey, ez = bd.xyb_diff_low_freq_squared(edges[0], edges[1], edges[2],
                                              exact_lut)
    diff_edge = torch.stack([_sum_seq(ex, 0), _sum_seq(ey, 0),
                             _sum_seq(ez, 0)]) * csf0

    bavg = (b0 + b1) * 0.5
    bhd = (b0 - b1) * 0.5
    d = torch.as_tensor(CSF_D, device=b0.device)[..., None]

    def wsum(x):                                   # [8, 8, N] -> [N]
        return _sum_seq(_sum_seq(d * x, 0), 0)

    ac_x = wsum(_fft8_sq_lanes(bhd[0])) * float(_F32(consts.BLOCKDIFF_AC_XMUL))
    ac_z = wsum(_fft8_sq_lanes(bhd[2])) * float(_F32(consts.BLOCKDIFF_AC_ZMUL))
    rng = float(_F32(consts.BLOCKDIFF_Y_LIMIT))
    ya = fp.sqrt(_fft8_sq_lanes(bavg[1]))
    yh = fp.sqrt(_fft8_sq_lanes(bhd[1]))
    y0 = bd.remove_range_around_zero(ya - yh, rng)
    y1 = bd.remove_range_around_zero(ya + yh, rng)
    ymul2 = float(_F32(consts.BLOCKDIFF_AC_YMUL2))
    valy = float(_F32(consts.BLOCKDIFF_AC_YMUL)) * (
        bd.color_diff_dy_hf(y0 * ymul2, exact_lut)
        - bd.color_diff_dy_hf(y1 * ymul2, exact_lut))
    ac_y = wsum(valy * valy)
    return diff_dc, torch.stack([ac_x, ac_y, ac_z]), diff_edge


def finish_lanes(rgb, xyb0_t, scales_t, exact_lut=None):
    """sRGB bytes [3, 8, 8, N] -> weighted block error [N]. The bytes are
    linearized through image.srgb_table (closed form whatever the knob
    says), as the CUDA kernel does; exact_lut as block_diff_lanes."""
    lut = img_ops.srgb_table(rgb.device)
    xyb1 = opsin_blocks_lanes(lut[rgb.long()])
    m0, m1 = mhic_lanes(xyb0_t, xyb1)
    dc, ac, edge = block_diff_lanes(m0, m1, exact_lut)
    diff = _sum_seq((dc + ac) * scales_t, 0)
    diff_edge = _sum_seq(edge * scales_t, 0)
    return fp.sqrt(ONE_MINUS_EDGE_W * diff + BLOCK_EDGE_W * diff_edge)


def compare_lanes(cand_t, xyb0_t, scales_t, ymax, xmax, exact_lut=None):
    """CompareBlock over lane-major candidates: cand_t [3, 8, 8, N] int32
    dequantized coefficients; xyb0_t [3, 8, 8, N] float32 original opsin
    tiles; scales_t [3, N] float32 whole-image mask values; ymax, xmax [N]
    int32 edge clamps. Returns [N] float32 block errors."""
    v = edge_replicate_lanes(idct_lanes(cand_t), ymax, xmax)
    return finish_lanes(ycbcr_to_rgb_lanes(v[0], v[1], v[2]), xyb0_t,
                        scales_t, exact_lut)


def compare_blocks_lanes444(cand, xyb0_t, scales_t, ymax, xmax):
    """compare_lanes with blocks-leading candidates [N, 3, 64]."""
    ct = cand.reshape(-1, 3, 8, 8).permute(1, 2, 3, 0)
    return compare_lanes(ct, xyb0_t, scales_t, ymax, xmax)


def transpose_aux_444(xyb0_tiles, scales, ysel, xsel):
    """Frozen 4:4:4 pass state -> lane-major: [N, 3, 64] opsin tiles to
    [3, 8, 8, N], [N, 3] scales to [3, N], [N, 8] clamped index vectors
    to their [N] maxima. All contiguous."""
    x0 = xyb0_tiles.reshape(-1, 3, 8, 8).permute(1, 2, 3, 0).contiguous()
    sc = scales.transpose(0, 1).contiguous()
    ymax = ysel[:, 7].to(torch.int32).contiguous()
    xmax = xsel[:, 7].to(torch.int32).contiguous()
    return x0, sc, ymax, xmax


# -- 4:2:0 Y pass ---------------------------------------------------------

def compare_lanes_420y(cand_t, chroma_t, xyb0_t, scales_t, ymax, xmax,
                       exact_lut=None):
    """The 4:2:0 Y-pass CompareBlock: only the Y plane of cand_t
    [3, 8, 8, N] goes through the IDCT and edge replication; it is
    converted with the block's frozen Cb/Cr bytes chroma_t [2, 8, 8, N]
    int32 (already edge-replicated). Returns [N] float32."""
    yv = edge_replicate_lanes(idct_lanes(cand_t[0]), ymax, xmax)
    return finish_lanes(ycbcr_to_rgb_lanes(yv, chroma_t[0], chroma_t[1]),
                        xyb0_t, scales_t, exact_lut)


def compare_blocks_lanes420y(cand_y, *aux):
    """compare_lanes_420y with blocks-leading Y candidates [N, 64] (the
    signature of guetzli_tpu/ops/tiles_lanes.compare_blocks_lanes420y)."""
    return compare_lanes_420y(cand_y.reshape(-1, 8, 8).permute(1, 2, 0)[None],
                              *aux)


def transpose_aux_420y(chroma_bytes, xyb0_tiles, scales, ysel, xsel):
    """Frozen 4:2:0 Y-pass state -> lane-major: [N, 2, 8, 8] chroma bytes
    to [2, 8, 8, N] int32, plus the 4:4:4 transposes."""
    ch = chroma_bytes.to(torch.int32).permute(1, 2, 3, 0).contiguous()
    return (ch,) + transpose_aux_444(xyb0_tiles, scales, ysel, xsel)


# -- 4:2:0 chroma pass ------------------------------------------------------

_UP_X = np.arange(16)
_UP_C1 = (_UP_X >> 1) + 1                          # into the 10-wide frame
_UP_C2 = _UP_C1 + (_UP_X & 1) * 2 - 1


def upsample_16x16_lanes(neigh):
    """[10, 10, N] x16 subsampled neighborhoods -> [16, 16, N] x16
    full-res pixels (ops/upsample.upsample_16x16_from_neighborhood,
    lane-major)."""
    c1 = torch.as_tensor(_UP_C1, device=neigh.device)
    c2 = torch.as_tensor(_UP_C2, device=neigh.device)
    r1 = neigh[c1]
    r2 = neigh[c2]
    return (9 * r1[:, c1] + 3 * r1[:, c2] + 3 * r2[:, c1]
            + r2[:, c2]) >> 4


def split16_lanes(p):
    """[16, 16, N] -> [8, 8, 4N]: the 2x2 sub-block grid folded into the
    lane axis in the order (sub_y, sub_x, n), n fastest."""
    n = p.shape[-1]
    q = p.reshape(2, 8, 2, 8, n)                   # (sy, y, sx, x, n)
    return q.permute(1, 3, 0, 2, 4).reshape(8, 8, 4 * n)


def chroma16_bytes(cand_c, neigh):
    """One chroma channel of a macroblock: the candidate's IDCT bytes
    [8, 8, N], shifted << 4 into the interior of its frozen 10x10 x16
    neighborhood [10, 10, N], upsampled to 16x16 and dithered with
    8 - (x & 1) on the column within the macroblock (16*bx is even, so
    that is the absolute column's parity) -> bytes [16, 16, N]."""
    filled = neigh.clone()
    filled[1:9, 1:9] = idct_lanes(cand_c) << 4
    dith = torch.as_tensor(8 - (_UP_X & 1), dtype=torch.int32,
                           device=neigh.device)[None, :, None]
    return (upsample_16x16_lanes(filled) + dith) >> 4


def _compare_420c_folded(cand_u, cand_v, neigh_u, neigh_v, y16s, xyb0_s,
                         scales_s, ymax_s, xmax_s, valid, exact_lut=None):
    """The macroblock compare with the four sub-blocks folded into the
    lanes: every sub-block is one CompareBlock against the frozen Y bytes;
    the result is the max over the valid sub-blocks, 0 for invalid ones
    (the max starts at 0). valid: [2, 2, N] bool."""
    ub = split16_lanes(chroma16_bytes(cand_u, neigh_u))
    vb = split16_lanes(chroma16_bytes(cand_v, neigh_v))

    def rep(p):
        return edge_replicate_lanes(p, ymax_s, xmax_s)

    errs = finish_lanes(ycbcr_to_rgb_lanes(rep(y16s), rep(ub), rep(vb)),
                        xyb0_s, scales_s, exact_lut).reshape(2, 2, -1)
    errs = torch.where(valid, errs, torch.zeros_like(errs))
    return torch.maximum(torch.maximum(errs[0, 0], errs[1, 0]),
                         torch.maximum(errs[0, 1], errs[1, 1]))


def fold_aux_420c(nu, nv, y16, x0c, scc, ymaxc, xmaxc, validc):
    """The kernel layout of the chroma-pass state (sub-blocks as leading
    dims, kernel_aux_420c) -> the folded layout of transpose_aux_420c."""
    n = nu.shape[-1]
    return (nu, nv, split16_lanes(y16),
            x0c.permute(2, 3, 4, 0, 1, 5).reshape(3, 8, 8, 4 * n),
            scc.permute(2, 0, 1, 3).reshape(3, 4 * n),
            ymaxc.reshape(4 * n), xmaxc.reshape(4 * n), validc > 0)


def compare_lanes_420c(cand_t, nu, nv, y16, x0c, scc, ymaxc, xmaxc,
                       validc, exact_lut=None):
    """The 4:2:0 chroma-pass CompareBlock over 16x16 macroblocks, in the
    CUDA kernels' layout: cand_t [3, 8, 8, N] (planes 1 and 2 are read);
    nu, nv [10, 10, N] int32 frozen x16 neighborhoods; y16 [16, 16, N]
    int32 frozen Y bytes; x0c [2, 2, 3, 8, 8, N] float32; scc
    [2, 2, 3, N] float32; ymaxc, xmaxc, validc [2, 2, N] int32. Returns
    [N] float32."""
    return _compare_420c_folded(
        cand_t[1], cand_t[2],
        *fold_aux_420c(nu, nv, y16, x0c, scc, ymaxc, xmaxc, validc),
        exact_lut=exact_lut)


def compare_blocks_lanes420c(cand_u, cand_v, neigh_u_t, neigh_v_t, y16s,
                             xyb0_s, scales_s, ymax_s, xmax_s, valid_t):
    """The chroma-pass compare with blocks-leading candidates [N, 64] and
    the folded state of transpose_aux_420c (the signature of
    guetzli_tpu/ops/tiles_lanes.compare_blocks_lanes420c)."""
    def lanes(c):
        return c.reshape(-1, 8, 8).permute(1, 2, 0)
    return _compare_420c_folded(lanes(cand_u), lanes(cand_v), neigh_u_t,
                                neigh_v_t, y16s, xyb0_s, scales_s, ymax_s,
                                xmax_s, valid_t)


def kernel_aux_420c(neigh_u, neigh_v, y16, xyb0_sub, scales_sub, ysel_sub,
                    xsel_sub, valid_sub):
    """Frozen 4:2:0 chroma-pass state (blocks leading: [N, 10, 10],
    [N, 10, 10], [N, 16, 16], [N, 2, 2, 3, 64], [N, 2, 2, 3],
    [N, 2, 2, 8], [N, 2, 2, 8], [N, 2, 2]) -> the CUDA kernels' layout:
    lane axis last, sub-blocks as leading dims, all contiguous."""
    n = neigh_u.shape[0]

    def last(a, dtype=None):
        a = a if dtype is None else a.to(dtype)
        return a.permute(tuple(range(1, a.dim())) + (0,)).contiguous()

    i32 = torch.int32
    return (last(neigh_u, i32), last(neigh_v, i32), last(y16, i32),
            last(xyb0_sub.reshape(n, 2, 2, 3, 8, 8)), last(scales_sub),
            last(ysel_sub[..., 7], i32), last(xsel_sub[..., 7], i32),
            last(valid_sub, i32))


def transpose_aux_420c(*aux):
    """Frozen chroma-pass state -> the folded layout (sub-blocks in the
    lanes, order (sub_y, sub_x, n); guetzli_tpu/ops/tiles_lanes
    .transpose_aux_420c)."""
    return fold_aux_420c(*kernel_aux_420c(*aux))


# The plain block compare of each mode over lane-major operands (each
# takes exact_lut=, see block_diff_lanes), and the transpose of each
# mode's frozen state into those operands.
COMPARE = {"444": compare_lanes, "420y": compare_lanes_420y,
           "420c": compare_lanes_420c}
LANE_AUX = {"444": transpose_aux_444, "420y": transpose_aux_420y,
            "420c": kernel_aux_420c}
