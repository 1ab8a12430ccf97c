"""The whole-image compare of one image on a band of its rows.

The exact-geometry chain of comparator._full_compare (4:4:4) and
_full_compare_420 and the block weights
(comparator._weights_all_radii_impl) cut into row bands
(parallel/mesh.RowBands): each rank computes the rows of every plane
that fall in its band, and each stencil stage first takes the rows it
reads past the band's edges from its neighbours (parallel/halo.py):

  stage                         rows read past the band   fill
  4:2:0 chroma upsample         1 subsampled row          (clamped)
  opsin blur (sigma 1.1)        2 (3 with the step)       0
  mask_high_intensity_change    1                         (masked)
  edge_detector_map             10: 7 of the 8-row
                                windows, 3 of the +-3
                                differences               (masked)
  block_diff_map                7 (8-row windows)         (masked)
  edge_detector_low_freq        blur 31 (step 4), then 8  0
  mask: diff_precompute         1                         (masked)
        average5x5              1                         0
        min_square_val          3 below                   +inf
        blurs                   up to 32 (step 4)         0
  combine_channels              3 below                   (masked)
  calculate_diffmap             1 res row above; the
                                inner blur 19 (step 2)    0
  weights' dilations            1 block row, each         -inf

Three invariants keep the bits of the single-device chain: the blurs'
border weights are the whole image's, sliced to the band; the strided
rows, the res grid (_res_positions) and the block grid are the global
grids (a band starts on a multiple of 48 rows); every test of the
image's size reads the global height. The diffmap's inner region starts
at row 2, so its blur runs on the bands shifted by 2 rows
(RowBands.span(shift=2)); its step of 2 keeps the grid, as 2 is even.

A 4:2:0 band holds whole macroblock rows (48 is a multiple of 16): its
chroma block rows' IDCT gives the subsampled plane's rows [lo/2,
min(hs, ceil(hi/2))), and the fancy upsample reads one subsampled row
past them each way. Those rows come by a halo exchange; each read's
row is clamped to the whole plane before it is shifted into the band,
so the exchange's fill past the image is never read (the edge row is
read instead, as on one device). lo is even, so a row's parity is its
global row's.

On the CPU one more op needs care: the sRGB power (ops/image.py). The
CPU's vectorized pow and its scalar tail round 6 of the 256 byte values
differently, and the tail is the last elements of the whole [3, H, W]
tensor (one torch thread). _srgb_to_linear lays each channel's band
into a tensor aligned as in the whole tensor, so each element takes the
path it takes there. On the card pow is one function for every element.
"""

import numpy as np
import torch
import torch.nn.functional as F

from guetzli_tpu_torch import config, consts
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import upsample as us
from guetzli_tpu_torch.ops.fp import sqrt
from guetzli_tpu_torch.ops.opsin import opsin_from_blurred
from guetzli_tpu_torch.parallel.halo import (halo_exchange_rows, pmax_scalar,
                                             sharded_blur)

_F32 = np.float32
# A multiple of twice the widest vector of floats a CPU loop uses.
_ALIGN = 1024


def _pow_run(run, start, total):
    """torch.pow(., 2.4) of the elements [start, start + len(run)) of a
    contiguous float32 tensor of `total` elements, each rounded as in a
    pow over that whole tensor on one CPU thread (module docstring)."""
    n = run.numel()
    end = start + n
    front = start % _ALIGN
    back = total - end if total - end < _ALIGN else -(front + n) % _ALIGN
    x = torch.cat([run.new_ones(front), run.reshape(-1), run.new_ones(back)])
    return torch.pow(x, img_ops._SRGB_POW)[front:front + n].reshape(
        run.shape)


def _srgb_to_linear(srgb, px, w):
    """img_ops.srgb_to_linear of the band's rows [3, n, W] of the whole
    image's [3, H, W] bytes, bit for bit. Under GUETZLI_TPU_EXACT_LUT the
    table read is per element, as on one device."""
    if srgb.device.type != "cpu" or config.exact_lut():
        return img_ops.srgb_to_linear(srgb)
    vf = srgb.to(torch.float32)
    lo = vf * img_ops._SRGB_LO
    base = (vf * img_ops._SRGB_SCALE + img_ops._SRGB_OFF) * img_ops._SRGB_DIV
    plane = px.size * w
    p = torch.stack([_pow_run(base[c], c * plane + px.lo * w, 3 * plane)
                     for c in range(3)])
    return torch.where(srgb < 11, lo, 255.0 * p)


def linear_rgb(coeffs, bw, bands, w):
    """The band's block rows of a 4:4:4 coefficient image [3, nbh * bw,
    64] int32 -> its pixel rows' linear RGB [3, n, W]."""
    px = bands.pixels()
    srgb = img_ops.coeffs_to_srgb(coeffs, bw, bands.blocks().n, w, px.n)
    return _srgb_to_linear(srgb, px, w)


def _sub_rows(coeffs, cbw, bands, ws):
    """The band's rows of x16 subsampled chroma planes from its chroma
    block rows coeffs [..., NBc_band, 64] -> (ext [..., s.n + 2, ws], s):
    s the band's Span of the subsampled plane's rows, ext its rows with
    one row of the neighbours' (or a fill) above and below."""
    s = bands.span(2, size=(bands.height + 1) // 2)
    sub = img_ops.blocks_to_plane(img_ops.idct_blocks(coeffs) << 4, cbw,
                                  bands.span(16).n, ws, s.n)
    return halo_exchange_rows(sub, 1, 0, s), s


def chroma_bytes(coeffs, cbw, bands, w):
    """img_ops.chroma_byte_plane of the band's pixel rows: the band's
    chroma block rows [..., NBc_band, 64] -> bytes [..., n, W]."""
    px = bands.pixels()
    ext, s = _sub_rows(coeffs, cbw, bands, (w + 1) // 2)
    return img_ops.byte_plane(us.fancy_upsample(ext, w, px.n, px.lo, s.size,
                                                s.lo - 1))


def neighborhoods(coeffs, cbw, bands, w):
    """ops/upsample.neighborhoods_10x10 of the band's macroblocks: the
    band's chroma block rows [..., NBc_band, 64] -> [..., NBc_band, 10,
    10]."""
    ext, s = _sub_rows(coeffs, cbw, bands, (w + 1) // 2)
    ms = bands.span(16)
    return us.neighborhoods_10x10(ext, cbw, ms.n, ms.lo, s.size, s.lo - 1)


def y_bytes(coeffs, bw, bands, w):
    """The Y byte plane of the band's pixel rows from its Y block rows
    [NB_band, 64]: no halo."""
    return img_ops.byte_plane(img_ops.blocks_to_plane(
        img_ops.idct_blocks(coeffs) << 4, bw, bands.blocks().n, w,
        bands.pixels().n))


def linear_rgb_420(y, uv, ybw, cbw, bands, w):
    """The band's linear RGB [3, n, W] of a 4:2:0 coefficient image: its
    Y block rows y [NB_band, 64] and chroma block rows uv [2, NBc_band,
    64] (img_ops.coeffs420_to_srgb, then the sRGB power)."""
    ub, vb = chroma_bytes(uv, cbw, bands, w)
    srgb = img_ops.ycbcr_to_rgb(y_bytes(y, ybw, bands, w), ub, vb)
    return _srgb_to_linear(srgb, bands.pixels(), w)


def opsin(lin, px):
    """opsin_dynamics_image of the band's rows [3, n, W]."""
    return opsin_from_blurred(
        lin, sharded_blur(lin, consts.OPSIN_SIGMA, 0.0, px))


def mask_high_intensity_change(xyb0, xyb1, px):
    ave = (xyb0 + xyb1) * 0.5
    y = ave[1]
    n, w = y.shape
    ext = halo_exchange_rows(y, 1, 0.0, px)
    rows = torch.arange(px.lo, px.hi, device=y.device)[:, None]
    cols = torch.arange(w, device=y.device)[None, :]

    def sq(shifted, valid):
        d = shifted - y
        d = d * d
        return torch.where(valid, d, torch.full_like(d, -1.0))

    sqr_max = torch.maximum(
        torch.maximum(sq(torch.roll(y, 1, -1), cols >= 1),
                      sq(torch.roll(y, -1, -1), cols + 1 < w)),
        torch.maximum(sq(ext[0:n], rows >= 1),
                      sq(ext[2:n + 2], rows + 1 < px.size)))
    mix = dm._mhic_mix(y, sqr_max)
    return mix * xyb0 + (1.0 - mix) * ave, mix * xyb1 + (1.0 - mix) * ave


def _res_rows(bands, size, step=3):
    """The band's rows [lo, hi) of a res grid's first `size` rows."""
    rs = bands.span(step)
    return range(min(rs.lo, size), min(rs.hi, size))


def edge_detector_map(xyb0, xyb1, bands, step=3):
    """dm.edge_detector_map's rows of the band's res rows -> [rs.n, RX,
    3]."""
    px = bands.pixels()
    h, w = px.size, xyb0.shape[-1]
    dev = xyb0.device
    pairs = [sharded_blur(torch.stack([xyb0[c], xyb1[c]]), s, 0.0, px)
             for c, s in enumerate(consts.EDGE_DETECTOR_SIGMAS)]
    both = torch.stack([torch.stack([p[0] for p in pairs]),
                        torch.stack([p[1] for p in pairs])])
    g = 10
    ext = halo_exchange_rows(both, g, 0.0, px)
    wgt = float(_F32(consts.EDGE_DETECTOR_W))

    def dir_diff(b, axis):                 # w * (b[p-3] - b[p+3])
        return wgt * (torch.roll(b, 3, dims=axis)
                      - torch.roll(b, -3, dims=axis))

    def lf_sq(d0, d1):
        vx0, vy0, vz0 = bd.xyb_low_freq_to_vals(d0[0], d0[1], d0[2])
        vx1, vy1, vz1 = bd.xyb_low_freq_to_vals(d1[0], d1[1], d1[2])
        return torch.stack([(vx0 - vx1) ** 2, (vy0 - vy1) ** 2,
                            (vz0 - vz1) ** 2])

    hmap = lf_sq(dir_diff(ext[0], -1), dir_diff(ext[1], -1))
    vmap = lf_sq(dir_diff(ext[0], -2), dir_diff(ext[1], -2))

    xs = np.arange(w)
    ys = np.arange(h)
    h_ok = (xs >= 3) & (xs + 3 < w)
    v_ok = (ys >= 3) & (ys + 3 < h)
    px_ = np.minimum(dm._res_positions(w, step, 8 - step), w - 8)
    py_all = np.minimum(dm._res_positions(h, step, 8 - step), h - 8)
    py = py_all[np.asarray(_res_rows(bands, len(py_all), step), np.int64)]
    acc = torch.zeros((3, len(py), len(px_)), device=dev)
    cnt = np.zeros((len(py), len(px_)), dtype=np.float32)
    for oy, ox in ((0, 0), (7, 0), (0, 7), (7, 7)):
        gy = py + oy
        gx = px_ + ox
        hv = np.repeat(h_ok[gx][None, :], len(py), axis=0)
        vv = np.repeat(v_ok[gy][:, None], len(px_), axis=1)
        gyt = dm._idx(gy - (px.lo - g), dev)[:, None]
        gxt = dm._idx(gx, dev)[None, :]
        acc = acc + torch.where(torch.as_tensor(hv, device=dev),
                                hmap[..., gyt, gxt], 0.0)
        acc = acc + torch.where(torch.as_tensor(vv, device=dev),
                                vmap[..., gyt, gxt], 0.0)
        cnt = cnt + hv + vv
    mul = _F32(consts.EDGE_DETECTOR_WEIGHT) * _F32(8.0) / cnt
    out = (acc * torch.as_tensor(mul, device=dev)).movedim(0, -1)
    return _pad_res(out, bands, w, step)


def _pad_res(m, bands, w, step=3):
    """Zero-pad the band's valid res rows [ny, nx, 3] to its res rows of
    the full res grid [rs.n, ceil(w / step), 3] (dm._pad_to_res)."""
    rs = bands.span(step)
    rx = -(-w // step)
    return F.pad(m, (0, 0, 0, rx - m.shape[-2], 0, rs.n - m.shape[-3]))


def block_diff_map(xyb0, xyb1, bands, step=3):
    """dm.block_diff_map's (dc, ac) rows of the band's res rows."""
    px = bands.pixels()
    h, w = px.size, xyb0.shape[-1]
    dev = xyb0.device
    pxs = np.minimum(dm._res_positions(w, step, 8 - step - 1), w - 8)
    py_all = np.minimum(dm._res_positions(h, step, 8 - step - 1), h - 8)
    py = py_all[np.asarray(_res_rows(bands, len(py_all), step), np.int64)]
    ny, nx = len(py), len(pxs)
    g = 7
    ext = halo_exchange_rows(torch.stack([xyb0, xyb1]), g, 0.0, px)
    yy = dm._idx((py[:, None] + np.arange(8)[None, :]).ravel()
              - (px.lo - g), dev)
    xx = dm._idx((pxs[:, None] + np.arange(8)[None, :]).ravel(), dev)

    def windows(img):                      # [3, n', W] -> [ny, nx, 3, 64]
        wins = img[..., yy, :][..., xx].reshape(3, ny, 8, nx, 8)
        return wins.permute(1, 3, 0, 2, 4).reshape(ny, nx, 3, 64)

    dc, ac, _edge = bd.block_diff(windows(ext[0]), windows(ext[1]))
    return _pad_res(dc, bands, w, step), _pad_res(ac, bands, w, step)


def edge_detector_low_freq(xyb0, xyb1, ac_map, bands, step=3):
    """dm.edge_detector_low_freq on the band's res rows of ac_map."""
    px = bands.pixels()
    h, w = px.size, xyb0.shape[-1]
    dev = xyb0.device
    both = sharded_blur(torch.stack([xyb0, xyb1]), consts.EDGE_LF_SIGMA,
                        0.0, px)
    e = both[1] - both[0]
    ys_all = dm._res_positions(h, step, 8)
    xs = dm._res_positions(w, step, 8)
    if len(ys_all) == 0 or len(xs) == 0:
        return ac_map
    ys = ys_all[np.asarray(_res_rows(bands, len(ys_all), step), np.int64)]
    ext = halo_exchange_rows(e, (0, 8), 0.0, px)

    def rows(dy):
        return dm._idx(ys + dy - px.lo, dev)[:, None]

    def shifted(dy, dx):
        return ext[..., rows(dy), dm._idx(xs + dx, dev)[None, :]]

    base = shifted(0, 0)
    diffs = [base - shifted(0, 8), base - shifted(8, 0),
             base - shifted(6, 6)]
    far = base - ext[..., rows(6),
                     dm._idx(np.maximum(xs - 6, 0), dev)[None, :]]
    near = torch.as_tensor(xs < 8, device=dev)[None, None, :]
    diffs.append(torch.where(near, torch.zeros_like(base), far))
    per_k = [torch.stack(bd.xyb_diff_low_freq_squared(d[0], d[1], d[2]))
             for d in diffs]
    md = torch.maximum(torch.maximum(per_k[0], per_k[1]),
                       torch.maximum(per_k[2], per_k[3]))
    add = md.movedim(0, -1) * float(_F32(consts.EDGE_LF_MUL))
    off = 8 // step
    pad_y = ac_map.shape[-3] - add.shape[-3]
    pad_x = ac_map.shape[-2] - add.shape[-2] - off
    return ac_map + F.pad(add, (0, 0, off, pad_x, 0, pad_y))


def _diff_precompute(xyb0, xyb1, px):
    """dm.diff_precompute of the band's rows."""
    n = px.n
    ext = halo_exchange_rows(torch.stack([xyb0, xyb1]), 1, 0.0, px)

    def vals(d):
        return torch.stack([
            bd.color_diff_dx_hf(d[0] * float(_F32(consts.XYB_HF_XMUL))),
            bd.color_diff_dy_hf(d[1] * float(_F32(consts.XYB_HF_YMUL))),
            d[2] * float(_F32(consts.XYB_HF_ZMUL))])

    def sup(e):
        img = e[..., 1:n + 1, :]
        right = torch.cat([img[..., 1:], img[..., -2:-1]], dim=-1)
        down = e[..., 2:n + 2, :]
        if px.hi == px.size:
            # The last row's neighbour below is the row above it.
            down = torch.cat([down[..., :n - 1, :], e[..., n - 1:n, :]],
                             dim=-2)
        return vals(img - right).abs() + vals(img - down).abs()

    return torch.minimum(sup(ext[0]), sup(ext[1]))


def _average5x5(img, px):
    """dm.average5x5 of the band's rows of one plane [n, W]."""
    w = img.shape[-1]
    if px.size < 4 or w < 4:
        return img
    wgt = float(_F32(consts.AVERAGE5X5_DIAG_W))
    scale = float(_F32(1.0 / (5.0 + 4 * _F32(consts.AVERAGE5X5_DIAG_W))))
    p = F.pad(halo_exchange_rows(img, 1, 0.0, px), (1, 1))
    c = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] \
        + p[..., 1:-1, 2:] + p[..., 1:-1, 1:-1]
    dg = p[..., :-2, :-2] + p[..., :-2, 2:] + p[..., 2:, :-2] \
        + p[..., 2:, 2:]
    return (c + wgt * dg) * scale


def _min_square_val(img, px, square=4):
    """dm.min_square_val (offset 0) of the band's rows of one plane."""
    inf = float("inf")
    ext = halo_exchange_rows(img, (0, square - 1), inf, px)
    p = F.pad(ext[None], (0, square - 1), value=inf)
    return -F.max_pool2d(-p, square, stride=1)[0]


def mask(xyb0, xyb1, bands):
    """dm.mask of the band's rows -> (mask, mask_dc) each [3, n, W]."""
    px = bands.pixels()
    m = _diff_precompute(xyb0, xyb1, px)
    chans = []
    for c in range(3):
        mc = _min_square_val(_average5x5(m[c], px), px)
        chans.append(sharded_blur(mc, consts.MASK_SIGMAS[c], 0.0, px))
    p = torch.stack(chans) * torch.as_tensor(
        consts.MASK_W.astype(np.float32), device=xyb0.device).reshape(3, 1, 1)
    g2 = float(_F32(consts.K_GLOBAL_SCALE * consts.K_GLOBAL_SCALE))
    mask_out = torch.stack([bd.mask_lut("x", p[0]), bd.mask_lut("y", p[1]),
                            bd.mask_lut("b", p[2])]) * g2
    mask_dc = torch.stack([bd.mask_lut("dc_x", p[0]),
                           bd.mask_lut("dc_y", p[1]),
                           bd.mask_lut("dc_b", p[2])]) * g2
    return mask_out, mask_dc


def combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map, bands,
                     step=3):
    """dm.combine_channels' rows of the band's valid res rows -> [ny, nx]."""
    px = bands.pixels()
    h, w = px.size, mask_xyb.shape[-1]
    dev = mask_xyb.device
    ry_all = dm._res_positions(h, step, 8 - step) + 3
    ry = ry_all[np.asarray(_res_rows(bands, len(ry_all), step), np.int64)]
    rx = dm._idx(dm._res_positions(w, step, 8 - step) + 3, dev)
    ext = halo_exchange_rows(torch.stack([mask_xyb, mask_dc]), (0, 3), 0.0,
                             px)
    iy = dm._idx(ry - px.lo, dev)[:, None]
    msel = ext[0][..., iy, rx[None, :]]
    dsel = ext[1][..., iy, rx[None, :]]
    ny, nx = len(ry), len(rx)
    dc = dc_map[..., :ny, :nx, :].movedim(-1, 0)
    ac = ac_map[..., :ny, :nx, :].movedim(-1, 0)
    em = edge_map[..., :ny, :nx, :].movedim(-1, 0)
    return (dc * dsel).sum(0) + (ac * msel).sum(0) + (em * msel).sum(0)


def calculate_diffmap(res_map, bands, w, step=3):
    """dm.calculate_diffmap's rows of the band: res_map [ny, nx], the
    band's valid res rows -> [n, W]."""
    px = bands.pixels()
    rs = bands.span(step)
    h = px.size
    dev = res_map.device
    s2 = (8 - step) // 2
    s = 8 - step
    ny_all = len(dm._res_positions(h, step, 8 - step))
    slope = _F32(consts.DIFFMAP_INITIAL_SLOPE)
    res = F.pad(res_map, (0, 0, 0, rs.n - res_map.shape[0]))
    val = torch.where(res < float(_F32(1.0) / (slope * slope)),
                      float(slope) * res, sqrt(res))
    # Row y of the diffmap takes res row (y - s2) // step: one res row
    # above the band's own.
    ext = halo_exchange_rows(val, (1, 0), 0.0, rs)
    ys = np.arange(px.lo, px.hi)
    ok = (ys >= s2) & (ys < s2 + min(ny_all * step, h - s2))
    src = np.clip((ys - s2) // step - (rs.lo - 1), 0, ext.shape[0] - 1)
    nx = res_map.shape[1]
    up = ext[dm._idx(src, dev)].repeat_interleave(step, -1)
    ncol = min(nx * step, w - s2)
    dmap = torch.zeros((px.n, w), dtype=res_map.dtype, device=dev)
    dmap[:, s2:s2 + ncol] = up[:, :ncol]
    dmap = torch.where(torch.as_tensor(ok, device=dev)[:, None], dmap, 0.0)
    inner = bands.span(1, shift=s2, size=h - s)
    a, b = inner.lo + s2 - px.lo, inner.hi + s2 - px.lo
    blurred = sharded_blur(dmap[a:b, s2:s2 + w - s], consts.DIFFMAP_SIGMA,
                           consts.DIFFMAP_BORDER_RATIO, inner)
    dmap[a:b, s2:s2 + w - s] += float(_F32(consts.DIFFMAP_MUL1)) * blurred
    return dmap * float(_F32(1.0 / (1.0 + consts.DIFFMAP_MUL1)))


def diffmap(xyb0, xyb1, bands, step=3):
    """dm.diffmap_opsin_dynamics of the band: opsin rows [3, n, W] in,
    diffmap rows [n, W] out."""
    h, w = bands.height, xyb1.shape[-1]
    if h < 8 or w < 8:
        return torch.zeros(xyb1.shape[1:], dtype=xyb1.dtype,
                           device=xyb1.device)
    px = bands.pixels()
    if px.n == 0:
        # No rows, no exchanges: the neighbours skip this rank.
        return xyb1.new_zeros((0, w))
    xyb0m, xyb1m = mask_high_intensity_change(xyb0, xyb1, px)
    edge_map = edge_detector_map(xyb0m, xyb1m, bands, step)
    dc_map, ac_map = block_diff_map(xyb0m, xyb1m, bands, step)
    ac_map = edge_detector_low_freq(xyb0m, xyb1m, ac_map, bands, step)
    mask_xyb, mask_dc = mask(xyb0m, xyb1m, bands)
    res = combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map,
                           bands, step)
    return calculate_diffmap(res, bands, w, step)


def score(dmap, bands):
    """The max of the band's diffmap rows over every rank."""
    local = dmap.amax() if dmap.numel() else dmap.new_tensor(float("-inf"))
    return pmax_scalar(local, bands.group)


def _dilate(x, gs):
    """comparator._dilate_max of the band's block rows [n, gbw]: 3x3 max
    with -inf outside the grid."""
    ext = halo_exchange_rows(x, 1, float("-inf"), gs)
    return F.max_pool2d(ext[None, None], 3, stride=1, padding=(0, 1))[0, 0]


def weights(dmap, target, sizex, sizey, gbw, gbh, direction_pos, bands):
    """comparator._weights_all_radii_impl of the band's diffmap rows
    [n, W] -> [4, gbh * gbw], every rank's block rows gathered."""
    gs = bands.span(sizey, size=gbh)
    n, w = dmap.shape
    out = dmap.new_zeros((gs.n, 4, gbw))
    if gs.n:
        pad = dmap.new_zeros((gs.n * sizey, gbw * sizex))
        pad[:n, :w] = dmap
        max_dist = F.max_pool2d(pad[None, None], (sizey, sizex))[0, 0]
        t = _F32(target)
        ws = []
        local = max_dist
        if direction_pos:
            for _ in range(4):
                local = _dilate(local, gs)
                ml = torch.clamp(local, min=float(t))
                ws.append(((max_dist <= float(t))
                           & (ml <= float(_F32(1.1) * t))).float())
        else:
            for r in range(1, 5):
                local = _dilate(local, gs)
                ml = torch.clamp(local, min=float(t))
                src = max_dist > (float(_F32(0.5) * t) + 0.5 * ml)
                w_r = torch.zeros_like(max_dist)
                reach = src.float()
                for d in range(r + 1):
                    w_r = torch.maximum(w_r,
                                        reach * float(_F32(1.0 / (d + 1))))
                    if d < r:
                        reach = _dilate(reach, gs)
                ws.append(w_r)
        out = torch.stack(ws, 1)
    full = bands.group.all_gather_rows(out, gs.counts())
    return full.transpose(0, 1).reshape(4, gbh * gbw)
