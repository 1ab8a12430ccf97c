"""Full butteraugli diffmap (butteraugli.cc:985-1567).

Pipeline, mirroring ButteraugliComparator::DiffmapOpsinDynamicsImage:

  MaskHighIntensityChange -> EdgeDetectorMap -> BlockDiffMap ->
  EdgeDetectorLowFreq -> Mask -> CombineChannels -> CalculateDiffmap

Whole planar images in, the per-step-grid loops of the reference become
strided index sets and batched 8x8 block ops: the exact-geometry chain of
the JAX package, and at the end of this module its padded-bucket
``_dyn`` chain, which stacks images of one bucket (ops/padgeom.py).

Every function also takes B independent trials (the batched quant
compare, comparator.py): image planes [3, B, H, W] (the original's
[3, H, W] broadcasts), channel-last maps [B, ny, nx, 3], single planes
[B, H, W]. A trial's bits are those of a compare of that trial alone:
the ops whose rounding may depend on the batch (the blurs' convolutions,
the DFTs' matrix products, the sRGB power) run once per trial
(blur.py, blockdiff.py, image.py); every other op is elementwise, a
gather or a reduction within one trial.
"""

import numpy as np
import torch
import torch.nn.functional as F

from guetzli_tpu_torch import config, consts
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import devconst
from guetzli_tpu_torch.ops.blur import blur, blur_dyn
from guetzli_tpu_torch.ops.fp import div, sqrt

_F32 = np.float32
_MASK_W = consts.MASK_W.astype(np.float32)


def _mhic_mix(y, sqr_max):
    red = consts.MHIC_REDUCTION.astype(np.float32)
    chroma = float(_F32(consts.MHIC_CHROMA_BALANCE))
    chroma_scale = div(chroma, y + chroma)
    return torch.stack([
        div(chroma_scale * float(red[0]), sqr_max + float(red[0])),
        div(float(red[1]), sqr_max + float(red[1])),
        div(chroma_scale * float(red[2]), sqr_max + float(red[2])),
    ])


def mask_high_intensity_change(xyb0, xyb1):
    """butteraugli.cc:791-843. Inputs/outputs [3, H, W] (or [3, B, H,
    W])."""
    ave = (xyb0 + xyb1) * 0.5
    y = ave[1]
    h, w = y.shape[-2:]

    def sq_shift(dy, dx):
        shifted = torch.roll(y, shifts=(-dy, -dx), dims=(-2, -1))
        d = shifted - y
        d = d * d
        valid = torch.ones((h, w), dtype=torch.bool, device=y.device)
        if dx == -1:
            valid[:, 0] = False
        if dx == 1:
            valid[:, -1] = False
        if dy == -1:
            valid[0, :] = False
        if dy == 1:
            valid[-1, :] = False
        return torch.where(valid, d, torch.full_like(d, -1.0))

    sqr_max = torch.maximum(
        torch.maximum(sq_shift(0, -1), sq_shift(0, 1)),
        torch.maximum(sq_shift(-1, 0), sq_shift(1, 0)))
    mix = _mhic_mix(y, sqr_max)
    return mix * xyb0 + (1.0 - mix) * ave, mix * xyb1 + (1.0 - mix) * ave


def _pad_to_res(m, w, h, step):
    """Zero-pad a step-grid map [..., ny, nx, 3] to the full res grid
    [..., ceil(h/step), ceil(w/step), 3]."""
    ry = -(-h // step)
    rx = -(-w // step)
    return F.pad(m, (0, 0, 0, rx - m.shape[-2], 0, ry - m.shape[-3]))


def _res_positions(size, step, margin):
    """Step-grid positions (0, step, ...) with res + margin < size."""
    n = (size - margin - 1) // step + 1 if size > margin else 0
    return np.arange(n, dtype=np.int64) * step


def _idx(a, device):
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def _edge_map_consts(h, w, step, dev):
    """edge_detector_map's per-geometry constants on `dev`: for each of
    its four corner offsets the step grid's rows [ny, 1] and columns [1,
    nx] (int64) and their horizontal and vertical validity [ny, nx]
    (bool), then the normalization [ny, nx] (float32)."""
    def make():
        xs = np.arange(w)
        ys = np.arange(h)
        h_ok = (xs >= 3) & (xs + 3 < w)
        v_ok = (ys >= 3) & (ys + 3 < h)
        px = np.minimum(_res_positions(w, step, 8 - step), w - 8)
        py = np.minimum(_res_positions(h, step, 8 - step), h - 8)
        out = []
        cnt = np.zeros((len(py), len(px)), dtype=np.float32)
        for oy, ox in ((0, 0), (7, 0), (0, 7), (7, 7)):
            gy = py + oy
            gx = px + ox
            hv = np.repeat(h_ok[gx][None, :], len(py), axis=0)
            vv = np.repeat(v_ok[gy][:, None], len(px), axis=1)
            out += [gy.astype(np.int64)[:, None],
                    gx.astype(np.int64)[None, :], hv, vv]
            cnt = cnt + hv + vv
        return tuple(out) + (_F32(consts.EDGE_DETECTOR_WEIGHT) * _F32(8.0)
                             / cnt,)
    return devconst.get(("edge_detector_map", h, w, step), dev, make)


def edge_detector_map(xyb0, xyb1, step=3):
    """butteraugli.cc:689-738, 1119-1149 -> [ry, rx, 3] res grid."""
    h, w = xyb0.shape[-2:]
    trial_axis = 1 if xyb0.dim() == 4 else None
    pairs = [blur(torch.stack([xyb0[c], xyb1[c]]), s, 0.0, trial_axis)
             for c, s in enumerate(consts.EDGE_DETECTOR_SIGMAS)]
    blurred0 = torch.stack([p[0] for p in pairs])
    blurred1 = torch.stack([p[1] for p in pairs])
    wgt = float(_F32(consts.EDGE_DETECTOR_W))

    def dir_diff(b, axis):                 # w * (b[p-3] - b[p+3])
        return wgt * (torch.roll(b, 3, dims=axis)
                      - torch.roll(b, -3, dims=axis))

    def lf_sq(d0, d1):
        vx0, vy0, vz0 = bd.xyb_low_freq_to_vals(d0[0], d0[1], d0[2])
        vx1, vy1, vz1 = bd.xyb_low_freq_to_vals(d1[0], d1[1], d1[2])
        return torch.stack([(vx0 - vx1) ** 2, (vy0 - vy1) ** 2,
                            (vz0 - vz1) ** 2])

    hmap = lf_sq(dir_diff(blurred0, -1), dir_diff(blurred1, -1))
    vmap = lf_sq(dir_diff(blurred0, -2), dir_diff(blurred1, -2))

    consts_ = _edge_map_consts(h, w, step, xyb0.device)
    mul = consts_[-1]
    acc = torch.zeros(hmap.shape[:-2] + tuple(mul.shape),
                      device=xyb0.device)
    for k in range(4):
        gyt, gxt, hv, vv = consts_[4 * k:4 * k + 4]
        acc = acc + torch.where(hv, hmap[..., gyt, gxt], 0.0)
        acc = acc + torch.where(vv, vmap[..., gyt, gxt], 0.0)
    out = (acc * mul).movedim(0, -1)
    return _pad_to_res(out, w, h, step)


def block_diff_map(xyb0, xyb1, step=3):
    """butteraugli.cc:1081-1117 -> (dc, ac) maps [ry, rx, 3]."""
    h, w = xyb0.shape[-2:]
    lead = xyb0.shape[1:-2]
    n = len(lead)
    px = np.minimum(_res_positions(w, step, 8 - step - 1), w - 8)
    py = np.minimum(_res_positions(h, step, 8 - step - 1), h - 8)
    ny, nx = len(py), len(px)
    yy, xx = devconst.get(
        ("block_diff_map", h, w, step), xyb0.device,
        lambda: tuple((p[:, None] + np.arange(8)[None, :]).ravel()
                      for p in (py, px)), torch.int64)

    def windows(img):                      # [3, H, W] -> [ny, nx, 3, 64]
        wins = img[..., yy, :][..., xx].reshape(
            (3,) + lead + (ny, 8, nx, 8))
        perm = tuple(range(1, n + 1)) + (n + 1, n + 3, 0, n + 2, n + 4)
        return wins.permute(perm).reshape(lead + (ny, nx, 3, 64))

    dc, ac, _edge = bd.block_diff(windows(xyb0), windows(xyb1),
                                  trials=n > 0)
    return _pad_to_res(dc, w, h, step), _pad_to_res(ac, w, h, step)


def edge_detector_low_freq(xyb0, xyb1, ac_map, step=3):
    """butteraugli.cc:1151-1205; adds into ac_map at x-offset 8//step."""
    h, w = xyb0.shape[-2:]
    both = blur(torch.stack([xyb0, xyb1]), consts.EDGE_LF_SIGMA, 0.0,
                2 if xyb0.dim() == 4 else None)
    e = both[1] - both[0]
    ys = _res_positions(h, step, 8)
    xs = _res_positions(w, step, 8)
    if len(ys) == 0 or len(xs) == 0:
        return ac_map
    # Rows ys, ys + 8, ys + 6 [n, 1]; columns xs, xs + 8, xs + 6, xs - 6
    # (clamped at 0) [1, n]; x < 8 [1, 1, n].
    y0, y8, y6, x0, x8, x6, xm6, near = devconst.get(
        ("edge_detector_low_freq", h, w, step), xyb0.device,
        lambda: tuple(ys[:, None] + d for d in (0, 8, 6))
        + tuple(xs[None, :] + d for d in (0, 8, 6))
        + (np.maximum(xs - 6, 0)[None, :], (xs < 8)[None, None, :]))

    base = e[..., y0, x0]
    diffs = [base - e[..., y0, x8], base - e[..., y8, x0],
             base - e[..., y6, x6]]
    # Direction 3 reaches x-6; zero where x < 8.
    far = base - e[..., y6, xm6]
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


def diff_precompute(xyb0, xyb1):
    """butteraugli.cc:1440-1493 -> [3, H, W]."""
    def vals(d):
        return torch.stack([
            bd.color_diff_dx_hf(d[0] * float(_F32(consts.XYB_HF_XMUL))),
            bd.color_diff_dy_hf(d[1] * float(_F32(consts.XYB_HF_YMUL))),
            d[2] * float(_F32(consts.XYB_HF_ZMUL))])

    def sup(img):
        # Neighbor x+1 (x-1 at the right border), likewise y+1.
        right = torch.cat([img[..., 1:], img[..., -2:-1]], dim=-1)
        down = torch.cat([img[..., 1:, :], img[..., -2:-1, :]], dim=-2)
        return vals(img - right).abs() + vals(img - down).abs()

    return torch.minimum(sup(xyb0), sup(xyb1))


def average5x5(img):
    """3x3 cross + diagonal average (butteraugli.cc:1379-1438), zero
    padded."""
    h, w = img.shape[-2:]
    if h < 4 or w < 4:
        return img
    wgt = float(_F32(consts.AVERAGE5X5_DIAG_W))
    scale = float(_F32(1.0 / (5.0 + 4 * _F32(consts.AVERAGE5X5_DIAG_W))))
    p = F.pad(img, (1, 1, 1, 1))
    c = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] \
        + p[..., 1:-1, 2:] + p[..., 1:-1, 1:-1]
    dg = p[..., :-2, :-2] + p[..., :-2, 2:] + p[..., 2:, :-2] \
        + p[..., 2:, 2:]
    return (c + wgt * dg) * scale


def min_square_val(img, square=4, offset=0):
    """Sliding-window min over [y, y+square) x [x, x+square) with +inf
    outside the image (butteraugli.cc:1332-1376)."""
    p = F.pad(img[None], (offset, square - offset - 1,
                          offset, square - offset - 1), value=float("inf"))
    return -F.max_pool2d(-p, square, stride=1)[0]


def mask(xyb0, xyb1):
    """butteraugli.cc:1495-1567 -> (mask, mask_dc) each [3, H, W]."""
    m = diff_precompute(xyb0, xyb1)
    trial_axis = 0 if xyb0.dim() == 4 else None
    chans = []
    for c in range(3):
        mc = average5x5(m[c])
        mc = min_square_val(mc, 4, 0)
        chans.append(blur(mc, consts.MASK_SIGMAS[c], 0.0, trial_axis))
    p = torch.stack(chans) * devconst.array(_MASK_W, xyb0.device).reshape(
        (3,) + (1,) * (xyb0.dim() - 1))
    g2 = float(_F32(consts.K_GLOBAL_SCALE * consts.K_GLOBAL_SCALE))
    mask_out = torch.stack([bd.mask_lut("x", p[0]), bd.mask_lut("y", p[1]),
                            bd.mask_lut("b", p[2])]) * g2
    mask_dc = torch.stack([bd.mask_lut("dc_x", p[0]),
                           bd.mask_lut("dc_y", p[1]),
                           bd.mask_lut("dc_b", p[2])]) * g2
    return mask_out, mask_dc


def combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map, h, w,
                     step=3):
    """butteraugli.cc:1207-1231 -> res-grid diffmap [ny, nx]."""
    ry, rx = devconst.get(
        ("combine_channels", h, w, step), mask_xyb.device,
        lambda: (_res_positions(h, step, 8 - step) + 3,
                 _res_positions(w, step, 8 - step) + 3), torch.int64)
    msel = mask_xyb[..., ry[:, None], rx[None, :]]
    dsel = mask_dc[..., ry[:, None], rx[None, :]]
    ny, nx = len(ry), len(rx)
    dc = dc_map[..., :ny, :nx, :].movedim(-1, 0)
    ac = ac_map[..., :ny, :nx, :].movedim(-1, 0)
    em = edge_map[..., :ny, :nx, :].movedim(-1, 0)
    return (dc * dsel).sum(0) + (ac * msel).sum(0) + (em * msel).sum(0)


def calculate_diffmap(res_map, h, w, step=3):
    """Upsample-sqrt + clustered blur (butteraugli.cc:985-1044) -> [H, W]
    ([B, ny, nx] -> [B, H, W])."""
    s2 = (8 - step) // 2
    slope = _F32(consts.DIFFMAP_INITIAL_SLOPE)
    val = torch.where(res_map < float(_F32(1.0) / (slope * slope)),
                      float(slope) * res_map, sqrt(res_map))
    up = val.repeat_interleave(step, -2).repeat_interleave(step, -1)
    ny, nx = res_map.shape[-2:]
    dm = torch.zeros(res_map.shape[:-2] + (h, w), dtype=res_map.dtype,
                     device=res_map.device)
    dm[..., s2:s2 + ny * step, s2:s2 + nx * step] = \
        up[..., :min(ny * step, h - s2), :min(nx * step, w - s2)]
    s = 8 - step
    inner = dm[..., s2:s2 + h - s, s2:s2 + w - s]
    blurred = blur(inner, consts.DIFFMAP_SIGMA, consts.DIFFMAP_BORDER_RATIO,
                   0 if res_map.dim() == 3 else None)
    dm[..., s2:s2 + h - s, s2:s2 + w - s] += \
        float(_F32(consts.DIFFMAP_MUL1)) * blurred
    return dm * float(_F32(1.0 / (1.0 + consts.DIFFMAP_MUL1)))


def diffmap_opsin_dynamics(xyb0, xyb1, step=3):
    """Full metric: opsin images [3, H, W] in, diffmap [H, W] out; B
    trials' [3, B, H, W] against the original's [3, H, W] -> [B, H, W]."""
    h, w = xyb1.shape[-2:]
    if h < 8 or w < 8:
        return torch.zeros(xyb1.shape[1:-2] + (h, w), dtype=xyb1.dtype,
                           device=xyb1.device)
    if xyb1.dim() > xyb0.dim():
        xyb0 = xyb0[:, None]
    xyb0m, xyb1m = mask_high_intensity_change(xyb0, xyb1)
    edge_map = edge_detector_map(xyb0m, xyb1m, step)
    dc_map, ac_map = block_diff_map(xyb0m, xyb1m, step)
    ac_map = edge_detector_low_freq(xyb0m, xyb1m, ac_map, step)
    mask_xyb, mask_dc = mask(xyb0m, xyb1m)
    res = combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map,
                           h, w, step)
    return calculate_diffmap(res, h, w, step)


def score_from_diffmap(dm):
    """butteraugli.cc:1233-1239: the max of a diffmap [..., H, W]."""
    return dm.amax((-2, -1))


# ---------------------------------------------------------------------------
# Padded ("dynamic geometry") variants (JAX ops/diffmap.py:355-747): the
# same math on B images stacked on an image axis, every shape fixed by
# their common bucket (Hp, Wp) and each image's true size in the int
# tensors w, h [B]. Positions and validity masks are computed on the
# device from w and h; the float64 blur border scales arrive in `sc`
# ({name: (scale_x [B, nx], scale_y [B, ny])}, ops/padgeom.py). Planes
# are [3, B, Hp, Wp], res-grid maps channel-major [3, B, RY, RX]. Inputs
# may hold garbage outside each valid region; every consumer masks.
# An image's bits do not depend on the stack: the convolutions, the DFT
# products and the sRGB power run once per image at a one-image shape;
# everything else is elementwise, a gather or a reduction inside one
# image.

def _vmask(hp, wp, w, h):
    """[B, Hp, Wp] bool: inside each image's valid region."""
    row = torch.arange(hp, device=w.device)
    col = torch.arange(wp, device=w.device)
    return ((row[None, :, None] < h[:, None, None])
            & (col[None, None, :] < w[:, None, None]))


def _pad_to_res_cm(m, wp, hp, step):
    """Channel-major _pad_to_res: [..., ny, nx] -> [..., RY, RX]."""
    ry = -(-hp // step)
    rx = -(-wp // step)
    return F.pad(m, (0, rx - m.shape[-1], 0, ry - m.shape[-2]))


def _res_positions_dyn(padded, actual, step, margin):
    """The padded analog of _res_positions: the static step-grid
    positions of the bucket [n] and each image's validity [B, n]."""
    n = (padded - margin - 1) // step + 1
    pos = torch.arange(n, device=actual.device) * step
    return pos, pos[None, :] + margin < actual[:, None]


def _sel_matrix(targets, size):
    """One-hot selection matrices [B, m, size] float32 from positions
    targets [B, m]: row i of image b is 1.0 at column targets[b, i]."""
    cols = torch.arange(size, device=targets.device)
    return (targets[:, :, None] == cols).to(torch.float32)


def _select_yx(img, ty, tx):
    """img [C, B, H, W] -> [C, B, m, n]: rows ty [B, m] and columns tx
    [B, n] of each image. A gather (JAX _select_yx in its default take
    form), or under GUETZLI_TPU_SEL_MATMUL=1 JAX's one-hot form, two
    matmuls with 0/1 matrices: each output is one 1.0 * value product
    (TF32 off: device.resolve, and here), so both forms are exact."""
    if config.sel_matmul():
        torch.backends.cuda.matmul.allow_tf32 = False
        sy = _sel_matrix(ty, img.shape[-2])               # [B, m, H]
        sx = _sel_matrix(tx, img.shape[-1])               # [B, n, W]
        rows = torch.matmul(sy, img)                      # [C, B, m, W]
        return torch.matmul(rows, sx.transpose(-1, -2))   # [C, B, m, n]
    b = torch.arange(img.shape[1], device=img.device)[:, None, None]
    return img[:, b, ty[:, :, None], tx[:, None, :]]


def mask_high_intensity_change_dyn(xyb0, xyb1, w, h):
    ave = (xyb0 + xyb1) * 0.5
    y = ave[1]
    hp, wp = y.shape[-2:]
    row = torch.arange(hp, device=y.device)[None, :, None]
    col = torch.arange(wp, device=y.device)[None, None, :]

    def sq_shift(dy, dx):
        shifted = torch.roll(y, shifts=(-dy, -dx), dims=(-2, -1))
        d = shifted - y
        d = d * d
        if dx == -1:
            valid = col >= 1
        elif dx == 1:
            valid = col + 1 < w[:, None, None]
        elif dy == -1:
            valid = row >= 1
        else:
            valid = row + 1 < h[:, None, None]
        return torch.where(valid, d, torch.full_like(d, -1.0))

    sqr_max = torch.maximum(
        torch.maximum(sq_shift(0, -1), sq_shift(0, 1)),
        torch.maximum(sq_shift(-1, 0), sq_shift(1, 0)))
    mix = _mhic_mix(y, sqr_max)
    return mix * xyb0 + (1.0 - mix) * ave, mix * xyb1 + (1.0 - mix) * ave


def edge_detector_map_dyn(xyb0, xyb1, w, h, sc, step=3):
    """-> [3, B, RY, RX]."""
    hp, wp = xyb0.shape[-2:]
    dev = xyb0.device
    vm = _vmask(hp, wp, w, h)
    pairs = [blur_dyn(torch.stack([xyb0[c] * vm, xyb1[c] * vm]), s,
                      *sc["ed%d" % c])
             for c, s in enumerate(consts.EDGE_DETECTOR_SIGMAS)]
    blurred0 = torch.stack([p[0] for p in pairs])
    blurred1 = torch.stack([p[1] for p in pairs])
    wgt = float(_F32(consts.EDGE_DETECTOR_W))

    def dir_diff(b, axis):                 # w * (b[p-3] - b[p+3])
        return wgt * (torch.roll(b, 3, dims=axis)
                      - torch.roll(b, -3, dims=axis))

    def lf_sq(d0, d1):
        vx0, vy0, vz0 = bd.xyb_low_freq_to_vals(d0[0], d0[1], d0[2])
        vx1, vy1, vz1 = bd.xyb_low_freq_to_vals(d1[0], d1[1], d1[2])
        return torch.stack([(vx0 - vx1) ** 2, (vy0 - vy1) ** 2,
                            (vz0 - vz1) ** 2])

    hmap = lf_sq(dir_diff(blurred0, -1), dir_diff(blurred1, -1))
    vmap = lf_sq(dir_diff(blurred0, -2), dir_diff(blurred1, -2))

    xs = torch.arange(wp, device=dev)[None, :]
    ys = torch.arange(hp, device=dev)[None, :]
    h_ok = (xs >= 3) & (xs + 3 < w[:, None])           # [B, Wp]
    v_ok = (ys >= 3) & (ys + 3 < h[:, None])           # [B, Hp]
    rx, rx_ok = _res_positions_dyn(wp, w, step, 8 - step)
    ry, ry_ok = _res_positions_dyn(hp, h, step, 8 - step)
    px = torch.minimum(rx[None], w[:, None] - 8).clamp(min=0)   # [B, nx]
    py = torch.minimum(ry[None], h[:, None] - 8).clamp(min=0)
    nb, ny, nx = w.shape[0], len(ry), len(rx)
    bi = torch.arange(nb, device=dev)[:, None]
    acc = torch.zeros((3, nb, ny, nx), device=dev)
    cnt = torch.zeros((nb, ny, nx), device=dev)
    for oy, ox in ((0, 0), (7, 0), (0, 7), (7, 7)):
        gy, gx = py + oy, px + ox
        hv = h_ok[bi, gx][:, None, :].expand(nb, ny, nx)
        vv = v_ok[bi, gy][:, :, None].expand(nb, ny, nx)
        acc = acc + torch.where(hv, _select_yx(hmap, gy, gx), 0.0)
        acc = acc + torch.where(vv, _select_yx(vmap, gy, gx), 0.0)
        cnt = cnt + hv + vv
    mul = div(float(_F32(consts.EDGE_DETECTOR_WEIGHT) * _F32(8.0)),
              torch.where(cnt > 0, cnt, torch.ones_like(cnt)))
    out = torch.where((ry_ok[:, :, None] & rx_ok[:, None, :]),
                      acc * mul, 0.0)
    return _pad_to_res_cm(out, wp, hp, step)


def block_diff_map_dyn(xyb0, xyb1, w, h, step=3):
    """-> channel-major (dc, ac) maps [3, B, RY, RX]: by the window-major
    form (JAX block_diff_map_dyn's CPU branch), or under
    GUETZLI_TPU_LANE_SAFE=1 the lane-major one (its accelerator branch:
    the windows' blocks in the lanes of tiles_lanes.block_diff_lanes,
    fixed-order sums, another rounding than the DFT matmuls)."""
    from guetzli_tpu_torch.ops.layout import lane_safe
    hp, wp = xyb0.shape[-2:]
    dev = xyb0.device
    nb = w.shape[0]
    rx, rx_ok = _res_positions_dyn(wp, w, step, 8 - step - 1)
    ry, ry_ok = _res_positions_dyn(hp, h, step, 8 - step - 1)
    px = torch.minimum(rx[None], w[:, None] - 8).clamp(min=0)
    py = torch.minimum(ry[None], h[:, None] - 8).clamp(min=0)
    ny, nx = len(ry), len(rx)
    e8 = torch.arange(8, device=dev)
    ok = (ry_ok[:, :, None] & rx_ok[:, None, :])
    if lane_safe():
        from guetzli_tpu_torch.ops import tiles_lanes as tl
        # Rows dy-major, columns dx-major: the window split is a reshape.
        ty = (e8[None, :, None] + py[:, None, :]).reshape(nb, 8 * ny)
        tx = (e8[None, :, None] + px[:, None, :]).reshape(nb, 8 * nx)
        both = _select_yx(torch.cat([xyb0, xyb1]), ty, tx)
        both = both.reshape(6, nb, 8, ny, 8, nx).permute(0, 2, 4, 1, 3, 5)
        both = both.reshape(6, 8, 8, nb * ny * nx)         # [6, y, x, N]
        dc, ac, _edge = tl.block_diff_lanes(both[0:3], both[3:6])
        dc = torch.where(ok, dc.reshape(3, nb, ny, nx), 0.0)
        ac = torch.where(ok, ac.reshape(3, nb, ny, nx), 0.0)
        return (_pad_to_res_cm(dc, wp, hp, step),
                _pad_to_res_cm(ac, wp, hp, step))
    ty = (py[:, :, None] + e8).reshape(nb, ny * 8)
    tx = (px[:, :, None] + e8).reshape(nb, nx * 8)
    both = _select_yx(torch.cat([xyb0, xyb1]), ty, tx)    # [6, B, 8ny, 8nx]
    both = both.reshape(6, nb, ny, 8, nx, 8).permute(1, 2, 4, 0, 3, 5)
    w0 = both[:, :, :, 0:3].reshape(nb, ny, nx, 3, 64)
    w1 = both[:, :, :, 3:6].reshape(nb, ny, nx, 3, 64)
    dc, ac, _edge = bd.block_diff(w0, w1, trials=True)     # [B, ny, nx, 3]
    dc = torch.where(ok, dc.movedim(-1, 0), 0.0)
    ac = torch.where(ok, ac.movedim(-1, 0), 0.0)
    return _pad_to_res_cm(dc, wp, hp, step), _pad_to_res_cm(ac, wp, hp, step)


def edge_detector_low_freq_dyn(xyb0, xyb1, ac_map, w, h, sc, step=3):
    """Adds into the channel-major ac_map [3, B, RY, RX] at x-offset
    8//step."""
    hp, wp = xyb0.shape[-2:]
    vm = _vmask(hp, wp, w, h)
    both = blur_dyn(torch.stack([xyb0 * vm, xyb1 * vm]),
                    consts.EDGE_LF_SIGMA, *sc["edlf"])
    e = both[1] - both[0]
    ys, ys_ok = _res_positions_dyn(hp, h, step, 8)
    xs, xs_ok = _res_positions_dyn(wp, w, step, 8)

    def shifted(dy, dx):
        return e[..., (ys + dy)[:, None], (xs + dx)[None, :]]

    base = shifted(0, 0)
    diffs = [base - shifted(0, 8), base - shifted(8, 0),
             base - shifted(6, 6)]
    # Direction 3 reaches x-6; zero where x < 8.
    far = base - e[..., (ys + 6)[:, None], (xs - 6).clamp(min=0)[None, :]]
    diffs.append(torch.where((xs < 8)[None, None, None, :],
                             torch.zeros_like(base), far))
    per_k = [torch.stack(bd.xyb_diff_low_freq_squared(d[0], d[1], d[2]))
             for d in diffs]
    md = torch.maximum(torch.maximum(per_k[0], per_k[1]),
                       torch.maximum(per_k[2], per_k[3]))
    add = torch.where(ys_ok[:, :, None] & xs_ok[:, None, :],
                      md * float(_F32(consts.EDGE_LF_MUL)), 0.0)
    off = 8 // step
    pad_y = ac_map.shape[-2] - add.shape[-2]
    pad_x = ac_map.shape[-1] - add.shape[-1] - off
    return ac_map + F.pad(add, (off, pad_x, 0, pad_y))


def diff_precompute_dyn(xyb0, xyb1, w, h):
    """-> [3, B, Hp, Wp]; the neighbor at x+1 is x-1 on each image's own
    right border, likewise y+1 at the bottom."""
    hp, wp = xyb0.shape[-2:]
    dev = xyb0.device
    at_right = (torch.arange(wp, device=dev)[None, :] + 1
                == w[:, None])[:, None, :]                   # [B, 1, Wp]
    at_bottom = (torch.arange(hp, device=dev)[None, :] + 1
                 == h[:, None])[:, :, None]                  # [B, Hp, 1]

    def vals(d):
        return torch.stack([
            bd.color_diff_dx_hf(d[0] * float(_F32(consts.XYB_HF_XMUL))),
            bd.color_diff_dy_hf(d[1] * float(_F32(consts.XYB_HF_YMUL))),
            d[2] * float(_F32(consts.XYB_HF_ZMUL))])

    def sup(img):
        right = torch.where(at_right, torch.roll(img, 1, -1),
                            torch.roll(img, -1, -1))
        down = torch.where(at_bottom, torch.roll(img, 1, -2),
                           torch.roll(img, -1, -2))
        return vals(img - right).abs() + vals(img - down).abs()

    return torch.minimum(sup(xyb0), sup(xyb1))


def mask_dyn(xyb0, xyb1, w, h, sc):
    """-> (mask, mask_dc) each [3, B, Hp, Wp]."""
    hp, wp = xyb0.shape[-2:]
    vm = _vmask(hp, wp, w, h)
    m = torch.where(vm, diff_precompute_dyn(xyb0, xyb1, w, h), 0.0)
    chans = []
    for c in range(3):
        mc = torch.where(vm, average5x5(m[c]), float("inf"))
        mc = torch.where(vm, min_square_val(mc, 4, 0), 0.0)
        chans.append(blur_dyn(mc, consts.MASK_SIGMAS[c], *sc["mask%d" % c]))
    p = torch.stack(chans) * devconst.array(_MASK_W, xyb0.device)[
        :, None, None, None]
    g2 = float(_F32(consts.K_GLOBAL_SCALE * consts.K_GLOBAL_SCALE))
    mask_out = torch.stack([bd.mask_lut("x", p[0]), bd.mask_lut("y", p[1]),
                            bd.mask_lut("b", p[2])]) * g2
    mask_dc = torch.stack([bd.mask_lut("dc_x", p[0]),
                           bd.mask_lut("dc_y", p[1]),
                           bd.mask_lut("dc_b", p[2])]) * g2
    return mask_out, mask_dc


def combine_channels_dyn(mask_xyb, mask_dc, dc_map, ac_map, edge_map, w, h,
                         hp, wp, step=3):
    """Channel-major maps [3, B, RY, RX] -> res-grid diffmap [B, ny, nx]."""
    ry, ry_ok = _res_positions_dyn(hp, h, step, 8 - step)
    rx, rx_ok = _res_positions_dyn(wp, w, step, 8 - step)
    iy, ix = (ry + 3)[:, None], (rx + 3)[None, :]
    msel = mask_xyb[..., iy, ix]
    dsel = mask_dc[..., iy, ix]
    ny, nx = len(ry), len(rx)
    dc = dc_map[..., :ny, :nx]
    ac = ac_map[..., :ny, :nx]
    em = edge_map[..., :ny, :nx]
    res = (dc * dsel).sum(0) + (ac * msel).sum(0) + (em * msel).sum(0)
    return torch.where(ry_ok[:, :, None] & rx_ok[:, None, :], res, 0.0)


def calculate_diffmap_dyn(res_map, w, h, sc, hp, wp, step=3):
    """[B, ny, nx] -> [B, Hp, Wp], zero outside each valid region."""
    s2 = (8 - step) // 2
    s = 8 - step
    slope = _F32(consts.DIFFMAP_INITIAL_SLOPE)
    val = torch.where(res_map < float(_F32(1.0) / (slope * slope)),
                      float(slope) * res_map, sqrt(res_map))
    up = val.repeat_interleave(step, -2).repeat_interleave(step, -1)
    # At offset (s2, s2) in an [Hp, Wp] canvas, masked to the valid region.
    up = F.pad(up, (s2, max(0, wp - s2 - up.shape[-1]),
                    s2, max(0, hp - s2 - up.shape[-2])))[:, :hp, :wp]
    dm = torch.where(_vmask(hp, wp, w, h), up, 0.0)
    # The clustered blur of the inner (w-s, h-s) region, moved to the
    # origin so the strided blur's grid is the exact path's.
    inner_ok = _vmask(hp, wp, w - s, h - s)
    inner = torch.where(inner_ok, F.pad(dm[:, s2:, s2:], (0, s2, 0, s2)),
                        0.0)
    blurred = blur_dyn(inner, consts.DIFFMAP_SIGMA, *sc["diffmap"])
    add = torch.where(inner_ok,
                      float(_F32(consts.DIFFMAP_MUL1)) * blurred, 0.0)
    dm = dm + F.pad(add, (s2, 0, s2, 0))[:, :hp, :wp]
    return dm * float(_F32(1.0 / (1.0 + consts.DIFFMAP_MUL1)))


def diffmap_opsin_dynamics_dyn(xyb0, xyb1, w, h, sc, step=3):
    """Padded full metric: opsin images [3, B, Hp, Wp] with true sizes w, h
    [B] -> diffmaps [B, Hp, Wp], zero outside each valid region. Needs
    min(w, h) >= 8 (images under 32 pixels skip the comparator)."""
    hp, wp = xyb0.shape[-2:]
    xyb0m, xyb1m = mask_high_intensity_change_dyn(xyb0, xyb1, w, h)
    edge_map = edge_detector_map_dyn(xyb0m, xyb1m, w, h, sc, step)
    dc_map, ac_map = block_diff_map_dyn(xyb0m, xyb1m, w, h, step)
    ac_map = edge_detector_low_freq_dyn(xyb0m, xyb1m, ac_map, w, h, sc,
                                        step)
    mask_xyb, mask_dc = mask_dyn(xyb0m, xyb1m, w, h, sc)
    res = combine_channels_dyn(mask_xyb, mask_dc, dc_map, ac_map, edge_map,
                               w, h, hp, wp, step)
    return calculate_diffmap_dyn(res, w, h, sc, hp, wp, step)
