"""Float64 NumPy butteraugli: the plain reference's metric.

Frozen copy of guetzli_tpu_torch/ops/numpy_ref.py as of commit bfd8995
(itself a copy of guetzli_tpu/ops/numpy_ref.py), with its constants
taken from h100bench/reference/consts64.py instead of the program's.
Each function mirrors the corresponding butteraugli.cc stage in double
precision, written against the C++ semantics (citations inline): np.fft
instead of DFT matmuls, explicit index arithmetic instead of
convolutions.

Everything is plain NumPy, and nothing of the program is imported.
"""

import numpy as np

from h100bench.reference import consts64 as consts


# ---------------------------------------------------------------------------
# Gaussian blur (butteraugli.cc:68-155)

def blur(channel, sigma, border_ratio=0.0):
    """_Blur with border reweighting and the sigma>=3 step subsample."""
    channel = np.asarray(channel, dtype=np.float64)
    h, w = channel.shape
    m = 2.25
    diff = max(1, int(m * abs(sigma)))
    scaler = -1.0 / (2.0 * sigma * sigma)
    idx = np.arange(-diff, diff + 1, dtype=np.float64)
    # The reference stores the kernel as float (butteraugli.cc:104).
    taps = np.exp(scaler * idx * idx).astype(np.float32).astype(np.float64)
    step = max(1, int(sigma / 3.0))
    full = taps.sum()

    def conv_rows(x, size):
        """Correlate each row at positions 0, step, ... with border
        renormalization (_Convolution, butteraugli.cc:68-98)."""
        n_out = -(-size // step)
        out = np.zeros((x.shape[0], n_out), dtype=np.float64)
        for ox in range(n_out):
            p = ox * step
            lo = max(0, p - diff)
            hi = min(size - 1, p + diff)
            t = taps[lo - p + diff:hi - p + diff + 1]
            weight = (1.0 - border_ratio) * t.sum() + border_ratio * full
            out[:, ox] = x[:, lo:hi + 1] @ t / weight
        return out

    t = conv_rows(channel, w)              # [h, dw]
    t = conv_rows(t.T, h).T                # [dh', dw] -> transpose back
    if step > 1:
        t = np.repeat(np.repeat(t, step, axis=0), step, axis=1)
        t = t[:h, :w]
    return t


def blur_planes(planes, sigma, border_ratio=0.0):
    return np.stack([blur(p, sigma, border_ratio) for p in planes])


# ---------------------------------------------------------------------------
# Opsin dynamics (butteraugli.cc:741-974)

def _clenshaw(x, coeffs):
    """butteraugli.cc:869-896."""
    b1 = np.zeros_like(x)
    b2 = np.zeros_like(x)
    for c in coeffs[:0:-1]:
        t = (x * b1) * 2.0 - b2 + c
        b2 = b1
        b1 = t
    return x * b1 - b2 + coeffs[0]


def gamma(v):
    """butteraugli.cc:923-941."""
    x01 = (v - consts.GAMMA_MIN_VALUE) / (
        consts.GAMMA_MAX_VALUE - consts.GAMMA_MIN_VALUE)
    xc = 2.0 * x01 - 1.0
    return _clenshaw(xc, consts.GAMMA_P) / _clenshaw(xc, consts.GAMMA_Q)


def opsin_absorbance(rgb):
    """butteraugli.cc:741-764; rgb [3, ...]."""
    m = np.asarray(consts.OPSIN_MIX, dtype=np.float64)
    b = np.asarray(consts.OPSIN_BIAS, dtype=np.float64)
    return np.tensordot(m, rgb, axes=(1, 0)) + b.reshape(
        (3,) + (1,) * (rgb.ndim - 1))


def rgb_to_xyb(mixed):
    """butteraugli.cc:283-292."""
    m = np.asarray(consts.RGB_TO_XYB, dtype=np.float64)
    return np.tensordot(m, mixed, axes=(1, 0))


def opsin_dynamics_image(rgb_linear):
    """_OpsinDynamicsImage (butteraugli.cc:943-974); [3, H, W] in/out."""
    blurred = np.stack([blur(c, consts.OPSIN_SIGMA, 0.0)
                        for c in np.asarray(rgb_linear, dtype=np.float64)])
    return _opsin_from_blurred(rgb_linear, blurred)


def _opsin_from_blurred(rgb, blurred):
    pre = opsin_absorbance(np.asarray(blurred, dtype=np.float64))
    sens = gamma(pre) / pre
    cur = opsin_absorbance(np.asarray(rgb, dtype=np.float64)) * sens
    return rgb_to_xyb(cur)


def opsin_dynamics_blocks(tiles):
    """Per-8x8-tile opsin, blur confined to the tile (SwitchBlock path,
    butteraugli_comparator.cc:85-111). tiles: [..., 3, 8, 8]."""
    tiles = np.asarray(tiles, dtype=np.float64)
    flat = tiles.reshape(-1, 8, 8)
    blurred = np.stack([blur(t, consts.OPSIN_SIGMA, 0.0) for t in flat])
    blurred = blurred.reshape(tiles.shape)
    # _opsin_from_blurred wants channel-first; tiles carry channel at -3.
    cf = np.moveaxis(tiles, -3, 0)
    out = _opsin_from_blurred(cf, np.moveaxis(blurred, -3, 0))
    return np.moveaxis(out, 0, -3)


# ---------------------------------------------------------------------------
# LUT interpolation (butteraugli.cc:249-265)

def interpolate(lut, s):
    lut = np.asarray(lut, dtype=np.float64)
    n = lut.shape[0]
    s = np.asarray(s, dtype=np.float64)
    ix = np.abs(s)
    base = np.clip(ix.astype(np.int64), 0, n - 1)
    safe = np.minimum(base, n - 2)
    frac = ix - base
    res = lut[safe] + frac * (lut[safe + 1] - lut[safe])
    res = np.where(base >= n - 1, lut[n - 1], res)
    return np.where(s < 0, -res, res)


def interpolate_clamp_negative(lut, s):
    return interpolate(lut, np.maximum(np.asarray(s, dtype=np.float64), 0.0))


# ---------------------------------------------------------------------------
# MaskHighIntensityChange (butteraugli.cc:791-843)

def mask_high_intensity_change(xyb0, xyb1):
    xyb0 = np.asarray(xyb0, dtype=np.float64)
    xyb1 = np.asarray(xyb1, dtype=np.float64)
    ave = (xyb0 + xyb1) * 0.5
    y = ave[1]
    h, w = y.shape
    sqr_max = np.full((h, w), -1.0)
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
        d = np.full((h, w), -np.inf)
        ys0, ys1 = max(0, -dy), min(h, h - dy)
        xs0, xs1 = max(0, -dx), min(w, w - dx)
        d[ys0:ys1, xs0:xs1] = (y[ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
                               - y[ys0:ys1, xs0:xs1]) ** 2
        sqr_max = np.maximum(sqr_max, np.where(np.isfinite(d), d, -1.0))
    red = np.asarray(consts.MHIC_REDUCTION, dtype=np.float64)
    chroma_scale = consts.MHIC_CHROMA_BALANCE / (
        y + consts.MHIC_CHROMA_BALANCE)
    mix = np.stack([
        chroma_scale * red[0] / (sqr_max + red[0]),
        red[1] / (sqr_max + red[1]),
        chroma_scale * red[2] / (sqr_max + red[2]),
    ])
    return mix * xyb0 + (1.0 - mix) * ave, mix * xyb1 + (1.0 - mix) * ave


# ---------------------------------------------------------------------------
# Block diff (butteraugli.cc:352-684), FFT via np.fft

def xyb_low_freq_to_vals(x, y, z):
    """butteraugli.cc:305-315."""
    z = z + consts.XYB_LF_Y_TO_Z * np.asarray(y, dtype=np.float64)
    valz = z * consts.XYB_LF_ZMUL
    valx = np.asarray(x, dtype=np.float64) * consts.XYB_LF_XMUL
    valy = interpolate(consts.LF_COLOR_DIFF_DY, y * consts.XYB_LF_YMUL)
    return valx, valy, valz


def xyb_diff_low_freq_squared(x, y, z):
    vx, vy, vz = xyb_low_freq_to_vals(x, y, z)
    return vx * vx, vy * vy, vz * vz


def fft8x8_squared(blocks):
    """|2-D DFT|^2 of [..., 8, 8] blocks -> [..., 64] with frequency along
    image x as the slow axis (ButteraugliFFTSquared, butteraugli.cc:574-597).
    """
    blocks = np.asarray(blocks, dtype=np.float64)
    g = np.fft.fft2(np.swapaxes(blocks, -1, -2))    # [..., xfreq, yfreq]
    sq = (g.real ** 2 + g.imag ** 2)
    return sq.reshape(sq.shape[:-2] + (64,)) * consts.FFT_GLOBAL_MUL


def _remove_range_around_zero(v, rng):
    """butteraugli.cc:317-326."""
    return np.where((v >= -rng) & (v < rng), 0.0,
                    np.where(v < 0, v + rng, v - rng))


def block_diff(b0, b1):
    """ButteraugliBlockDiff (butteraugli.cc:602-684).

    b0, b1: [..., 3, 64] -> (dc, ac, edge_dc), each [..., 3].
    """
    b0 = np.asarray(b0, dtype=np.float64)
    b1 = np.asarray(b1, dtype=np.float64)
    csf = np.asarray(consts.CSF8X8, dtype=np.float64)
    diff = b0 - b1
    d2 = diff.reshape(diff.shape[:-1] + (8, 8))

    avg = diff.mean(axis=-1)
    dcx, dcy, dcz = xyb_diff_low_freq_squared(
        avg[..., 0], avg[..., 1], avg[..., 2])
    diff_dc = np.stack([dcx, dcy, dcz], axis=-1) * csf[0]

    edges = np.stack([
        d2[..., :, 0].mean(axis=-1), d2[..., 0, :].mean(axis=-1),
        d2[..., :, 7].mean(axis=-1), d2[..., 7, :].mean(axis=-1),
    ], axis=-1)
    ex, ey, ez = xyb_diff_low_freq_squared(
        edges[..., 0, :], edges[..., 1, :], edges[..., 2, :])
    diff_edge = np.stack([ex.sum(-1), ey.sum(-1), ez.sum(-1)],
                         axis=-1) * csf[0]

    bavg = (b0 + b1) * 0.5
    bhd = (b0 - b1) * 0.5

    def fft_of(chan_blocks):
        return fft8x8_squared(chan_blocks.reshape(
            chan_blocks.shape[:-1] + (8, 8)))

    y_avg = fft_of(bavg[..., 1, :])
    x_hd = fft_of(bhd[..., 0, :])
    y_hd = fft_of(bhd[..., 1, :])
    z_hd = fft_of(bhd[..., 2, :])

    sel = slice(4, 37)
    d = csf[sel]
    ac_x = np.sum(d * x_hd[..., sel], axis=-1) * consts.BLOCKDIFF_AC_XMUL
    ac_z = np.sum(d * z_hd[..., sel], axis=-1) * consts.BLOCKDIFF_AC_ZMUL
    ya = np.sqrt(y_avg[..., sel])
    yh = np.sqrt(y_hd[..., sel])
    y0 = _remove_range_around_zero(ya - yh, consts.BLOCKDIFF_Y_LIMIT)
    y1 = _remove_range_around_zero(ya + yh, consts.BLOCKDIFF_Y_LIMIT)
    valy0 = interpolate(consts.HF_COLOR_DIFF_DY,
                        y0 * consts.BLOCKDIFF_AC_YMUL2)
    valy1 = interpolate(consts.HF_COLOR_DIFF_DY,
                        y1 * consts.BLOCKDIFF_AC_YMUL2)
    valy = consts.BLOCKDIFF_AC_YMUL * (valy0 - valy1)
    ac_y = np.sum(d * valy * valy, axis=-1)

    diff_ac = np.stack([ac_x, ac_y, ac_z], axis=-1)
    return diff_dc, diff_ac, diff_edge


# ---------------------------------------------------------------------------
# Step-grid maps (butteraugli.cc:1081-1231)

def _res_positions(size, step, margin):
    n = (size - margin - 1) // step + 1 if size > margin else 0
    return np.arange(n, dtype=np.int64) * step


def _pad_to_res(m, w, h, step):
    ry, rx = -(-h // step), -(-w // step)
    pads = [(0, ry - m.shape[0]), (0, rx - m.shape[1])]
    pads += [(0, 0)] * (m.ndim - 2)
    return np.pad(m, pads)


def edge_detector_map(xyb0, xyb1, step=3):
    """butteraugli.cc:689-738, 1119-1149 -> [ry, rx, 3]."""
    _, h, w = xyb0.shape
    blurred0 = np.stack([blur(xyb0[c], s, 0.0)
                         for c, s in enumerate(consts.EDGE_DETECTOR_SIGMAS)])
    blurred1 = np.stack([blur(xyb1[c], s, 0.0)
                         for c, s in enumerate(consts.EDGE_DETECTOR_SIGMAS)])
    wgt = consts.EDGE_DETECTOR_W

    def diff_at(b, ys, xs, d):
        """w * (b[p-d] - b[p+d]) per channel at positions (ys, xs)."""
        return wgt * (b[:, ys[0], xs[0]] - b[:, ys[1], xs[1]])

    rx = _res_positions(w, step, 8 - step)
    ry = _res_positions(h, step, 8 - step)
    px = np.minimum(rx, w - 8)
    py = np.minimum(ry, h - 8)
    acc = np.zeros((3, len(py), len(px)))
    cnt = np.zeros((len(py), len(px)))
    for oy, ox in ((0, 0), (7, 0), (0, 7), (7, 7)):
        gy = (py + oy)[:, None] + np.zeros(len(px), dtype=np.int64)[None, :]
        gx = (px + ox)[None, :] + np.zeros(len(py), dtype=np.int64)[:, None]
        h_valid = (gx >= 3) & (gx + 3 < w)
        v_valid = (gy >= 3) & (gy + 3 < h)
        gxs = np.clip(gx, 3, max(w - 4, 3))
        gys = np.clip(gy, 3, max(h - 4, 3))
        for valid, (d0y, d0x, d1y, d1x) in (
                (h_valid, (gy, gxs - 3, gy, gxs + 3)),
                (v_valid, (gys - 3, gx, gys + 3, gx))):
            d0 = wgt * (blurred0[:, d0y, d0x] - blurred0[:, d1y, d1x])
            d1 = wgt * (blurred1[:, d0y, d0x] - blurred1[:, d1y, d1x])
            vx0, vy0, vz0 = xyb_low_freq_to_vals(d0[0], d0[1], d0[2])
            vx1, vy1, vz1 = xyb_low_freq_to_vals(d1[0], d1[1], d1[2])
            sq = np.stack([(vx0 - vx1) ** 2, (vy0 - vy1) ** 2,
                           (vz0 - vz1) ** 2])
            acc += np.where(valid[None], sq, 0.0)
            cnt += valid
    mul = consts.EDGE_DETECTOR_WEIGHT * 8.0 / cnt
    out = np.moveaxis(acc * mul[None], 0, -1)
    return _pad_to_res(out, w, h, step)


def block_diff_map(xyb0, xyb1, step=3):
    """butteraugli.cc:1081-1117 -> (dc, ac) [ry, rx, 3]."""
    _, h, w = xyb0.shape
    rx = _res_positions(w, step, 8 - step - 1)
    ry = _res_positions(h, step, 8 - step - 1)
    px = np.minimum(rx, w - 8)
    py = np.minimum(ry, h - 8)
    yy = py[:, None, None, None] + np.arange(8)[None, None, :, None]
    xx = px[None, :, None, None] + np.arange(8)[None, None, None, :]
    yy, xx = np.broadcast_arrays(yy, xx)
    w0 = np.moveaxis(np.asarray(xyb0, np.float64)[:, yy, xx], 0, 2)
    w1 = np.moveaxis(np.asarray(xyb1, np.float64)[:, yy, xx], 0, 2)
    dc, ac, _edge = block_diff(w0.reshape(len(py), len(px), 3, 64),
                               w1.reshape(len(py), len(px), 3, 64))
    return _pad_to_res(dc, w, h, step), _pad_to_res(ac, w, h, step)


def edge_detector_low_freq(xyb0, xyb1, ac_map, step=3):
    """butteraugli.cc:1151-1205; adds into ac_map at x-offset 8//step."""
    _, h, w = xyb0.shape
    b0 = np.stack([blur(c, consts.EDGE_LF_SIGMA, 0.0) for c in xyb0])
    b1 = np.stack([blur(c, consts.EDGE_LF_SIGMA, 0.0) for c in xyb1])
    e = b1 - b0
    ys = _res_positions(h, step, 8)
    xs = _res_positions(w, step, 8)
    if len(ys) == 0 or len(xs) == 0:
        return ac_map
    base = e[:, ys[:, None], xs[None, :]]
    diffs = [
        base - e[:, ys[:, None], (xs + 8)[None, :]],
        base - e[:, (ys + 8)[:, None], xs[None, :]],
        base - e[:, (ys + 6)[:, None], (xs + 6)[None, :]],
    ]
    safe_xm6 = np.maximum(xs - 6, 0)
    d4 = base - e[:, (ys + 6)[:, None], safe_xm6[None, :]]
    d4 = np.where((xs < 8)[None, None, :], 0.0, d4)
    diffs.append(d4)
    per_k = []
    for d in diffs:
        sx, sy, sz = xyb_diff_low_freq_squared(d[0], d[1], d[2])
        per_k.append(np.stack([sx, sy, sz]))
    md = np.maximum(np.maximum(per_k[0], per_k[1]),
                    np.maximum(per_k[2], per_k[3]))
    add = np.moveaxis(md, 0, -1) * consts.EDGE_LF_MUL
    out = np.array(ac_map, dtype=np.float64, copy=True)
    off = 8 // step
    out[:add.shape[0], off:off + add.shape[1]] += add
    return out


# ---------------------------------------------------------------------------
# Masking (butteraugli.cc:1332-1567)

def diff_precompute(xyb0, xyb1):
    """butteraugli.cc:1440-1493."""
    def sup(img):
        img = np.asarray(img, dtype=np.float64)
        right = np.concatenate([img[:, :, 1:], img[:, :, -2:-1]], axis=2)
        down = np.concatenate([img[:, 1:, :], img[:, -2:-1, :]], axis=1)

        def vals(d):
            vx = interpolate(consts.HF_COLOR_DIFF_DX,
                             d[0] * consts.XYB_HF_XMUL)
            vy = interpolate(consts.HF_COLOR_DIFF_DY,
                             d[1] * consts.XYB_HF_YMUL)
            vz = d[2] * consts.XYB_HF_ZMUL
            return np.stack([vx, vy, vz])

        return np.abs(vals(img - right)) + np.abs(vals(img - down))

    return np.minimum(sup(xyb0), sup(xyb1))


def average5x5(img):
    """butteraugli.cc:1379-1438."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape
    if h < 4 or w < 4:
        return img.copy()
    wgt = consts.AVERAGE5X5_DIAG_W
    pad = np.zeros((h + 2, w + 2))
    pad[1:-1, 1:-1] = img
    out = (pad[1:-1, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:]
           + pad[:-2, 1:-1] + pad[2:, 1:-1]
           + wgt * (pad[:-2, :-2] + pad[:-2, 2:]
                    + pad[2:, :-2] + pad[2:, 2:]))
    return out / (5.0 + 4.0 * wgt)


def min_square_val(img, square=4, offset=0):
    """butteraugli.cc:1332-1376: min over the (clipped) square window."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape
    pad = np.full((h + square - 1, w + square - 1), np.inf)
    pad[offset:offset + h, offset:offset + w] = img
    out = np.full((h, w), np.inf)
    for dy in range(square):
        for dx in range(square):
            out = np.minimum(out, pad[dy:dy + h, dx:dx + w])
    return out


def mask(xyb0, xyb1):
    """butteraugli.cc:1495-1567 -> (mask, mask_dc), each [3, H, W]."""
    m = diff_precompute(xyb0, xyb1)
    chans = []
    for c in range(3):
        mc = average5x5(m[c])
        mc = min_square_val(mc, 4, 0)
        mc = blur(mc, consts.MASK_SIGMAS[c], 0.0)
        chans.append(mc)
    p = np.stack(chans) * np.asarray(consts.MASK_W,
                                     dtype=np.float64)[:, None, None]
    g2 = consts.K_GLOBAL_SCALE * consts.K_GLOBAL_SCALE
    mask_out = np.stack([
        interpolate_clamp_negative(consts.MASK_LUTS['x'], p[0]),
        interpolate_clamp_negative(consts.MASK_LUTS['y'], p[1]),
        interpolate_clamp_negative(consts.MASK_LUTS['b'], p[2]),
    ]) * g2
    mask_dc = np.stack([
        interpolate_clamp_negative(consts.MASK_LUTS['dc_x'], p[0]),
        interpolate_clamp_negative(consts.MASK_LUTS['dc_y'], p[1]),
        interpolate_clamp_negative(consts.MASK_LUTS['dc_b'], p[2]),
    ]) * g2
    return mask_out, mask_dc


# ---------------------------------------------------------------------------
# Assembly (butteraugli.cc:985-1239)

def combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map, h, w,
                     step=3):
    """butteraugli.cc:1207-1231."""
    ry = _res_positions(h, step, 8 - step)
    rx = _res_positions(w, step, 8 - step)
    msel = np.asarray(mask_xyb)[:, ry[:, None] + 3, rx[None, :] + 3]
    dsel = np.asarray(mask_dc)[:, ry[:, None] + 3, rx[None, :] + 3]
    ny, nx = len(ry), len(rx)
    dc = np.asarray(dc_map, dtype=np.float64)[:ny, :nx]
    ac = np.asarray(ac_map, dtype=np.float64)[:ny, :nx]
    em = np.asarray(edge_map, dtype=np.float64)[:ny, :nx]
    return (np.einsum('yxc,cyx->yx', dc, dsel)
            + np.einsum('yxc,cyx->yx', ac, msel)
            + np.einsum('yxc,cyx->yx', em, msel))


def calculate_diffmap(res_map, h, w, step=3):
    """butteraugli.cc:985-1044."""
    res_map = np.asarray(res_map, dtype=np.float64)
    s2 = (8 - step) // 2
    slope = consts.DIFFMAP_INITIAL_SLOPE
    val = np.where(res_map < 1.0 / (slope * slope),
                   slope * res_map, np.sqrt(res_map))
    up = np.repeat(np.repeat(val, step, axis=0), step, axis=1)
    ny, nx = res_map.shape
    dm = np.zeros((h, w))
    dm[s2:s2 + ny * step, s2:s2 + nx * step] = \
        up[:min(ny * step, h - s2), :min(nx * step, w - s2)]
    s = 8 - step
    inner = dm[s2:s2 + h - s, s2:s2 + w - s]
    blurred = blur(inner, consts.DIFFMAP_SIGMA, consts.DIFFMAP_BORDER_RATIO)
    dm[s2:s2 + h - s, s2:s2 + w - s] += consts.DIFFMAP_MUL1 * blurred
    return dm * (1.0 / (1.0 + consts.DIFFMAP_MUL1))


def diffmap_opsin_dynamics(xyb0, xyb1, step=3):
    """Full metric (butteraugli.cc:1046-1079)."""
    _, h, w = np.asarray(xyb0).shape
    if h < 8 or w < 8:
        return np.zeros((h, w))
    m0, m1 = mask_high_intensity_change(xyb0, xyb1)
    edge_map = edge_detector_map(m0, m1, step)
    dc_map, ac_map = block_diff_map(m0, m1, step)
    ac_map = edge_detector_low_freq(m0, m1, ac_map, step)
    mask_xyb, mask_dc = mask(m0, m1)
    res = combine_channels(mask_xyb, mask_dc, dc_map, ac_map, edge_map,
                           h, w, step)
    return calculate_diffmap(res, h, w, step)


def score_from_diffmap(dm):
    """butteraugli.cc:1233-1239."""
    return float(np.max(dm))


# ---------------------------------------------------------------------------
# Per-block compare (the zeroing-order error math,
# butteraugli_comparator.cc:113-163)

def mask_high_intensity_change_tiles(t0, t1):
    """MaskHighIntensityChange confined to 8x8 tiles ([..., 3, 8, 8])."""
    t0 = np.asarray(t0, dtype=np.float64)
    t1 = np.asarray(t1, dtype=np.float64)
    flat0 = t0.reshape(-1, 3, 8, 8)
    flat1 = t1.reshape(-1, 3, 8, 8)
    o0 = np.empty_like(flat0)
    o1 = np.empty_like(flat1)
    for i in range(flat0.shape[0]):
        a, b = mask_high_intensity_change(flat0[i], flat1[i])
        o0[i], o1[i] = a, b
    return o0.reshape(t0.shape), o1.reshape(t1.shape)


def compare_blocks(xyb0_tiles, cand_lin, scale):
    """Batched CompareBlock core: candidate linear-RGB tiles against the
    original's per-block opsin tiles, scaled by the whole-image mask at the
    block corner (butteraugli_comparator.cc:113-163)."""
    xyb1 = opsin_dynamics_blocks(cand_lin)
    m0, m1 = mask_high_intensity_change_tiles(xyb0_tiles, xyb1)
    dc, ac, edge = block_diff(m0.reshape(m0.shape[:-2] + (64,)),
                              m1.reshape(m1.shape[:-2] + (64,)))
    scale = np.asarray(scale, dtype=np.float64)
    diff = np.sum((dc + ac) * scale, axis=-1)
    diff_edge = np.sum(edge * scale, axis=-1)
    w = consts.BLOCK_EDGE_WEIGHT
    return np.sqrt((1.0 - w) * diff + w * diff_edge)
