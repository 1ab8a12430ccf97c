"""Batched 8x8 butteraugli block difference (butteraugli.cc:352-684).

Per 8x8 block pair: DC/edge average differences mapped through a
low-frequency psychovisual distance, and an AC difference from the squared
magnitudes of 2-D 8-point real DFTs weighted by a contrast sensitivity
matrix. Every step is batched over leading block axes; the DFTs are 8x8
matrix products.

The LUT reads use the closed forms of the JAX package's default
(``GUETZLI_TPU_EXACT_LUT`` unset): piecewise-linear progressions and the
smooth masking rational, evaluated directly. Under
``GUETZLI_TPU_EXACT_LUT=1`` they read the reference's tables
(``interpolate``), a different function in the last bits: the
progressions differ from their tables on 20-40% of inputs, the masking
rational on nearly all.
"""

import numpy as np
import torch

from guetzli_tpu_torch import config, consts
from guetzli_tpu_torch.ops.fp import div, sqrt

# 8-point DFT matrix, split into real and imaginary parts.
_u = np.arange(8)
_W = np.exp(-2j * np.pi * np.outer(_u, _u) / 8.0)
DFT8_RE = np.ascontiguousarray(_W.real.astype(np.float32))
DFT8_IM = np.ascontiguousarray(_W.imag.astype(np.float32))

_F32 = np.float32


def pw_progression_params(off, inc):
    """(off, inc, cap) as float32 for pw_progression; cap is the last
    table entry, off + 19 * inc (or 20 * inc when off is 0)."""
    off = _F32(off)
    inc = _F32(inc)
    cap = off + _F32(19.0) * inc if off else _F32(20.0) * inc
    return float(off), float(inc), float(cap)


HF_DY = pw_progression_params(1.4103373714040413, 0.7084088867024)
HF_DX = pw_progression_params(11.38708334481672, 14.550189611520716)
LF_DY = pw_progression_params(0.0, 5.2511644570349185)


_TABLES = {}


def table_on(lut, device):
    """consts table `lut` (a module-level array) as float32 on `device`,
    made once."""
    key = (id(lut), str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(np.asarray(lut, dtype=np.float32),
                                       device=device)
    return _TABLES[key]


def interpolate(lut, s):
    """Odd (sign-preserving) piecewise-linear read of table `lut`
    (butteraugli.cc:249-263; JAX ops/blockdiff.interpolate) at s: the two
    entries around |s| by gather, then l0 + frac * (l1 - l0) in JAX's
    order, the last entry from n - 1 on. JAX reads the entries by a
    one-hot contraction, one 1.0 * value term each, so the gather gives
    its bits."""
    table = table_on(lut, s.device)
    n = table.shape[0]
    ix = s.abs()
    # Clamped in float first: a float past int32's range converts to an
    # undefined int; NaN converts to some int that the clamp takes to 0.
    base = ix.clamp(max=float(n - 1)).to(torch.int32).clamp(0, n - 1)
    safe = base.clamp(max=n - 2).long()
    frac = ix - base.to(ix.dtype)
    l0 = table[safe]
    l1 = table[safe + 1]
    res = l0 + frac * (l1 - l0)
    res = torch.where(base >= n - 1, table[n - 1], res)
    return torch.where(s < 0, -res, res)


def interpolate_clamp_negative(lut, s):
    """interpolate() with inputs below zero clamped (butteraugli.cc:265)."""
    return interpolate(lut, s.clamp(min=0.0))


def _exact(exact_lut):
    return config.exact_lut() if exact_lut is None else exact_lut


def pw_progression(params, s):
    """Odd piecewise-linear read of a 21-entry arithmetic-progression LUT
    (consts._cumulative_lut), in closed form."""
    off, inc, cap = params
    ix = s.abs()
    if off:
        res = torch.where(ix < 1.0, ix * off,
                          torch.minimum(off + (ix - 1.0) * inc,
                                        torch.full_like(ix, cap)))
    else:
        res = torch.minimum(ix * inc, torch.full_like(ix, cap))
    return torch.where(s < 0, -res, res)


# exact_lut: None follows GUETZLI_TPU_EXACT_LUT; False and True choose
# the closed form and the table (kernel C's plain version keeps the
# closed forms whatever the knob says, as the JAX kernel does).

def color_diff_dy_hf(s, exact_lut=None):
    """HF_COLOR_DIFF_DY read (butteraugli.cc:200-211)."""
    if _exact(exact_lut):
        return interpolate(consts.HF_COLOR_DIFF_DY, s)
    return pw_progression(HF_DY, s)


def color_diff_dx_hf(s, exact_lut=None):
    """HF_COLOR_DIFF_DX read (butteraugli.cc:213-224)."""
    if _exact(exact_lut):
        return interpolate(consts.HF_COLOR_DIFF_DX, s)
    return pw_progression(HF_DX, s)


def color_diff_dy_lf(s, exact_lut=None):
    """LF_COLOR_DIFF_DY read (butteraugli.cc:236-247)."""
    if _exact(exact_lut):
        return interpolate(consts.LF_COLOR_DIFF_DY, s)
    return pw_progression(LF_DY, s)


def mask_lut(key, s, exact_lut=None):
    """Masking LUT read (butteraugli.cc:1242-1254, Mask :1495-1567) in
    the closed form of the sampled rational
    ``(1 + extmul * (mul / (0.01 * scaler * i + offset) + extoff))^2``,
    or under the knob the 512-entry table."""
    if _exact(exact_lut):
        return interpolate_clamp_negative(consts.MASK_LUTS[key], s)
    extmul, extoff, mul, offset, scaler = (
        _F32(v) for v in consts.MASK_LUT_PARAMS[key])
    ix = s.clamp(0.0, 511.0)
    c = div(float(mul), ix * float(_F32(0.01) * scaler) + float(offset))
    v = 1.0 + float(extmul) * (c + float(extoff))
    return v * v


def xyb_low_freq_to_vals(x, y, z, exact_lut=None):
    """butteraugli.cc:305-315."""
    z = z + float(_F32(consts.XYB_LF_Y_TO_Z)) * y
    valz = z * float(_F32(consts.XYB_LF_ZMUL))
    valx = x * float(_F32(consts.XYB_LF_XMUL))
    valy = color_diff_dy_lf(y * float(_F32(consts.XYB_LF_YMUL)), exact_lut)
    return valx, valy, valz


def xyb_diff_low_freq_squared(x, y, z, exact_lut=None):
    """XybDiffLowFreqSquaredAccumulate against (0,0,0), factor 1."""
    vx, vy, vz = xyb_low_freq_to_vals(x, y, z, exact_lut)
    return vx * vx, vy * vy, vz * vz


def remove_range_around_zero(v, rng):
    """butteraugli.cc:317-326."""
    return torch.where((v >= -rng) & (v < rng), torch.zeros_like(v),
                       torch.where(v < 0, v + rng, v - rng))


def fft8x8_squared(blocks):
    """|2-D DFT|^2 of real [..., 8, 8] blocks, flattened [xfreq*8 + yfreq]
    with the global 0.000064 scale (ButteraugliFFTSquared,
    butteraugli.cc:574-597)."""
    wr = torch.as_tensor(DFT8_RE, device=blocks.device)
    wi = torch.as_tensor(DFT8_IM, device=blocks.device)
    a = blocks.transpose(-1, -2)                  # [..., x, y]
    t1r = torch.matmul(wr, a)                     # [..., u, y]
    t1i = torch.matmul(wi, a)
    gr = torch.matmul(t1r, wr.T) - torch.matmul(t1i, wi.T)
    gi = torch.matmul(t1r, wi.T) + torch.matmul(t1i, wr.T)
    sq = gr * gr + gi * gi
    return sq.reshape(sq.shape[:-2] + (64,)) \
        * float(_F32(consts.FFT_GLOBAL_MUL))


def block_diff(b0, b1, trials=False):
    """Batched ButteraugliBlockDiff (butteraugli.cc:602-684).

    b0, b1: [..., 3, 64] XYB blocks (row-major y*8+x pixels).
    Returns (diff_dc, diff_ac, diff_edge_dc), each [..., 3]. With
    ``trials``, axis 0 holds independent trials and the DFTs' matrix
    products run once per trial, each with the shape of a one-trial call
    (a GEMM's algorithm may depend on its row count)."""
    csf = torch.as_tensor(consts.CSF8X8.astype(np.float32), device=b0.device)
    csf0 = float(_F32(consts.CSF8X8[0]))
    diff = b0 - b1
    d2 = diff.reshape(diff.shape[:-1] + (8, 8))

    avg = diff.mean(dim=-1)
    dcx, dcy, dcz = xyb_diff_low_freq_squared(
        avg[..., 0], avg[..., 1], avg[..., 2])
    diff_dc = torch.stack([dcx, dcy, dcz], dim=-1) * csf0

    # Four edge means (left, top, right, bottom); corners count twice.
    edges = torch.stack([
        d2[..., :, 0].mean(dim=-1),
        d2[..., 0, :].mean(dim=-1),
        d2[..., :, 7].mean(dim=-1),
        d2[..., 7, :].mean(dim=-1),
    ], dim=-1)                                    # [..., 3, 4]
    ex, ey, ez = xyb_diff_low_freq_squared(
        edges[..., 0, :], edges[..., 1, :], edges[..., 2, :])
    diff_edge = torch.stack([ex.sum(-1), ey.sum(-1), ez.sum(-1)],
                            dim=-1) * csf0

    bavg = (b0 + b1) * 0.5
    bhd = (b0 - b1) * 0.5
    lead = bavg.shape[:-2]
    parts = [bavg[..., 1, :], bhd[..., 0, :], bhd[..., 1, :],
             bhd[..., 2, :]]
    if trials:
        quad = torch.stack(parts, 1).reshape(
            lead[:1] + (4,) + lead[1:] + (8, 8))
        ffts = torch.stack([fft8x8_squared(q) for q in quad])
    else:
        ffts = fft8x8_squared(torch.stack(parts).reshape(
            (4,) + lead + (8, 8)))
    y_avg, x_hd, y_hd, z_hd = ffts.unbind(1 if trials else 0)

    sel = slice(4, 37)
    d = csf[sel]
    ac_x = (d * x_hd[..., sel]).sum(-1) * float(
        _F32(consts.BLOCKDIFF_AC_XMUL))
    ac_z = (d * z_hd[..., sel]).sum(-1) * float(
        _F32(consts.BLOCKDIFF_AC_ZMUL))

    rng = float(_F32(consts.BLOCKDIFF_Y_LIMIT))
    ya = sqrt(y_avg[..., sel])
    yh = sqrt(y_hd[..., sel])
    y0 = remove_range_around_zero(ya - yh, rng)
    y1 = remove_range_around_zero(ya + yh, rng)
    ymul2 = float(_F32(consts.BLOCKDIFF_AC_YMUL2))
    valy = float(_F32(consts.BLOCKDIFF_AC_YMUL)) * (
        color_diff_dy_hf(y0 * ymul2) - color_diff_dy_hf(y1 * ymul2))
    ac_y = (d * valy * valy).sum(-1)
    return diff_dc, torch.stack([ac_x, ac_y, ac_z], dim=-1), diff_edge
