"""The check's lower-precision control: the reference's butteraugli with
its contractions in TF32.

TF32 is the precision next below the configuration's float32 (TF32 off):
an NVIDIA tensor-core float32 contraction rounds its inputs to 10
mantissa bits and accumulates in float32. Here every contraction of
h100bench/reference/butteraugli64.py -- the blurs' tap products, the
opsin and XYB mixing matrices and the 8x8 DFT (as real matrix products)
-- rounds its operands so, and accumulates in float32; every other
operation keeps the reference's float64, which makes this control no
less accurate than the same pipeline run in TF32 mode on the card.

`distance(rgb0, rgb1)` stands in for the distance the program reports;
the check's number `dist_gap` then reads how far a TF32 comparator's
claim lies from the float64 reference's. The benchmark's own runs never
compute it (h100bench/control.py does).
"""

import contextlib

import numpy as np

from h100bench.reference import butteraugli64 as ba
from h100bench.reference import consts64


def round_tf32(a):
    """float32 values rounded to TF32 (10 explicit mantissa bits, round
    to nearest, ties away from zero), as float32."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def _mm(a, b):
    """a @ b with TF32 operands and float32 accumulation."""
    return round_tf32(a) @ round_tf32(b)


def blur(channel, sigma, border_ratio=0.0):
    """butteraugli64.blur with its tap products in TF32."""
    channel = np.asarray(channel, dtype=np.float64)
    h, w = channel.shape
    diff = max(1, int(2.25 * abs(sigma)))
    scaler = -1.0 / (2.0 * sigma * sigma)
    idx = np.arange(-diff, diff + 1, dtype=np.float64)
    taps = np.exp(scaler * idx * idx).astype(np.float32).astype(np.float64)
    step = max(1, int(sigma / 3.0))
    full = taps.sum()

    def conv_rows(x, size):
        n_out = -(-size // step)
        out = np.zeros((x.shape[0], n_out), dtype=np.float64)
        for ox in range(n_out):
            p = ox * step
            lo = max(0, p - diff)
            hi = min(size - 1, p + diff)
            t = taps[lo - p + diff:hi - p + diff + 1]
            weight = (1.0 - border_ratio) * t.sum() + border_ratio * full
            out[:, ox] = _mm(x[:, lo:hi + 1], t) / weight
        return out

    t = conv_rows(channel, w)
    t = conv_rows(t.T, h).T
    if step > 1:
        t = np.repeat(np.repeat(t, step, axis=0), step, axis=1)[:h, :w]
    return t


def _mix(m, v):
    """tensordot(m, v, axes=(1, 0)) in TF32."""
    flat = np.asarray(v, dtype=np.float64).reshape(v.shape[0], -1)
    return _mm(m, flat).astype(np.float64).reshape((m.shape[0],)
                                                   + v.shape[1:])


def opsin_absorbance(rgb):
    b = np.asarray(consts64.OPSIN_BIAS, dtype=np.float64)
    return _mix(np.asarray(consts64.OPSIN_MIX), rgb) + b.reshape(
        (3,) + (1,) * (rgb.ndim - 1))


def rgb_to_xyb(mixed):
    return _mix(np.asarray(consts64.RGB_TO_XYB), mixed)


_K = np.arange(8)
_COS = np.cos(2 * np.pi * np.outer(_K, _K) / 8)
_SIN = np.sin(2 * np.pi * np.outer(_K, _K) / 8)


def fft8x8_squared(blocks):
    """butteraugli64.fft8x8_squared with the 2-D DFT as TF32 matrix
    products: X^T's transform (C - iS) X^T (C - iS)."""
    x = np.swapaxes(np.asarray(blocks, dtype=np.float64), -1, -2)
    cx = _mm(_COS, x)
    sx = _mm(_SIN, x)
    re = _mm(cx, _COS) - _mm(sx, _SIN)
    im = -(_mm(sx, _COS) + _mm(cx, _SIN))
    sq = (re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2)
    return sq.reshape(sq.shape[:-2] + (64,)) * consts64.FFT_GLOBAL_MUL


@contextlib.contextmanager
def _tf32_contractions():
    names = ("blur", "opsin_absorbance", "rgb_to_xyb", "fft8x8_squared")
    old = {n: getattr(ba, n) for n in names}
    for n in names:
        setattr(ba, n, globals()[n])
    try:
        yield
    finally:
        for n, f in old.items():
            setattr(ba, n, f)


def distance(rgb0, rgb1):
    """The reference's distance of uint8 [h, w, 3] images with every
    contraction in TF32."""
    from h100bench.reference import distance as ref
    with _tf32_contractions():
        return ref.distance(rgb0, rgb1)
