"""Gaussian blur with Guetzli/butteraugli semantics.

Reproduces the reference blur (butteraugli.cc:68-148) including its two
quirks, which materially affect output parity:

  * border reweighting: each output position is divided by the sum of the
    kernel taps that actually overlapped the image, linearly mixed with the
    full-kernel weight by ``border_ratio``;
  * step subsampling: for sigma >= 3 the convolution is evaluated only at
    every ``int(sigma/3)``-th position in both dimensions and the result is
    nearest-neighbor upsampled back.

The two passes are ``F.conv1d`` over rows with the stride as the step. On
the card that is cuDNN, which must not run in TF32 (device.resolve turns
TF32 off). The nearest upsample's column pass follows
GUETZLI_TPU_LANE_SAFE (``upsample_columns``).
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def gauss_taps(sigma: float):
    """Kernel taps as float32 (reference stores the kernel as float)."""
    m = 2.25
    diff = max(1, int(m * abs(sigma)))
    scaler = -1.0 / (2.0 * sigma * sigma)
    i = np.arange(-diff, diff + 1, dtype=np.float64)
    taps = np.exp(scaler * i * i).astype(np.float32)
    return taps, diff


def blur_step(sigma: float) -> int:
    return max(1, int(sigma / 3.0))


@lru_cache(maxsize=None)
def _border_weights(size: int, sigma: float, border_ratio: float):
    """Per-output-position normalization (butteraugli.cc:76-89)."""
    taps32, offset = gauss_taps(sigma)
    taps = taps32.astype(np.float64)
    step = blur_step(sigma)
    full = taps[:2 * offset + 1].sum()
    n_out = -(-size // step)
    w = np.zeros(n_out, dtype=np.float64)
    for ox in range(n_out):
        x = ox * step
        lo = max(0, x - offset)
        hi = min(size, x + len(taps) - offset) - 1
        w[ox] = taps[lo - x + offset:hi - x + offset + 1].sum()
    w = (1.0 - border_ratio) * w + border_ratio * full
    return (1.0 / w).astype(np.float32)


@lru_cache(maxsize=None)
def _upsample_matrix(dw: int, w: int, step: int):
    """[dw, w] 0/1 matrix: column j reads subsampled position j // step."""
    u = np.zeros((dw, w), dtype=np.float32)
    u[np.minimum(np.arange(w) // step, dw - 1), np.arange(w)] = 1.0
    return u


def upsample_columns(t, step, w):
    """The nearest upsample's column pass [..., dw] -> [..., w]: a
    repeat, or under GUETZLI_TPU_LANE_SAFE=1 the JAX package's
    accelerator form, a matmul with a 0/1 matrix (ops/layout.py). Both
    are exact: each output is one 1.0 * value product (TF32 is off,
    device.resolve)."""
    from guetzli_tpu_torch.ops.layout import lane_safe
    if not lane_safe():
        return t.repeat_interleave(step, dim=-1)[..., :w]
    u = torch.as_tensor(_upsample_matrix(t.shape[-1], w, step),
                        device=t.device)
    return torch.matmul(t, u)


def _conv_rows(x, taps, offset, step):
    """Correlate rows of x [R, C] with taps at positions 0, step, ...;
    out-of-image taps contribute zero. Returns [R, ceil(C / step)]."""
    k = taps.shape[0]
    p = F.pad(x[:, None, :], (offset, k - 1 - offset))
    return F.conv1d(p, taps.view(1, 1, k), stride=step)[:, 0, :]


def _conv_trials(rows, taps, offset, step):
    """_conv_rows of each trial's rows [T, R, C] -> [T, R, C'], one
    convolution per trial: every call has the shape of a one-trial blur,
    so a trial's bits do not depend on how many trials run beside it
    (cuDNN and oneDNN may pick another algorithm for another row
    count)."""
    if rows.shape[0] == 1:
        return _conv_rows(rows[0], taps, offset, step)[None]
    return torch.stack([_conv_rows(r, taps, offset, step) for r in rows])


def blur(channel, sigma: float, border_ratio: float = 0.0,
         trial_axis=None):
    """Blur an image [..., H, W] (leading axes batched).

    Mirrors _Blur (butteraugli.cc:100-148): horizontal pass (with stride),
    vertical pass on the subsampled intermediate, then nearest upsample.
    ``trial_axis`` names a leading axis of independent trials (the
    batched quant compare, comparator.py): each trial's rows are
    convolved in a call of their own, with the bits of a blur of that
    trial alone."""
    dev = channel.device
    x = channel[None] if trial_axis is None else \
        channel.movedim(trial_axis, 0)
    nt = x.shape[0]
    lead = x.shape[1:-2]
    h, w = x.shape[-2:]
    taps, offset = gauss_taps(sigma)
    step = blur_step(sigma)
    jt = torch.as_tensor(taps, device=dev)
    scale_x = torch.as_tensor(_border_weights(w, sigma, border_ratio),
                              device=dev)
    scale_y = torch.as_tensor(_border_weights(h, sigma, border_ratio),
                              device=dev)

    t = _conv_trials(x.reshape(nt, -1, w), jt, offset, step) * scale_x
    dw = t.shape[-1]
    t = t.reshape((nt,) + lead + (h, dw)).transpose(-1, -2) \
        .reshape(nt, -1, h)
    t = _conv_trials(t, jt, offset, step) * scale_y
    dh = t.shape[-1]
    out = t.reshape((nt,) + lead + (dw, dh)).transpose(-1, -2)
    if step > 1:
        out = out.repeat_interleave(step, dim=-2)[..., :h, :]
        out = upsample_columns(out, step, w)
    out = out.contiguous()
    return out[0] if trial_axis is None else out.movedim(0, trial_axis)


def border_scales(size: int, padded: int, sigma: float,
                  border_ratio: float = 0.0):
    """The border scales of an axis of real extent `size` laid into a
    padded axis of `padded` pixels: float32 [ceil(padded / step)], the
    real positions' normalization (_border_weights) followed by 1.0 at
    the padded positions, which consumers mask (JAX ops/blur.py
    border_scales)."""
    step = blur_step(sigma)
    real = _border_weights(size, sigma, border_ratio)
    n_out = -(-padded // step)
    out = np.ones(n_out, dtype=np.float32)
    out[:len(real)] = real[:n_out]
    return out


def blur_dyn(channel, sigma: float, scale_x, scale_y):
    """Blur of padded images [..., B, Hp, Wp] with each image's own border
    scales scale_x [B, ceil(Wp / step)], scale_y [B, ceil(Hp / step)]
    (ops/padgeom.py; JAX blur_dyn). The caller zeroes the input outside
    each image's valid region; the result then equals the blur of the
    image alone at its valid pixels. The convolutions run once per image
    at the shape of a one-image blur, so an image's bits do not depend on
    how many images are stacked beside it."""
    lead = channel.shape[:-3]
    nb, h, w = channel.shape[-3:]
    taps, offset = gauss_taps(sigma)
    step = blur_step(sigma)
    jt = torch.as_tensor(taps, device=channel.device)
    x = channel.movedim(-3, 0).reshape(nb, -1, w)
    t = _conv_trials(x, jt, offset, step) * scale_x[:, None, :]
    dw = t.shape[-1]
    t = t.reshape((nb,) + lead + (h, dw)).transpose(-1, -2) \
        .reshape(nb, -1, h)
    t = _conv_trials(t, jt, offset, step) * scale_y[:, None, :]
    dh = t.shape[-1]
    out = t.reshape((nb,) + lead + (dw, dh)).transpose(-1, -2)
    if step > 1:
        out = out.repeat_interleave(step, dim=-2)[..., :h, :]
        out = upsample_columns(out, step, w)
    return out.movedim(0, -3).contiguous()


@lru_cache(maxsize=None)
def blur_matrix(size: int, sigma: float, border_ratio: float = 0.0):
    """Dense [size, size] float32 matrix B with (B @ v) == blur(v) for
    step == 1 (the 8x8 per-block opsin blur)."""
    taps, offset = gauss_taps(sigma)
    taps64 = taps.astype(np.float64)
    assert blur_step(sigma) == 1
    full = taps64.sum()
    mat = np.zeros((size, size), dtype=np.float64)
    for x in range(size):
        lo = max(0, x - offset)
        hi = min(size, x + len(taps) - offset) - 1
        for j in range(lo, hi + 1):
            mat[x, j] = taps64[j - x + offset]
        wsum = mat[x].sum()
        wsum = (1.0 - border_ratio) * wsum + border_ratio * full
        mat[x] /= wsum
    return mat.astype(np.float32)
