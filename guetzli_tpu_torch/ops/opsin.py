"""sRGB-linear -> XYB opsin dynamics transform (butteraugli.cc:741-974).

Blur the linear RGB with sigma=1.1, compute a per-pixel sensitivity from
the blurred image through the opsin absorbance mixing and a
rational-polynomial gamma, apply the sensitivity to the absorbance of the
sharp image, and mix into the XYB opponent space.

The 3x3 channel mixes are written as fixed-order multiply-adds, the same
order as the per-block kernels (csrc/compare_team.cuh) use.
"""

import numpy as np
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops.blur import blur, blur_dyn, blur_matrix
from guetzli_tpu_torch.ops.diffmap import _vmask
from guetzli_tpu_torch.ops.fp import div

_GAMMA_MIN = float(np.float32(consts.GAMMA_MIN_VALUE))
_GAMMA_RANGE = np.float32(consts.GAMMA_MAX_VALUE - consts.GAMMA_MIN_VALUE)
_MIX = consts.OPSIN_MIX.astype(np.float32)
_BIAS = consts.OPSIN_BIAS.astype(np.float32)
_XYB = consts.RGB_TO_XYB.astype(np.float32)


def _clenshaw(x, coeffs):
    """Chebyshev-basis polynomial evaluation (butteraugli.cc:869-896)."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for c in coeffs[:0:-1]:
        t = (x * b1) * 2.0 - b2 + float(np.float32(c))
        b2 = b1
        b1 = t
    return x * b1 - b2 + float(np.float32(coeffs[0]))


def gamma(v):
    """Rational polynomial gamma (butteraugli.cc:923-941)."""
    x01 = div(v - _GAMMA_MIN, _GAMMA_RANGE)
    xc = 2.0 * x01 - 1.0
    return _clenshaw(xc, consts.GAMMA_P) / _clenshaw(xc, consts.GAMMA_Q)


def mix3(m, x, bias=None):
    """out[c] = m[c][0]*x[0] + m[c][1]*x[1] + m[c][2]*x[2] (+ bias[c]),
    stacked on axis 0; x indexes channels on axis 0."""
    outs = []
    for c in range(3):
        o = float(m[c][0]) * x[0] + float(m[c][1]) * x[1] \
            + float(m[c][2]) * x[2]
        if bias is not None:
            o = o + float(bias[c])
        outs.append(o)
    return torch.stack(outs)


def opsin_from_blurred(rgb, blurred):
    """[3, ...] linear RGB and its blur -> [3, ...] XYB."""
    pre = mix3(_MIX, blurred, _BIAS)
    sensitivity = gamma(pre) / pre
    cur = mix3(_MIX, rgb, _BIAS) * sensitivity
    return mix3(_XYB, cur)


def opsin_dynamics_image(rgb, trial_axis=None):
    """[3, H, W] linear RGB -> XYB opsin (butteraugli.cc:943-974); [3, B,
    H, W] for B trials with trial_axis=1."""
    return opsin_from_blurred(
        rgb, blur(rgb, consts.OPSIN_SIGMA, 0.0, trial_axis))


def opsin_dynamics_image_dyn(rgb, w, h, sc):
    """Padded opsin: [3, B, Hp, Wp] linear RGB of B images with true sizes
    w, h (int tensors [B]) and their "opsin" border scales sc (ops/
    padgeom.py). Values outside each valid region are garbage that the
    consumers mask (JAX opsin_dynamics_image_dyn)."""
    hp, wp = rgb.shape[-2:]
    blurred = blur_dyn(rgb * _vmask(hp, wp, w, h), consts.OPSIN_SIGMA,
                       *sc["opsin"])
    return opsin_from_blurred(rgb, blurred)


def opsin_dynamics_blocks(rgb_blocks):
    """Per-tile opsin for [..., 3, 8, 8] tiles: the blur stays inside the
    tile (OpsinDynamicsImage at xsize=ysize=8, as SwitchBlock calls it,
    butteraugli_comparator.cc:85-111). Returns [..., 3, 8, 8]."""
    bm = torch.as_tensor(blur_matrix(8, consts.OPSIN_SIGMA, 0.0),
                         device=rgb_blocks.device)
    blurred = torch.matmul(torch.matmul(bm, rgb_blocks), bm.T)
    x = rgb_blocks.movedim(-3, 0)
    return opsin_from_blurred(x, blurred.movedim(-3, 0)).movedim(0, -3)
