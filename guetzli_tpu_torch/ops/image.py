"""Image state ops: integer IDCT, pixel planes, color.

Reference semantics reproduced exactly in int32 (guetzli/idct.cc,
guetzli/output_image.cc, guetzli/color_transform.h):

  * 13-bit fixed-point 8x8 IDCT with libjpeg-compatible rounding. The
    products reach 2^27, past the float32 mantissa, and CUDA has no
    integer matmul, so both passes are eight fixed-order int32
    multiply-adds on whole tensors;
  * the x16-scaled pixel cache with parity-dithered rounding
    ``(p + 8 - (x & 1)) >> 4``;
  * integer YCbCr->RGB via the arithmetic form of the fixed-point tables.

Everything is batched over blocks; the whole-image path reconstructs all
pixels from coefficients at once.
"""

import numpy as np
import torch

from guetzli_tpu_torch import config, consts
from guetzli_tpu_torch.ops import devconst

_IDCT = consts.IDCT_MATRIX.astype(np.int32)   # [x, u]

_SRGB_LO = float(np.float32(1.0 / 12.92))
_SRGB_SCALE = float(np.float32(1.0 / 255.0))
_SRGB_OFF = float(np.float32(0.055))
_SRGB_DIV = float(np.float32(1.0 / 1.055))
_SRGB_POW = float(np.float32(2.4))


def _idct_matrix(device):
    return devconst.array(_IDCT, device)


def idct_blocks(coeffs):
    """Integer IDCT: [..., 64] int32 -> [..., 64] int32 in 0..255.

    Matches ComputeBlockIDCT (idct.cc:139-161): column pass with >>11
    rounding, row pass with (+128 offset) >>18 rounding, clamped."""
    m = _idct_matrix(coeffs.device)
    b = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).to(torch.int32)
    # Column pass: col[y, x] = sum_u M[y, u] * b[u, x].
    col = m[:, 0, None] * b[..., 0:1, :]
    for u in range(1, 8):
        col = col + m[:, u, None] * b[..., u:u + 1, :]
    col = (col + (1 << 10)) >> 11
    # Row pass: row[y, x] = sum_u M[x, u] * col[y, u].
    row = m[None, :, 0] * col[..., :, 0:1]
    for u in range(1, 8):
        row = row + m[None, :, u] * col[..., :, u:u + 1]
    row = (row + (257 << 17)) >> 18
    return row.clamp_(0, 255).reshape(coeffs.shape)


def blocks_to_plane(blocks, bw, bh, w, h):
    """[..., bh*bw, 64] -> [..., h, w] pixel plane (cropped)."""
    lead = blocks.shape[:-2]
    n = len(lead)
    a = blocks.reshape(lead + (bh, bw, 8, 8))
    perm = tuple(range(n)) + (n, n + 2, n + 1, n + 3)
    img = a.permute(perm).reshape(lead + (bh * 8, bw * 8))
    return img[..., :h, :w]


def ycbcr_to_rgb(y, cb, cr):
    """color_transform.h:1038-1046, arithmetic form of the tables.
    Returns [3, ...] int32 stacked (r, g, b)."""
    cr_off = cr - 128
    cb_off = cb - 128
    r = y + ((91881 * cr_off + 32768) >> 16)
    b = y + ((116130 * cb_off + 32768) >> 16)
    g = y + (((-46802) * cr_off + (-22554) * cb_off + 32768) >> 16)
    return torch.stack([r, g, b]).clamp_(0, 255)


def pixels_to_srgb(yuv_planes):
    """Pixel cache [3, H, W] (x16 scaled) -> [3, H, W] int32 RGB bytes,
    with ToPixels' parity dither (output_image.cc:83)."""
    x = torch.arange(yuv_planes.shape[-1], dtype=torch.int32,
                     device=yuv_planes.device)
    px = (yuv_planes + (8 - (x & 1))) >> 4
    return ycbcr_to_rgb(px[0], px[1], px[2])


def srgb_to_linear(rgb_int, trial_axis=None):
    """uint8-range ints -> linear float32 (gamma_correct.cc:23-33), in
    the closed form of the 256-entry table: the linear segment below 11
    and the 2.4 power above (the JAX package's default form). Under
    GUETZLI_TPU_EXACT_LUT=1 the table itself, read as float32 (JAX
    reads it by an exact one-hot contraction).

    With ``trial_axis``, the power runs once per trial on a contiguous
    copy of that trial: the CPU's vectorized pow and its scalar tail
    round differently, and the tail's place depends on the tensor's
    size, so one call over every trial would round a trial's last
    pixels otherwise than a compare of that trial alone."""
    if config.exact_lut():
        from guetzli_tpu_torch.ops.blockdiff import table_on
        return table_on(consts.SRGB_TO_LINEAR, rgb_int.device)[
            rgb_int.long()]
    return srgb_closed_form(rgb_int, trial_axis)


def srgb_closed_form(rgb_int, trial_axis=None):
    """srgb_to_linear's closed form, whatever the knob says."""
    vf = rgb_int.to(torch.float32)
    lo = vf * _SRGB_LO
    base = (vf * _SRGB_SCALE + _SRGB_OFF) * _SRGB_DIV
    if trial_axis is None:
        p = torch.pow(base, _SRGB_POW)
    else:
        p = torch.stack([torch.pow(t.contiguous(), _SRGB_POW)
                         for t in base.unbind(trial_axis)], trial_axis)
    return torch.where(rgb_int < 11, lo, 255.0 * p)


def srgb_table(device):
    """The closed form of the 256 byte values, float32 [256] on `device`:
    the lane-major block compare reads it as a table (so do the CUDA
    kernels). It stays in closed form under GUETZLI_TPU_EXACT_LUT, as the
    JAX kernels' sRGB step does."""
    return srgb_closed_form(torch.arange(256, dtype=torch.int32,
                                         device=device))


def coeffs_to_srgb(coeffs, bw, bh, w, h):
    """[3, NB, 64] int32 dequantized YUV444 coefficients -> [3, H, W] int32
    sRGB bytes (OutputImage::ToSRGB, output_image.cc:654-701); [3, B, NB,
    64] -> [3, B, H, W] for B trials."""
    pix = idct_blocks(coeffs) << 4        # pixel cache is scaled x16
    return pixels_to_srgb(blocks_to_plane(pix, bw, bh, w, h))


def byte_plane(pix_x16):
    """x16 pixel plane [..., H, W] -> bytes via the ToPixels parity dither
    (output_image.cc:83) on the absolute column."""
    x = torch.arange(pix_x16.shape[-1], dtype=torch.int32,
                     device=pix_x16.device)
    return (pix_x16 + (8 - (x & 1))) >> 4


def chroma_byte_plane(coeffs, bw, bh, w, h):
    """Factor-2 chroma component [..., NB, 64] -> full-res bytes [..., h,
    w]: IDCT -> x16 subsampled plane -> fancy upsample -> dither."""
    from guetzli_tpu_torch.ops import upsample as us
    sub = blocks_to_plane(idct_blocks(coeffs) << 4, bw, bh,
                          (w + 1) // 2, (h + 1) // 2)
    return byte_plane(us.fancy_upsample(sub, w, h))


def chroma_byte_plane_dyn(coeffs, cbwp, cbhp, wp, hp, w, h):
    """Padded factor-2 chroma bytes: [B, NBCp, 64] on the bucket chroma
    grid -> [B, hp, wp], the upsample's border clamps from each image's
    true size w, h (int tensors [B]) (JAX chroma_byte_plane_dyn)."""
    from guetzli_tpu_torch.ops import upsample as us
    sub = blocks_to_plane(idct_blocks(coeffs) << 4, cbwp, cbhp, wp // 2,
                          hp // 2)
    return byte_plane(us.fancy_upsample_dyn(sub, (w + 1) // 2,
                                            (h + 1) // 2))


def coeffs420_to_srgb_dyn(y_coeffs, u_coeffs, v_coeffs, ybwp, ybhp, cbwp,
                          cbhp, wp, hp, w, h):
    """Padded YUV420 state of B images -> [3, B, hp, wp] int32 sRGB bytes,
    garbage outside each valid region (JAX coeffs420_to_srgb_dyn)."""
    yb = byte_plane(blocks_to_plane(idct_blocks(y_coeffs) << 4, ybwp, ybhp,
                                    wp, hp))
    ub = chroma_byte_plane_dyn(u_coeffs, cbwp, cbhp, wp, hp, w, h)
    vb = chroma_byte_plane_dyn(v_coeffs, cbwp, cbhp, wp, hp, w, h)
    return ycbcr_to_rgb(yb, ub, vb)


def coeffs420_to_srgb(y_coeffs, u_coeffs, v_coeffs, ybw, ybh, cbw, cbh,
                      w, h):
    """YUV420 state -> [3, H, W] int32 sRGB bytes (OutputImage::ToSRGB with
    factor-2 chroma); coefficients [B, NB, 64] -> [3, B, H, W]."""
    yb = byte_plane(blocks_to_plane(idct_blocks(y_coeffs) << 4, ybw, ybh,
                                    w, h))
    ub = chroma_byte_plane(u_coeffs, cbw, cbh, w, h)
    vb = chroma_byte_plane(v_coeffs, cbw, cbh, w, h)
    return ycbcr_to_rgb(yb, ub, vb)


def coeffs_to_linear_rgb(coeffs, bw, bh, w, h, trial_axis=None):
    """[3, NB, 64] int32 dequantized coefficients -> [3, H, W] linear RGB
    (OutputImage::ToLinearRGB for a YUV444 image); [3, B, NB, 64] -> [3,
    B, H, W] with trial_axis=1."""
    return srgb_to_linear(coeffs_to_srgb(coeffs, bw, bh, w, h), trial_axis)
