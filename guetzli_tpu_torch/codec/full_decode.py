"""In-tree decode of "unsupported" JPEGs to RGB pixels (host, numpy).

The reference handles JPEGs outside its 3-component YCbCr 4:4:4/4:2:0
fast path (CMYK, YCCK, 4:2:2/4:1:1 sampling, grayscale, RGB-tagged) by
decoding them to RGB with libjpeg/turbojpeg and re-entering the pixel
pipeline (ProcessUnsupportedJpegData, guetzli/processor.cc:1069-1153).
This module is the self-contained equivalent (a copy of
guetzli_tpu/codec/full_decode.py):
it decodes any JpegData our reader parses (1-4 components, arbitrary
integral sampling factors, baseline or progressive) to interleaved RGB
with libjpeg's own integer semantics:

  * jpeg_idct_islow fixed-point IDCT (jidctint.c) -- exact integer
    formulas, vectorized over blocks;
  * triangular "fancy" chroma upsampling for the h2v1/h2v2 cases and
    sample replication otherwise (jdsample.c);
  * the libjpeg YCbCr->RGB integer tables (jdcolor.c; identical to
    guetzli's color_transform.h, verified in tests);
  * Adobe CMYK/YCCK handling with the reference's cmyk2rgb formula
    rgb = (c*k + c + 128) >> 8 on the raw (Adobe-inverted) samples
    (processor.cc:1069-1086).

This is a host I/O fallback path (runs once per input image before the
search), so plain vectorized numpy is the right tool.
"""

import numpy as np

from guetzli_tpu_torch import consts

# jpeg_idct_islow constants (jidctint.c, CONST_BITS=13).
_CONST_BITS = 13
_PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7, shift_in, descale_bits):
    """One islow butterfly pass over stacked lanes (int64 arrays)."""
    z2, z3 = c2, c6
    z1 = (z2 + z3) * _F_0_541196100
    tmp2 = z1 - z3 * _F_1_847759065
    tmp3 = z1 + z2 * _F_0_765366865
    z2, z3 = c0, c4
    tmp0 = (z2 + z3) << _CONST_BITS
    tmp1 = (z2 - z3) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _F_1_175875602
    t0 = t0 * _F_0_298631336
    t1 = t1 * _F_2_053119869
    t2 = t2 * _F_3_072711026
    t3 = t3 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (
        _descale(tmp10 + t3, descale_bits),
        _descale(tmp11 + t2, descale_bits),
        _descale(tmp12 + t1, descale_bits),
        _descale(tmp13 + t0, descale_bits),
        _descale(tmp13 - t0, descale_bits),
        _descale(tmp12 - t1, descale_bits),
        _descale(tmp11 - t2, descale_bits),
        _descale(tmp10 - t3, descale_bits),
    )


def idct_islow_blocks(coeffs, quant):
    """libjpeg jpeg_idct_islow over a batch: [nb, 64] zigzag-natural-order
    int coefficients x [64] quant -> uint8 samples [nb, 8, 8]."""
    deq = (coeffs.astype(np.int64).reshape(-1, 8, 8)
           * quant.astype(np.int64).reshape(8, 8)[None])
    # Pass 1: columns. Workspace rows scaled up by PASS1_BITS.
    cols = _idct_1d(*(deq[:, i, :] for i in range(8)), None,
                    _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)                       # [nb, 8(row), 8(col)]
    # Pass 2: rows; final descale includes the pass-1 scaling and +3.
    rows = _idct_1d(*(ws[:, :, i] for i in range(8)), None,
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def component_plane(comp, quant, cw, ch):
    """Decode one component to its natural-size sample plane [ch, cw]."""
    blocks = idct_islow_blocks(np.asarray(comp.coeffs), quant)
    bh, bw = comp.height_in_blocks, comp.width_in_blocks
    plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(bh * 8, bw * 8)
    return plane[:ch, :cw]


def h2v1_fancy_upsample(p):
    """jdsample.c h2v1_fancy_upsample: [h, w] -> [h, 2w]."""
    x = p.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    even = (x * 3 + left + 1) >> 2
    odd = (x * 3 + right + 2) >> 2
    even[:, 0] = x[:, 0]
    odd[:, -1] = x[:, -1]
    out = np.empty((p.shape[0], p.shape[1] * 2), np.int32)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out.astype(np.uint8)


def h2v2_fancy_upsample(p):
    """jdsample.c h2v2_fancy_upsample: [h, w] -> [2h, 2w]."""
    x = p.astype(np.int32)
    h, w = x.shape
    up = np.concatenate([x[:1], x[:-1]], axis=0)      # row above (clamped)
    dn = np.concatenate([x[1:], x[-1:]], axis=0)      # row below (clamped)
    # colsum for output rows 2r (farther = above) and 2r+1 (below).
    cs = np.empty((2 * h, w), np.int32)
    cs[0::2] = x * 3 + up
    cs[1::2] = x * 3 + dn
    left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
    even = (cs * 3 + left + 8) >> 4
    odd = (cs * 3 + right + 7) >> 4
    even[:, 0] = (cs[:, 0] * 4 + 8) >> 4
    odd[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    out = np.empty((2 * h, 2 * w), np.int32)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out.astype(np.uint8)


def upsample_plane(p, hexp, vexp, w, h):
    """Upsample a component plane by integral factors to [h, w]: fancy
    for the h2v1/h2v2 libjpeg cases, replication otherwise."""
    if hexp == 1 and vexp == 1:
        out = p
    elif hexp == 2 and vexp == 1:
        out = h2v1_fancy_upsample(p)
    elif hexp == 2 and vexp == 2:
        out = h2v2_fancy_upsample(p)
    else:
        out = np.repeat(np.repeat(p, vexp, axis=0), hexp, axis=1)
    return out[:h, :w]


def _adobe_transform(jpg):
    """Adobe APP14 color transform byte, or None (jdcolor semantics)."""
    for app in jpg.app_data:
        if app[0] == 0xEE and len(app) >= 15:
            return app[14]
    return None


def _ycc_to_rgb_planes(y, cb, cr):
    """libjpeg ycc_rgb_convert (identical to color_transform.h tables)."""
    y = y.astype(np.int32)
    r = y + consts.CR_TO_RED[cr]
    g = y + ((consts.CR_TO_GREEN[cr] + consts.CB_TO_GREEN[cb]) >> 16)
    b = y + consts.CB_TO_BLUE[cb]
    return [np.clip(c, 0, 255).astype(np.uint8) for c in (r, g, b)]


def _cmyk_to_rgb(c, m, y, k):
    """The reference's cmyk2rgb on raw Adobe-inverted samples:
    rgb = (c*k + c + 128) >> 8 (processor.cc:1069-1077)."""
    k = k.astype(np.int32)
    return [(((p.astype(np.int32) * k) + p + 128) >> 8).astype(np.uint8)
            for p in (c, m, y)]


def decode_any_to_rgb(jpg):
    """Decode a parsed JpegData of any supported layout to RGB.

    Returns (rgb[h, w, 3] uint8, w, h). Raises ValueError on component
    layouts libjpeg would reject (zero/fractional sampling ratios).
    """
    w, h = jpg.width, jpg.height
    ncomp = len(jpg.components)
    if ncomp not in (1, 3, 4):
        raise ValueError("unsupported component count %d" % ncomp)
    hmax = max(c.h_samp_factor for c in jpg.components)
    vmax = max(c.v_samp_factor for c in jpg.components)
    planes = []
    for comp in jpg.components:
        if hmax % comp.h_samp_factor or vmax % comp.v_samp_factor:
            raise ValueError("fractional sampling not supported")
        cw = (w * comp.h_samp_factor + hmax - 1) // hmax
        ch = (h * comp.v_samp_factor + vmax - 1) // vmax
        quant = jpg.quant[comp.quant_idx].values
        p = component_plane(comp, quant, cw, ch)
        planes.append(upsample_plane(p, hmax // comp.h_samp_factor,
                                     vmax // comp.v_samp_factor, w, h))

    transform = _adobe_transform(jpg)
    if ncomp == 1:
        rgb = [planes[0]] * 3
    elif ncomp == 3:
        from guetzli_tpu_torch.codec.reader import has_ycbcr_colorspace
        if has_ycbcr_colorspace(jpg):
            rgb = _ycc_to_rgb_planes(*planes)
        else:
            rgb = planes                              # RGB-tagged
    else:
        if transform == 2:
            # YCCK: YCbCr->R'G'B', invert to CMY, keep K
            # (jdcolor.c ycck_cmyk_convert), then the CMYK formula.
            rp, gp, bp = _ycc_to_rgb_planes(*planes[:3])
            cmy = [255 - p.astype(np.int32) for p in (rp, gp, bp)]
            cmy = [p.astype(np.uint8) for p in cmy]
            rgb = _cmyk_to_rgb(cmy[0], cmy[1], cmy[2], planes[3])
        else:
            rgb = _cmyk_to_rgb(*planes)
    out = np.stack(rgb, axis=-1)
    return np.ascontiguousarray(out), w, h
