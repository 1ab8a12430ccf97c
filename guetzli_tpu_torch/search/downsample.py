"""YUV420 downsampling: chroma pre-processing + averaged DCT re-encode.

Port of guetzli/preprocess_downsample.cc and the downsample half of
guetzli/output_image.cc (ToFloatPixels :100-122, SetDownsampledCoefficients
:496-531, Downsample :535-571), numpy-vectorized. Quirks preserved
deliberately:

  * PreProcessChannel's caller swaps the (blur, sharpen) flag order
    (output_image.cc:557-560 passes cfg.u_sharpen into the `blur` slot);
  * channel 2 (V) is processed first with the `u_*` flags, channel 1 (U)
    second with the `v_*` flags;
  * all masks/filters skip image borders exactly like the reference.

A copy of guetzli_tpu/search/downsample.py (numpy only).
"""

import numpy as np

from guetzli_tpu_torch.codec.dct_double import block_dct_double


def _normal(x, sigma):
    k_inv_sqrt_2pi = 0.3989422804014327
    return np.exp(-x * x / (2 * sigma * sigma)) * k_inv_sqrt_2pi / sigma


def _convolve2x(image, kernel, mul):
    """Separable 5-tap convolve skipping borders (preprocess_downsample.cc:
    53-83): un-normalizable edge pixels keep their input value."""
    h, w = image.shape
    size = len(kernel)
    size2 = size // 2
    temp = image.copy()
    acc = np.zeros((h, w - 2 * size2), dtype=np.float32)
    for j in range(size):
        acc += np.float32(kernel[j]) * image[:, j:w - 2 * size2 + j]
    temp[:, size2:w - size2] = acc * np.float32(mul)
    result = temp.copy()
    acc = np.zeros((h - 2 * size2, w), dtype=np.float32)
    for j in range(size):
        acc += np.float32(kernel[j]) * temp[size2 + j - size2:
                                            h - 2 * size2 + j, :]
    result[size2:h - size2, :] = acc * np.float32(mul)
    return result


def _convolve2d_edge(image):
    """3x3 Laplacian edge conv skipping borders (kEdgeMatrix, :233-241)."""
    h, w = image.shape
    out = image.copy()
    out[1:-1, 1:-1] = (4.0 * image[1:-1, 1:-1]
                       - image[1:-1, :-2] - image[1:-1, 2:]
                       - image[:-2, 1:-1] - image[2:, 1:-1])
    return out


def _sharpen(image, sigma, amount):
    kernel = [_normal(i - 2, sigma) for i in range(5)]
    mul = 1.0 / sum(kernel)
    blurred = _convolve2x(image, kernel, mul)
    return image + (image - blurred) * np.float32(amount)


def _blur13(image):
    kernel = [_normal(i - 2, 1.3) for i in range(5)]
    return _convolve2x(image, kernel, 1.0 / sum(kernel))


def _erode(m):
    out = m.copy()
    out[1:-1, 1:-1] = (m[1:-1, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
                       & m[:-2, 1:-1] & m[2:, 1:-1])
    return out


def _dilate(m):
    out = m.copy()
    out[1:-1, 1:-1] = (m[1:-1, 1:-1] | m[1:-1, :-2] | m[1:-1, 2:]
                       | m[:-2, 1:-1] | m[2:, 1:-1])
    return out


def preprocess_channel(w, h, channel, sigma, amount, blur, sharpen, yuv):
    """PreProcessChannel (preprocess_downsample.cc:157-279).

    yuv: [3, H, W] float32 in 0..255; returns a new [3, H, W].
    """
    if not blur and not sharpen:
        return yuv
    yuv = yuv.copy()
    y = yuv[0] / np.float32(255.0)
    u = yuv[1] / np.float32(255.0) - np.float32(0.5)
    v = yuv[2] / np.float32(255.0) - np.float32(0.5)

    r = y + np.float32(1.402) * v
    g = y - np.float32(0.34414) * u - np.float32(0.71414) * v
    b = y + np.float32(1.772) * u

    if channel == 2:
        darkmap = (g < 0.85) & (b < 0.85) & (r < 0.9)
    else:
        darkmap = (r < 0.85) & (g < 0.85) & (b < 0.9)
    for _ in range(3):
        darkmap = _erode(darkmap)

    if channel == 2:
        redmap = (2.116 * v > -0.34414 * u + 0.2) \
            & (1.402 * v > 1.772 * u + 0.2)
    else:
        redmap = (v < 1.263 * u - 0.1) & (u > -0.33741 * v)
    for _ in range(3):
        redmap = _dilate(redmap)

    sharpenmap = redmap & darkmap

    threshold = (0.02 if channel == 2 else 1.0) * 127.5
    chan = yuv[channel] / np.float32(255.0) - (
        np.float32(0.5) if channel else np.float32(0.0))
    edge = _convolve2d_edge(chan)
    blurmap = ((~sharpenmap) & darkmap
               & (np.abs(edge) < threshold) & (v < -0.162 * u))
    for _ in range(2):
        blurmap = _erode(blurmap)

    sharpened = _sharpen(chan, sigma, amount)
    blurred = _blur13(chan)
    out = chan.copy()
    if sharpen:
        out[sharpenmap] = sharpened[sharpenmap]
    if blur:
        out[blurmap & ~sharpenmap] = blurred[blurmap & ~sharpenmap]

    result = yuv
    off = np.float32(0.5) if channel else np.float32(0.0)
    result[channel] = (out + off) * np.float32(255.0)
    return result


def to_float_pixels(coeffs, bw, bh, w, h):
    """OutputImageComponent::ToFloatPixels: double IDCT + 128, cropped."""
    from guetzli_tpu_torch.codec.dct_double import block_idct_double
    blocks = block_idct_double(
        coeffs.astype(np.float64).reshape(-1, 8, 8)) + 128.0
    img = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(bh * 8, bw * 8)
    return img[:h, :w].astype(np.float32)


def downsampled_coefficients(pixels, factor_x, factor_y):
    """SetDownsampledCoefficients (output_image.cc:496-531): clamped
    factor_x x factor_y box average on an 8x8 block grid, double DCT,
    DC-1024, round to int.

    pixels: [H, W] float32; returns (coeffs int16 [NB, 64], bw, bh).
    """
    h, w = pixels.shape
    bw = (w + 8 * factor_x - 1) // (8 * factor_x)
    bh = (h + 8 * factor_y - 1) // (8 * factor_y)
    xs = np.minimum(np.arange(bw * 8 * factor_x), w - 1)
    ys = np.minimum(np.arange(bh * 8 * factor_y), h - 1)
    padded = pixels[np.ix_(ys, xs)].astype(np.float64)
    avg = padded.reshape(bh * 8, factor_y, bw * 8, factor_x) \
        .mean(axis=(1, 3))
    blocks = avg.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    dct = block_dct_double(blocks.reshape(-1, 8, 8))
    dct[:, 0, 0] -= 1024.0
    coeffs = np.round(dct).astype(np.int16).reshape(-1, 64)
    return coeffs, bw, bh


# -- silver-screen RGB -> YUV420 (preprocess_downsample.cc:281-476) -------

def _gamma_to_linear(x):
    return np.power(np.maximum(x, 0.0) / 255.0, 2.2, dtype=np.float64) \
        .astype(np.float32)


def _linear_to_gamma(x):
    return (255.0 * np.power(np.maximum(x, 0.0), 1.0 / 2.2,
                             dtype=np.float64)).astype(np.float32)


def _rgb_to_yuv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.16874 * r - 0.33126 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.41869 * g - 0.08131 * b + 128.0
    return np.stack([y, u, v]).astype(np.float32)


def _yuv_to_rgb(yuv):
    y, u, v = yuv
    r = y + 1.402 * (v - 128.0)
    g = y - 0.344136 * (u - 128.0) - 0.714136 * (v - 128.0)
    b = y + 1.772 * (u - 128.0)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 255.0) \
        .astype(np.float32)


def _linearly_averaged_luma(rgb):
    lin = _gamma_to_linear(rgb)
    y = 0.299 * lin[..., 0] + 0.587 * lin[..., 1] + 0.114 * lin[..., 2]
    return _linear_to_gamma(y)


def _linearly_downsample2x2(rgb, w, h):
    ws, hs = (w + 1) // 2, (h + 1) // 2
    xs = np.minimum(np.arange(ws * 2), w - 1)
    ys = np.minimum(np.arange(hs * 2), h - 1)
    lin = _gamma_to_linear(rgb)[np.ix_(ys, xs)]
    avg = lin.reshape(hs, 2, ws, 2, 3).mean(axis=(1, 3))
    return _linear_to_gamma(avg)


def _upsample2x2(img, w, h):
    up = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
    return up[:h, :w]


def _fancy_blur(img, w, h):
    """The float "fancy upsample" filter (preprocess_downsample.cc:405-426)."""
    y0 = (np.arange(h) & ~1)
    x0 = (np.arange(w) & ~1)
    dy = 4 * (np.arange(h) & 1) - 2
    dx = 4 * (np.arange(w) & 1) - 2
    y1 = np.clip(y0 + dy, 0, h - 1)
    x1 = np.clip(x0 + dx, 0, w - 1)
    return (9.0 * img[np.ix_(y0, x0)] + 3.0 * img[np.ix_(y0, x1)]
            + 3.0 * img[np.ix_(y1, x0)] + img[np.ix_(y1, x1)]) / 16.0


def rgb_to_yuv420(rgb, w, h):
    """RGBToYUV420 (preprocess_downsample.cc:452-476): iterative refinement
    of a subsampled YUV representation against linear-light targets.

    rgb: uint8 [h, w, 3]; returns [3][H*W] float32 planes (Y full-res, U/V
    box-upsampled to full-res like the reference's return value).
    """
    rgbf = rgb.astype(np.float32)
    y_target = _linearly_averaged_luma(rgbf)
    yuv_target = _rgb_to_yuv(_linearly_downsample2x2(rgbf, w, h))
    guess_y = _upsample2x2(yuv_target[0], w, h)
    guess_u = yuv_target[1].copy()
    guess_v = yuv_target[2].copy()
    for _ in range(20):
        full_u = _fancy_blur(_upsample2x2(guess_u, w, h), w, h)
        full_v = _fancy_blur(_upsample2x2(guess_v, w, h), w, h)
        rgb_rec = _yuv_to_rgb([guess_y, full_u, full_v])
        y_rec = _linearly_averaged_luma(rgb_rec)
        yuv_rec = _rgb_to_yuv(_linearly_downsample2x2(rgb_rec, w, h))
        guess_y = np.clip(guess_y - (y_rec - y_target), 0.0, 255.0)
        guess_u = np.clip(guess_u - (yuv_rec[1] - yuv_target[1]), 0.0, 255.0)
        guess_v = np.clip(guess_v - (yuv_rec[2] - yuv_target[2]), 0.0, 255.0)
    return [guess_y,
            _upsample2x2(guess_u, w, h),
            _upsample2x2(guess_v, w, h)]
