"""Double-precision 8x8 DCT/IDCT (reference: guetzli/dct_double.cc).

Used by the YUV420 downsampling path (OutputImage::Downsample ->
SetDownsampledCoefficients, output_image.cc:496-531) and ToFloatPixels.
A copy of guetzli_tpu/codec/dct_double.py.
"""

import numpy as np

from guetzli_tpu_torch import consts

_B = consts.DCT_DOUBLE            # [u, x] = 0.5*alpha(u)*cos((2x+1)u*pi/16)


def block_dct_double(blocks):
    """Forward DCT of [..., 8, 8] float64 spatial blocks."""
    return np.einsum("yu,...uv,xv->...yx", _B, blocks, _B, optimize=True)


def block_idct_double(blocks):
    """Inverse DCT of [..., 8, 8] float64 coefficient blocks."""
    return np.einsum("uy,...uv,vx->...yx", _B, blocks, _B, optimize=True)
