"""The plain reference's butteraugli distance between two sRGB images.

Float64 throughout: the 256-entry sRGB -> linear table of
gamma_correct.cc:23-33, the opsin dynamics image of each side, the
diffmap and its maximum (butteraugli.cc:943-974, 1046-1079, 1233-1239),
all from h100bench/reference/butteraugli64.py.
"""

import numpy as np

from h100bench.reference import butteraugli64 as ba
from h100bench.reference import consts64


def distance(rgb0, rgb1):
    """Butteraugli distance of uint8 [h, w, 3] images of one size."""
    rgb0 = np.asarray(rgb0)
    rgb1 = np.asarray(rgb1)
    if rgb0.shape != rgb1.shape:
        raise ValueError("images of different sizes: %r, %r"
                         % (rgb0.shape, rgb1.shape))
    lut = consts64.SRGB_TO_LINEAR

    def xyb(rgb):
        return ba.opsin_dynamics_image(lut[rgb.transpose(2, 0, 1)])
    return ba.score_from_diffmap(ba.diffmap_opsin_dynamics(xyb(rgb0),
                                                           xyb(rgb1)))
