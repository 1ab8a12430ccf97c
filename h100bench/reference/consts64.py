"""Numeric constants of butteraugli and of Guetzli's decoder, for the
plain reference.

Frozen copy of guetzli_tpu_torch/consts.py as of commit bfd8995 (lines
19-231: the butteraugli model, the sRGB table, the JPEG order, the
integer IDCT matrix and the YCbCr->RGB tables), so that no later change
to the program moves the yardstick. Values are the reference encoder's
(guetzli's butteraugli.cc, gamma_correct.cc, idct.cc,
color_transform.h), cited inline.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Global butteraugli scale (butteraugli.cc:56-57)
# ---------------------------------------------------------------------------
K_INTERNAL_GOOD_QUALITY = 14.921561160295326
K_GLOBAL_SCALE = 1.0 / K_INTERNAL_GOOD_QUALITY

BUTTERAUGLI_STEP = 3  # butteraugli_comparator.h:31

# ---------------------------------------------------------------------------
# Contrast sensitivity for the 8x8 FFT block diff (butteraugli.cc:157-198).
# Indexed by flattened [xfreq*8 + yfreq]; only entries 0..36 are used
# (conjugate symmetry of the real-input FFT).
# ---------------------------------------------------------------------------
CSF8X8 = np.array([
    5.28270670524, 0.0, 0.0, 0.0, 0.3831134973, 0.676303603859,
    3.58927792424, 18.6104367002, 18.6104367002, 3.09093131948, 1.0,
    0.498250875965, 0.36198671102, 0.308982169883, 0.1312701920435,
    2.37370549629, 3.58927792424, 1.0, 2.37370549629, 0.991205724152,
    1.05178802919, 0.627264168628, 0.4, 0.1312701920435, 0.676303603859,
    0.498250875965, 0.991205724152, 0.5, 0.3831134973, 0.349686450518,
    0.627264168628, 0.308982169883, 0.3831134973, 0.36198671102,
    1.05178802919, 0.3831134973, 0.12,
], dtype=np.float64)

# ---------------------------------------------------------------------------
# High/low frequency color difference LUTs (butteraugli.cc:200-247).
# Each is a 21-entry piecewise-linear table.
# ---------------------------------------------------------------------------


def _cumulative_lut(off: float, inc: float) -> np.ndarray:
    lut = np.zeros(21, dtype=np.float64)
    if off:
        lut[1] = off
        for i in range(2, 21):
            lut[i] = lut[i - 1] + inc
    else:
        for i in range(1, 21):
            lut[i] = lut[i - 1] + inc
    return lut


HF_COLOR_DIFF_DX = _cumulative_lut(11.38708334481672, 14.550189611520716)
HF_COLOR_DIFF_DY = _cumulative_lut(1.4103373714040413, 0.7084088867024)
LF_COLOR_DIFF_DY = _cumulative_lut(0.0, 5.2511644570349185)

# XybToVals multipliers (butteraugli.cc:294-302)
XYB_HF_XMUL = 0.758304045695
XYB_HF_YMUL = 2.28148649801
XYB_HF_ZMUL = 1.87816926918

# XybLowFreqToVals (butteraugli.cc:305-315)
XYB_LF_XMUL = 6.64482198135
XYB_LF_YMUL = 0.837846224276
XYB_LF_ZMUL = 7.34905756986
XYB_LF_Y_TO_Z = 0.0812519812628

# Block-diff AC channel weights (butteraugli.cc:658-661)
BLOCKDIFF_AC_XMUL = 64.8
BLOCKDIFF_AC_YMUL = 1.753123908348329
BLOCKDIFF_AC_YMUL2 = 1.51983458269
BLOCKDIFF_AC_ZMUL = 2.4
BLOCKDIFF_Y_LIMIT = 0.04  # RemoveRangeAroundZero band (butteraugli.cc:674)
FFT_GLOBAL_MUL = 0.000064  # ButteraugliFFTSquared scale (butteraugli.cc:575)

# ---------------------------------------------------------------------------
# RGB -> XYB opponent mixing (butteraugli.cc:283-292)
# ---------------------------------------------------------------------------
RGB_TO_XYB = np.array([
    [1.01611726948, -0.982482243696, 0.0],
    [1.43571362627, 0.896039849412, 0.0],
    [0.0, 0.0, 1.0],
], dtype=np.float64)

# Opsin absorbance mixing (butteraugli.cc:741-764): the 12-entry kMix is
# laid out row-wise as [a, b, c, bias] per output channel.
OPSIN_MIX = np.array([
    [0.348036746003, 0.577814843137, 0.0544556093735],
    [0.26922717275, 0.767247733938, 0.0366922708552],
    [0.0882062883536, 0.158581714673, 0.712857943858],
], dtype=np.float64)
OPSIN_BIAS = np.array([0.774145581713, 0.920130265014, 10.6524069248],
                      dtype=np.float64)

# Rational polynomial gamma (butteraugli.cc:923-935), Chebyshev basis
GAMMA_MIN_VALUE = 0.770000000000000
GAMMA_MAX_VALUE = 274.579999999999984
GAMMA_P = np.array([
    881.979476556478289, 1496.058452015812463, 908.662212739659481,
    373.566100223287378, 85.840860336314364, 6.683258861509244,
], dtype=np.float64)
GAMMA_Q = np.array([
    12.262350348616792, 20.557285797683576, 12.161463238367844,
    4.711532733641639, 0.899112889751053, 0.035662329617191,
], dtype=np.float64)

OPSIN_SIGMA = 1.1  # blur before sensitivity (butteraugli.cc:947)

# MaskHighIntensityChange (butteraugli.cc:824-827)
MHIC_REDUCTION = np.array(
    [275.19165240059317, 18599.41286306991, 410.8995306951065],
    dtype=np.float64)
MHIC_CHROMA_BALANCE = 106.95800948271017

# Edge detector (butteraugli.cc:700-733, 1124-1128)
EDGE_DETECTOR_SIGMAS = (1.5, 0.586, 0.4)
EDGE_DETECTOR_W = 0.711100840192
EDGE_DETECTOR_WEIGHT = 0.01617112696
EDGE_LF_SIGMA = 14.0
EDGE_LF_MUL = 10.0

# Mask pipeline (butteraugli.cc:1379-1567)
AVERAGE5X5_DIAG_W = 0.679144890667
MASK_SIGMAS = (9.65781083553, 14.2644604355, 4.53358927369)
MASK_W = np.array([232.206464018, 22.9455222245, 503.962310606],
                  dtype=np.float64)

# Mask LUT parameters: (extmul, extoff, mul, offset, scaler)
MASK_LUT_PARAMS = {
    'x':    (0.975741017749, -4.25328244168, 20.8029176447,
             0.454909521427, 0.0738288224836),
    'y':    (0.373995618954, 1.5307267433, 16.2447033988,
             0.911952641929, 1.1731667845),
    'b':    (0.61582234137, -4.25376118646, 31.1444967089,
             1.05105070921, 0.47434643535),
    'dc_x': (1.79116943438, -3.86797479189, 20.4563479139,
             0.670960225853, 0.486575865525),
    'dc_y': (0.212223514236, -3.65647120524, 21.6566724788,
             1.73396799447, 0.170392660501),
    'dc_b': (0.349376011816, -0.894711072781, 18.0373825149,
             0.901647926679, 0.380086095024),
}


def make_mask_lut(extmul, extoff, mul, offset, scaler) -> np.ndarray:
    """512-entry masking LUT (butteraugli.cc:1242-1254)."""
    i = np.arange(512, dtype=np.float64)
    c = mul / ((0.01 * scaler * i) + offset)
    lut = 1.0 + extmul * (c + extoff)
    return lut * lut


MASK_LUTS = {k: make_mask_lut(*v) for k, v in MASK_LUT_PARAMS.items()}

# Diffmap assembly (butteraugli.cc:985-1044)
DIFFMAP_SIGMA = 8.8510880283
DIFFMAP_MUL1 = 24.8235314874
DIFFMAP_BORDER_RATIO = 0.03027655136
DIFFMAP_INITIAL_SLOPE = 100.0

# Per-block comparison (butteraugli_comparator.cc:153)
BLOCK_EDGE_WEIGHT = 0.05

# ---------------------------------------------------------------------------
# sRGB8 -> linear LUT (gamma_correct.cc:23-33)
# ---------------------------------------------------------------------------


def _srgb_to_linear_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.float64)
    for i in range(11):
        t[i] = i / 12.92
    i = np.arange(11, 256, dtype=np.float64)
    t[11:] = 255.0 * (((i / 255.0) + 0.055) / 1.055) ** 2.4
    return t


SRGB_TO_LINEAR = _srgb_to_linear_table()

# ---------------------------------------------------------------------------
# JPEG codec tables (jpeg_data.h)
# ---------------------------------------------------------------------------
JPEG_NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

JPEG_ZIGZAG_ORDER = np.zeros(64, dtype=np.int32)
JPEG_ZIGZAG_ORDER[JPEG_NATURAL_ORDER] = np.arange(64, dtype=np.int32)

# Integer IDCT matrix, 13-bit fixed point, libjpeg-compatible off-by-one
# entries (idct.cc:29-38). kIDCT[8*x+u].
IDCT_MATRIX = np.array([
    8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260,
    8192, 9633, 4433, -2259, -8192, -11362, -10704, -6436,
    8192, 6437, -4433, -11362, -8192, 2261, 10704, 9633,
    8192, 2260, -10703, -6436, 8192, 9633, -4433, -11363,
    8192, -2260, -10703, 6436, 8192, -9633, -4433, 11363,
    8192, -6437, -4433, 11362, -8192, -2261, 10704, -9633,
    8192, -9633, 4433, 2259, -8192, 11362, -10704, 6436,
    8192, -11363, 10703, -9633, 8192, -6437, 4433, -2260,
], dtype=np.int32).reshape(8, 8)

# Double precision DCT basis (dct_double.cc:433-450): kDCT[8*u+x]
_k = np.arange(8, dtype=np.float64)
DCT_DOUBLE = 0.5 * np.cos((2 * _k[None, :] + 1) * _k[:, None] * np.pi / 16)
DCT_DOUBLE[0, :] *= 1.0 / np.sqrt(2.0)

# YCbCr -> RGB integer transform tables (color_transform.h:22-70):
#   red   = y + kCrToRed[cr]
#   green = y + ((kCrToGreen[cr] + kCbToGreen[cb]) >> 16)
#   blue  = y + kCbToBlue[cb]
_i = np.arange(256, dtype=np.int64)
CR_TO_RED = ((91881 * (_i - 128) + 32768) >> 16).astype(np.int32)
CB_TO_BLUE = ((116130 * (_i - 128) + 32768) >> 16).astype(np.int32)
CR_TO_GREEN = (-46802 * (_i - 128)).astype(np.int32)
CB_TO_GREEN = (-22554 * (_i - 128) + 32768).astype(np.int32)
