"""The constant table buffer of the CUDA block compare.

csrc/compare_block.cuh reads every matrix and scalar of the chain from
one float32 buffer (kept in shared memory), laid out as LAYOUT says. The
values are the plain version's own (ops/tiles_lanes.py and the modules it
calls), rounded to float32 exactly as it rounds them, so the kernel and
the plain version use the same numbers.
"""

import numpy as np
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import opsin
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.ops.image import srgb_table

_F32 = np.float32

# name -> (offset, length); mirrored by the #defines of compare_block.cuh.
LAYOUT = {
    "T_IDCT": (0, 64), "T_BLUR": (64, 64), "T_DFT_RE": (128, 64),
    "T_DFT_IM": (192, 64), "T_CSF": (256, 64), "T_SRGB": (320, 256),
    "T_SCAL": (576, 58), "T_LFDY_LUT": (640, 21), "T_HFDY_LUT": (661, 21),
}
SCALARS = {
    "S_MIX": 0, "S_BIAS": 9, "S_XYB": 12, "S_GMIN": 21, "S_GRANGE": 22,
    "S_GP": 23, "S_GQ": 29, "S_RED": 35, "S_CHROMA": 38, "S_LF_Y2Z": 39,
    "S_LF_ZMUL": 40, "S_LF_XMUL": 41, "S_LF_YMUL": 42, "S_LFDY": 43,
    "S_HFDY": 46, "S_CSF0": 49, "S_FFTMUL": 50, "S_ACX": 51, "S_ACZ": 52,
    "S_ACY": 53, "S_ACY2": 54, "S_YLIM": 55, "S_EW": 56, "S_1MEW": 57,
}
# The closed forms' kernels load the first N_CLOSED entries into shared
# memory; the table forms' (GUETZLI_TPU_EXACT_LUT) all N_TABLES, the two
# DY tables included.
N_CLOSED = 640
N_TABLES = 682


def _scalars():
    s = np.zeros(LAYOUT["T_SCAL"][1], dtype=np.float32)
    s[0:9] = consts.OPSIN_MIX.astype(np.float32).ravel()
    s[9:12] = consts.OPSIN_BIAS.astype(np.float32)
    s[12:21] = consts.RGB_TO_XYB.astype(np.float32).ravel()
    s[21] = _F32(consts.GAMMA_MIN_VALUE)
    s[22] = opsin._GAMMA_RANGE
    s[23:29] = consts.GAMMA_P.astype(np.float32)
    s[29:35] = consts.GAMMA_Q.astype(np.float32)
    s[35:38] = consts.MHIC_REDUCTION.astype(np.float32)
    s[38] = _F32(consts.MHIC_CHROMA_BALANCE)
    s[39] = _F32(consts.XYB_LF_Y_TO_Z)
    s[40] = _F32(consts.XYB_LF_ZMUL)
    s[41] = _F32(consts.XYB_LF_XMUL)
    s[42] = _F32(consts.XYB_LF_YMUL)
    s[43:46] = bd.LF_DY
    s[46:49] = bd.HF_DY
    s[49] = _F32(consts.CSF8X8[0])
    s[50] = _F32(consts.FFT_GLOBAL_MUL)
    s[51] = _F32(consts.BLOCKDIFF_AC_XMUL)
    s[52] = _F32(consts.BLOCKDIFF_AC_ZMUL)
    s[53] = _F32(consts.BLOCKDIFF_AC_YMUL)
    s[54] = _F32(consts.BLOCKDIFF_AC_YMUL2)
    s[55] = _F32(consts.BLOCKDIFF_Y_LIMIT)
    s[56] = tl.BLOCK_EDGE_W
    s[57] = tl.ONE_MINUS_EDGE_W
    return s


def build(device) -> torch.Tensor:
    """The [N_TABLES] float32 table buffer on `device`. The sRGB->linear
    entries are image.srgb_table on that device, the table the plain
    version reads; the LF and HF DY tables are read by the table forms'
    kernels, as the plain version reads them under
    GUETZLI_TPU_EXACT_LUT=1."""
    buf = np.zeros(N_TABLES, dtype=np.float32)
    buf[0:64] = consts.IDCT_MATRIX.astype(np.float32).ravel()
    buf[64:128] = tl._BLUR8.ravel()
    buf[128:192] = bd.DFT8_RE.ravel()
    buf[192:256] = bd.DFT8_IM.ravel()
    buf[256:320] = tl.CSF_D.ravel()
    buf[576:576 + LAYOUT["T_SCAL"][1]] = _scalars()
    buf[640:661] = consts.LF_COLOR_DIFF_DY.astype(np.float32)
    buf[661:682] = consts.HF_COLOR_DIFF_DY.astype(np.float32)
    out = torch.as_tensor(buf, device=device)
    out[320:576] = srgb_table(device)
    return out
