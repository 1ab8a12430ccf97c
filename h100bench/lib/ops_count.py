"""Operations and bytes of the greedy zeroing work, for its roofline.

Frozen copy of chip_smoke.py as of commit bfd8995: compare_block_ops
(lines 271-302), bound_ms (305-314, here in seconds), STATE_BYTES,
CAND_BYTES and greedy_bytes (317-334), the H100 SXM peaks (251-252), and
the evaluation count of phase_greedy (576-577): a block with n zeroing
candidates needs 3 n - 3 evaluations when n >= 2, else n. Here the
count is taken from the inputs of a call into
guetzli_tpu_torch.search.zeroing.compute_zeroing_csr (the candidates are
its blocks' nonzero AC coefficients in the channels of the pass's
mask), never from a kernel's arguments, so a later kernel that replaces
or fuses the greedy kernel is read on the same work.
"""

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def compare_block_ops(mode):
    """Float and integer operations of one block evaluation in `mode`,
    counted from csrc/compare_team.cuh (an 8-term contraction output is 8
    multiplies and 7 adds)."""
    c8 = 15
    idct = 2 * 64 * c8                      # integer: two passes, 1 channel
    ycc = 64 * 12                           # integer color transform
    blur = 3 * 2 * 64 * c8
    clenshaw = 5 * 4 + 3
    gamma = 2 + 2 + 2 * clenshaw + 1
    opsin = 64 * 3 * (6 + gamma + 1 + 6 + 1 + 5)
    mhic = 64 * (6 + 12 + 3 + 2 + 7 + 3 * 4)
    means = 3 * (64 * 2 + 8) + 3 * 4 * 16
    low_freq = 5 * (9 + 9)
    fft = 64 * 2 * c8 + 64 * 4 * c8 + 64 * 6
    ac = 4 * fft + 3 * (64 * 2) + 64 * 20
    tail = 16
    finish = blur + opsin + mhic + means + low_freq + ac + tail
    if mode == "444":
        return {"float": finish, "int": 3 * idct + ycc}
    if mode == "420y":
        return {"float": finish, "int": idct + ycc}
    # 420c: two chroma IDCTs; per sub-block pixel, two upsampled dithered
    # chroma bytes (4 neighbourhood reads, 3 multiplies, 3 adds, 2 shifts
    # and the 2-op dither each) and the color transform; four float
    # stages and the max.
    if mode == "444p":
        # Kernel C: mode 444 plus the selection contractions, two passes
        # over three channels of 64 outputs.
        return {"float": finish, "int": 3 * idct + ycc + 2 * 3 * 64 * c8}
    up = 2 * 64 * 10
    return {"float": 4 * finish + 4, "int": 2 * idct + 4 * (up + ycc)}


def bound_s(mode, n_evals, n_bytes):
    """The least time for the work: the larger of the operations over the
    float32 peak and the bytes over the memory rate. Returns (s, by)."""
    ops = compare_block_ops(mode)
    t_ops = n_evals * (ops["float"] + ops["int"]) / PEAK_FP32
    t_bytes = n_bytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


# (A' reads the Y plane of the candidates, A'' the two chroma planes) and
# its output written once. Greedy loops: coefficients, order, count and
# limit, the state, and the two [192] rails.
STATE_BYTES = {"444": 192 * 4 + 3 * 4 + 2 * 4,
               "420y": 128 * 4 + 192 * 4 + 3 * 4 + 2 * 4,
               "420c": 200 * 4 + 256 * 4 + 4 * 192 * 4 + 12 * 4 + 12 * 4}
CAND_BYTES = {"444": 192 * 4, "420y": 64 * 4, "420c": 128 * 4}
# Kernel C per lane: cand and xyb0 [3, 64], scales [3], sy and sx [8, 8].
STATE_BYTES["444p"] = 192 * 4 + 3 * 4 + 2 * 64 * 4
CAND_BYTES["444p"] = 192 * 4


def compare_bytes(mode):
    return CAND_BYTES[mode] + STATE_BYTES[mode] + 4


def greedy_bytes(mode):
    return 2 * 192 * 4 + 8 + STATE_BYTES[mode] + 192 * 8


def zeroing_work(blocks, comp_mask, mode):
    """(evaluations, bytes, blocks) that a compute_zeroing_csr call on
    `blocks` ([NB, 3, 64] int coefficients) needs in `mode`."""
    blocks = np.asarray(blocks)
    nb = blocks.shape[0]
    chan_ok = np.array([(comp_mask >> c) & 1 for c in range(3)], bool)
    valid = (blocks != 0) & chan_ok[None, :, None]
    valid[:, :, 0] = False
    nrem = valid.reshape(nb, -1).sum(axis=1).astype(np.int64)
    evals = int(np.where(nrem >= 2, 3 * nrem - 3, nrem).sum())
    return evals, nb * greedy_bytes(mode), nb
