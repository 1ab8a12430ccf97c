"""Kernels B, B' and B'': the whole greedy zeroing search of every block.

Port of guetzli_tpu/kernels/zeroing_loop.py (zeroing_loop_lanes) in its
three modes: "444" (B, 8x8 blocks of all three channels), "420y" (B',
the 4:2:0 Y pass over 8x8 Y blocks against frozen chroma) and "420c"
(B'', the 4:2:0 chroma pass over 16x16 macroblocks against frozen Y).
The CUDA kernels are csrc/zeroing_loop.cu: all three run one CTA per
block or macroblock (csrc/compare_team.cuh);
``zeroing_loop_plain`` below is their plain PyTorch version. The plain
loop takes the block evaluator as an argument: with the plain compare
of the mode (ops/tiles_lanes.COMPARE) it is the kernels' twin; with
kernel A of the mode
(kernels/tile_compare_lanes.tile_compare_lanes) it is the staged loop of
search/zeroing.py, whose rails equal the fused kernel's bit for bit.

``zeroing_loop`` runs the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from functools import partial

import torch

from guetzli_tpu_torch.kernels import build
from guetzli_tpu_torch.kernels.tile_compare_lanes import (check, check_aux,
                                                          count_launch,
                                                          exact_variant,
                                                          geometry,
                                                          table_buffer)
from guetzli_tpu_torch.ops.tiles_lanes import COMPARE

K = 192  # 3 * 64 candidate slots per block

# Kernel launches per mode since the last reset (a caller may zero them),
# and those of the EXACT_LUT variants.
launches = {"444": 0, "420y": 0, "420c": 0}
exact_launches = {"444": 0, "420y": 0, "420c": 0}

# The C entry point (csrc/zeroing_loop.cu) of each mode.
ENTRY = {"444": "zeroing_loop", "420y": "zeroing_loop_420y",
         "420c": "zeroing_loop_420c"}

# The team kernels' index in gt_zeroing_loop_geometry.
TEAM = {"444": 0, "420c": 1, "420y": 2}


def zeroing_loop_plain(coeffs_t, order_t, nrem, lim, aux, mode="444",
                       lookahead=3, early_exit=False, evaluate=None):
    """The greedy loop on lane-major state, as whole-tensor steps.

    Each step advances every block that still has candidates: evaluate
    its next `lookahead` candidates zeroed (only those below its remaining
    count), take the strict-< argmin (ties keep the earlier), commit the
    zero, shift the order list up from the chosen position, and write
    (index, error) into row t of the rails. `evaluate(cand [3, 8, 8, M],
    *aux_lanes)` scores candidates (default: the mode's plain compare).
    Arguments and results as ``zeroing_loop``."""
    evaluate = evaluate or COMPARE[mode]
    dev = coeffs_t.device
    n = coeffs_t.shape[1]
    coeffs = coeffs_t.clone()       # updated in place below
    order = order_t.clone()
    rem = nrem.clone()
    out_idx = torch.zeros((K, n), dtype=torch.int32, device=dev)
    out_err = torch.full((K, n), float("inf"), dtype=torch.float32,
                         device=dev)
    rows = torch.arange(K, device=dev)[:, None]
    for t in range(K):
        act = torch.nonzero(rem > 0).flatten()
        na = act.numel()
        if na == 0:
            break
        c = coeffs[:, act]
        o = order[:, act]
        r = rem[act]
        # All lookahead candidates below the remaining count, in one call.
        lanes, cols, cands = [], [], []
        for l in range(lookahead):
            sel = torch.nonzero(r > l).flatten()
            if sel.numel() == 0:
                break
            cs = c[:, sel]
            cands.append(torch.where(rows == o[l, sel][None, :],
                                     torch.zeros_like(cs), cs))
            lanes.append(torch.full_like(sel, l))
            cols.append(sel)
        lane = torch.cat(lanes)
        col = torch.cat(cols)
        blk = act[col]
        errs = evaluate(torch.cat(cands, 1).reshape(3, 8, 8, -1),
                        *[a[..., blk].contiguous() for a in aux])
        grid = torch.full((lookahead, na), float("inf"), device=dev)
        grid[lane, col] = errs
        best_err = grid[0]
        best_l = torch.zeros(na, dtype=torch.int64, device=dev)
        for l in range(1, lookahead):
            upd = grid[l] < best_err
            best_err = torch.where(upd, grid[l], best_err)
            best_l = torch.where(upd, torch.full_like(best_l, l), best_l)
        best_idx = o.gather(0, best_l[None, :])[0]
        coeffs[:, act] = torch.where(rows == best_idx[None, :],
                                     torch.zeros_like(c), c)
        shifted = torch.cat([o[1:], o[-1:]])
        order[:, act] = torch.where(rows >= best_l[None, :], shifted, o)
        out_idx[t, act] = best_idx
        out_err[t, act] = best_err
        if early_exit:
            rem[act] = torch.where(best_err >= lim[act],
                                   torch.zeros_like(r), r - 1)
        else:
            rem[act] = r - 1
    return out_idx, out_err


def zeroing_loop(coeffs_t, order_t, nrem, lim, aux, mode="444",
                 lookahead=3, early_exit=False, exact_lut=None):
    """Run every block's greedy zeroing loop.

    coeffs_t: [192, N] int32 dequantized coefficients (row c*64+k);
    order_t: [192, N] int32 score-sorted candidate order; nrem: [N] int32
    candidate counts; lim: [N] float32 error limits (read with early_exit
    only); aux: the mode's lane-major frozen state
    (kernels/tile_compare_lanes.aux_specs); exact_lut: the DY reads by
    table (None: GUETZLI_TPU_EXACT_LUT).
    Returns (out_idx [192, N] int32, out_err [192, N] float32): row t of
    block b holds the t-th zeroed slot and the block error after it;
    rows past the block's last step hold (0, +inf)."""
    n = coeffs_t.shape[-1]
    dev = coeffs_t.device
    check(coeffs_t, "coeffs_t", torch.int32, (K, n), dev)
    check(order_t, "order_t", torch.int32, (K, n), dev)
    check(nrem, "nrem", torch.int32, (n,), dev)
    check(lim, "lim", torch.float32, (n,), dev)
    check_aux(aux, mode, n, dev)
    exact = exact_variant(exact_lut)
    if dev.type == "cpu":
        return zeroing_loop_plain(
            coeffs_t, order_t, nrem, lim, aux, mode, lookahead, early_exit,
            partial(COMPARE[mode], exact_lut=exact))
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    fn = build.load(ENTRY[mode])
    tab = table_buffer(dev)
    out_idx = torch.empty((K, n), dtype=torch.int32, device=dev)
    out_err = torch.empty((K, n), dtype=torch.float32, device=dev)
    rc = fn(coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
            lim.data_ptr(), *[a.data_ptr() for a in aux], tab.data_ptr(),
            out_idx.data_ptr(), out_err.data_ptr(), n, lookahead,
            int(bool(early_exit)), int(exact),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d"
                           % (ENTRY[mode], rc))
    count_launch(exact_launches if exact else launches, mode)
    return out_idx, out_err


def team_geometry(mode, device):
    """The launch geometry of greedy kernel `mode` ("444": B, "420y": B',
    "420c": B'') on `device` (see tile_compare_lanes.geometry)."""
    return geometry("zeroing_loop_geometry", TEAM[mode], device)
