"""Per-block greedy coefficient zeroing: 4:4:4, and the two 4:2:0 passes.

Port of guetzli_tpu/search/zeroing.py (compute_zeroing_csr_staged with the
fused kernel core). Reference: Processor::ComputeBlockZeroingOrder
(processor.cc:376-487) and its GPU twin clComputeBlockZeroingOrderEx
(clguetzli.cl:752-879), which runs one work-item per block.

A mode names the block evaluation (the JAX package's _kmode): "444" for
8x8 blocks of all channels, "420y" for the 4:2:0 Y pass, "420c" for the
4:2:0 chroma pass over 16x16 macroblocks. "444p" (opt-in,
GUETZLI_TPU_PALLAS=1) is "444" evaluated by kernel C over blocks-leading
operands with the edge replication as selection matrices; it always runs
the staged loop (the JAX package keeps matrix-aux modes off its fused
kernel too), and its rails equal mode "444"'s bit for bit.

Host preamble: candidate counts, a descending-count block sort (the
threads of a warp then run similar trip counts), candidate scores and the
initial order (a stable row argsort). Device: the greedy loop -- kernel B
of the mode (``fused=True``, the main path) or the staged loop, a
whole-tensor loop whose per-step evaluation launches the mode's kernel A
(``fused=False``) -- and the CSR compaction of the rails. Both give
bit-identical rails on the card.

Output mirrors the reference contract: per block, the order in which AC
coefficients were zeroed with the (suffix-min) block error after each
removal, cut off at the block error limit, as CSR arrays.
"""

from functools import partial

import numpy as np
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.kernels.tile_compare_lanes import tile_compare_lanes
from guetzli_tpu_torch.ops import tiles_lanes as tl

K = 192  # 3 * 64 candidate slots per block


def _lane_aux(mode):
    """The transpose of a mode's frozen state into the loop's operands."""
    return kc.lanes_aux if mode == "444p" else tl.LANE_AUX[mode]


def _compare_kernel(mode):
    """The mode's block compare kernel over lane-major candidates: C for
    "444p", else A, A' or A''."""
    return (kc.compare_lanes if mode == "444p"
            else partial(tile_compare_lanes, mode=mode))


def candidate_scores_host(blocks, orig_blocks, comp_mask, new_model=True):
    """Zeroing priority of each (channel, coeff) slot (processor.cc:
    393-409), float32 elementwise. Lower = zeroed earlier; invalid slots
    (DC, zero coefficients, masked channels) get +inf."""
    nb = blocks.shape[0]
    absorig = np.abs(orig_blocks).astype(np.float32)
    if new_model:
        score = (absorig * np.float32(consts.ZEROING_CSF)[None]
                 + np.float32(consts.ZEROING_BIAS)[None])
    else:
        zigzag = consts.JPEG_ZIGZAG_ORDER.astype(np.float32)
        score = ((absorig - zigzag[None, None] / np.float32(64.0))
                 * np.float32(consts.ZEROING_OLD_WEIGHT)[None, :, None]
                 / np.float32(consts.OLD_CSF)[None, None])
    chan_ok = np.array([(comp_mask >> c) & 1 for c in range(3)], bool)
    k_ok = np.arange(64) >= 1
    valid = (blocks != 0) & chan_ok[None, :, None] & k_ok[None, None, :]
    return np.where(valid, score, np.inf).reshape(nb, K)


def _argsort_rows_stable(scores):
    """Row-wise stable argsort of [NB, K] float32, permutation-identical
    to np.argsort(kind='stable'); torch's CPU stable sort runs the rows on
    all host cores at large NB (same by-value stability)."""
    if scores.shape[0] >= 16384:
        return torch.from_numpy(scores).argsort(dim=1, stable=True).numpy()
    return np.argsort(scores, axis=1, kind="stable")


def loop_inputs(blocks, orig_blocks, limit, aux, comp_mask, device,
                mode="444", new_model=True):
    """The host preamble: the greedy loop's lane-major operands.

    blocks, orig_blocks: [NB, 3, 64] int32 numpy (current and original
    dequantized coefficients); limit: scalar or [NB] float32; aux: the
    pass's frozen per-block state on `device`, blocks leading, as the
    comparator builds it for `mode`:
      "444":  (xyb0_tiles [NB, 3, 64] f32, scales [NB, 3] f32,
               ysel [NB, 8], xsel [NB, 8])  (Comparator.block_state);
      "420y": (chroma_bytes [NB, 2, 8, 8],) + the "444" state;
      "420c": (neigh_u, neigh_v [NB, 10, 10], y16 [NB, 16, 16])
              + Comparator.children_state;
      "444p": (xyb0_tiles, scales, sy [NB, 8, 8], sx [NB, 8, 8])
              (kernels/tile_compare.selection_matrices).
    Returns (args, perm, inv_perm, limit_np): args = (coeffs_t, order_t,
    nrem, lim, aux_lanes) are the operands of kernels/zeroing_loop
    .zeroing_loop in the count-sorted block order `perm`."""
    nb = blocks.shape[0]
    limit = np.asarray(limit, dtype=np.float32)
    chan_ok = np.array([(comp_mask >> c) & 1 for c in range(3)], bool)
    valid = (np.asarray(blocks) != 0) & chan_ok[None, :, None]
    valid[:, :, 0] = False
    n_cand_host = valid.reshape(nb, K).sum(axis=1).astype(np.int64)
    perm = np.argsort(-n_cand_host, kind="stable")
    inv_perm = np.argsort(perm)

    blocks_perm = np.asarray(blocks)[perm]
    scores_h = candidate_scores_host(blocks_perm,
                                     np.asarray(orig_blocks)[perm],
                                     comp_mask, new_model)
    order0 = _argsort_rows_stable(scores_h).astype(np.int32)
    n_cand = np.isfinite(scores_h).sum(axis=1).astype(np.int32)
    lim_p = (limit[perm] if limit.ndim == 1
             else np.full(nb, limit, np.float32))

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    perm_d = up(perm)
    aux_lanes = _lane_aux(mode)(
        *[torch.as_tensor(a, device=device)[perm_d] for a in aux])
    args = (up(blocks_perm.reshape(nb, K).T.astype(np.int32)), up(order0.T),
            up(n_cand), up(lim_p), aux_lanes)
    return args, perm, inv_perm, limit


def greedy_rails(blocks, orig_blocks, limit, aux, comp_mask, device,
                 mode="444", lookahead=3, new_model=True, early_exit=False,
                 fused=True):
    """Run the greedy loop of every block (arguments as loop_inputs).
    Mode "444p" runs the staged loop whatever `fused` says.
    Returns (bank_idx, bank_err, perm, inv_perm, limit_np): [NB, K] rails
    on `device` in the count-sorted block order `perm`."""
    args, perm, inv_perm, limit = loop_inputs(
        blocks, orig_blocks, limit, aux, comp_mask, device, mode, new_model)
    if fused and mode != "444p":
        out_idx, out_err = zl.zeroing_loop(*args, mode=mode,
                                           lookahead=lookahead,
                                           early_exit=early_exit)
    else:
        out_idx, out_err = zl.zeroing_loop_plain(
            *args, mode=mode, lookahead=lookahead, early_exit=early_exit,
            evaluate=_compare_kernel(mode))
    check_final_errors(args[0], out_idx, out_err, args[4], mode)
    return out_idx.T, out_err.T, perm, inv_perm, limit


def check_final_errors(coeffs_t, out_idx, out_err, aux_lanes, mode="444"):
    """Re-evaluate each block with all its zeroed slots applied, in one
    launch of the mode's compare kernel (A, A', A'' or C), and require the
    loop's last error bit for bit (the kernels share compare_team.cuh).
    One evaluation per block against the loop's ~3 per step: a fault in
    the greedy loop surfaces here as an error instead of a wrong JPEG."""
    n = coeffs_t.shape[1]
    done = torch.isfinite(out_err)                     # [K, N]
    steps = done.sum(0)
    rows = torch.where(done, out_idx.long(), torch.full_like(out_idx, K,
                                                             dtype=torch.long))
    final = torch.cat([coeffs_t, coeffs_t.new_zeros((1, n))])
    final.scatter_(0, rows, 0)                         # in place: a copy
    errs = _compare_kernel(mode)(
        final[:K].reshape(3, 8, 8, n).contiguous(), *aux_lanes)
    last = out_err.gather(0, (steps - 1).clamp(min=0)[None])[0]
    bad = (steps > 0) & (errs != last)
    if bool(bad.any()):
        raise RuntimeError(
            "zeroing loop (mode %s) disagrees with the block compare on %d "
            "of %d blocks" % (mode, int(bad.sum()), n))


def csr_from_rails(bank_idx, bank_err, perm, inv_perm, limit_np,
                   real_index=None):
    """CSR candidate arrays (processor.cc:694-716) from the banked rails,
    compacted on the rails' device: suffix-min the errors (processor.cc:
    467-472), keep the slots at or below the limit with a nonzero error.

    real_index: optional [NBR] map from output row to input block row
    (identity when None). Returns (offsets [NBR+1] int64, cand_idx [M]
    int32, cand_err [M] float32) as numpy."""
    dev = bank_err.device
    nb = len(perm)
    if real_index is None:
        real_index = np.arange(nb, dtype=np.int64)
    lookup = torch.as_tensor(inv_perm[np.asarray(real_index)],
                             dtype=torch.int64, device=dev)
    err_r = bank_err[lookup]
    rev = err_r.flip(1).cummin(1).values.flip(1)
    if limit_np.ndim == 0:
        lim = float(limit_np)
    else:
        lim = torch.as_tensor(limit_np[perm], device=dev)[lookup][:, None]
    num = (rev <= lim).sum(1)
    z = torch.minimum((rev <= 0.0).sum(1), num)
    counts = (num - z).cpu().numpy().astype(np.int64)
    nbr = len(counts)
    offsets = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    m = int(offsets[-1])
    if m == 0:
        return offsets, np.empty(0, np.int32), np.empty(0, np.float32)
    # Selected slots of row r are the range [z[r], num[r]).
    rows = torch.repeat_interleave(
        torch.arange(nbr, device=dev), torch.as_tensor(counts, device=dev))
    within = (torch.arange(m, device=dev)
              - torch.as_tensor(np.repeat(offsets[:-1], counts),
                                device=dev))
    cols = z[rows] + within
    cand_idx = bank_idx[lookup[rows], cols].cpu().numpy().astype(np.int32)
    cand_err = rev[rows, cols].cpu().numpy().astype(np.float32)
    return offsets, cand_idx, cand_err


def compute_zeroing_csr(blocks, orig_blocks, limit, aux, comp_mask, device,
                        mode="444", real_index=None, lookahead=3,
                        new_model=True, early_exit=False, fused=True,
                        bands=None):
    """Greedy zeroing of every block + CSR compaction (the port of
    compute_zeroing_csr_staged). See greedy_rails and csr_from_rails.
    Under a mesh (`bands`, parallel/mesh.RowBands; 4:4:4, exact
    geometry) the greedy loop runs on this rank's block rows alone, with
    `aux` the comparator's state of those rows, and the rails of every
    rank are gathered before the compaction, so every rank builds the
    same CSR."""
    if bands is not None:
        return _zeroing_csr_banded(blocks, orig_blocks, limit, aux,
                                   comp_mask, device, mode, lookahead,
                                   new_model, early_exit, fused, bands)
    if blocks.shape[0] == 0:
        n = 0 if real_index is None else len(real_index)
        return (np.zeros(n + 1, np.int64), np.empty(0, np.int32),
                np.empty(0, np.float32))
    rails = greedy_rails(blocks, orig_blocks, limit, aux, comp_mask, device,
                         mode, lookahead, new_model, early_exit, fused)
    return csr_from_rails(*rails, real_index=real_index)


def _zeroing_csr_banded(blocks, orig_blocks, limit, aux, comp_mask, device,
                        mode, lookahead, new_model, early_exit, fused,
                        bands):
    """compute_zeroing_csr of this rank's block rows, the rails
    all-gathered in block order. The blocks are independent, so each
    block's rails are those of the single-device loop."""
    bs = bands.blocks()
    bw = blocks.shape[0] // bs.size
    sl = slice(bs.lo * bw, bs.hi * bw)
    limit = np.asarray(limit, dtype=np.float32)
    if bs.n:
        idx, err, _perm, inv_perm, _lim = greedy_rails(
            blocks[sl], orig_blocks[sl], limit[sl] if limit.ndim else limit,
            aux, comp_mask, device, mode, lookahead, new_model, early_exit,
            fused)
        back = torch.as_tensor(inv_perm, dtype=torch.int64, device=device)
        idx, err = idx[back], err[back]
    else:
        idx = torch.zeros((0, K), dtype=torch.int32, device=device)
        err = torch.zeros((0, K), dtype=torch.float32, device=device)
    counts = [c * bw for c in bs.counts()]
    idx = bands.group.all_gather_rows(idx.contiguous(), counts)
    err = bands.group.all_gather_rows(err.contiguous(), counts)
    ident = np.arange(blocks.shape[0], dtype=np.int64)
    return csr_from_rails(idx, err, ident, ident, limit)
