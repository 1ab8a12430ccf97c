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

The JAX package's routes, chosen by its variables at call time:
GUETZLI_TPU_ZEROING_FUSED=0 runs every pass on the staged loop, and
GUETZLI_TPU_PALLAS=0 the 4:4:4 pass (fused_wanted). The staged loop
compacts the active lanes at every step, which is what JAX's stage
ladder of fixed sizes (_staged_core) does for a compiled program, so the
port keeps one staged loop and no ladder. GUETZLI_TPU_LANES=0 makes the
staged and full-batch loops evaluate blocks-leading (ops/tiles.py; the
fused route ignores it, as in JAX). GUETZLI_TPU_STAGED_ZEROING=0 is the
full-batch route, compute_zeroing_order: no count sort, the rails pulled
whole, the CSR built on the host (csr_from_zeroing).
GUETZLI_TPU_ZEROING_DEBUG=1 writes the stage walls to stderr (debug).
The JAX package's mode names map to the port's so: "444l", "444pl" ->
"444" (the lane-major evaluation); "444" -> "444" with LANES=0;
"420yl", "420cl" -> "420y", "420c"; "444p" -> "444p".

Output mirrors the reference contract: per block, the order in which AC
coefficients were zeroed with the (suffix-min) block error after each
removal, cut off at the block error limit, as CSR arrays.
"""

import sys
import time
from functools import partial

import numpy as np
import torch

from guetzli_tpu_torch import config, consts
from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.kernels.tile_compare_lanes import tile_compare_lanes
from guetzli_tpu_torch.ops import tiles as tile_ops
from guetzli_tpu_torch.ops import tiles_lanes as tl

K = 192  # 3 * 64 candidate slots per block


def debug(device, t0, fmt, *args):
    """Under GUETZLI_TPU_ZEROING_DEBUG=1: wait for `device`, write one
    stage line "fmt % args" with the wall since `t0` to stderr, and
    return the time (the next stage's t0); else return t0 untouched."""
    if not config.zeroing_debug():
        return t0
    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize(device)
    now = time.time()
    sys.stderr.write((fmt % args) + " %.2fs\n" % (now - t0))
    return now


def fused_wanted(mode):
    """Whether the mode's greedy kernel (B, B', B'') runs the pass (the
    JAX package's _fused_wanted on an accelerator): never for "444p"
    (kernel C per step of the staged loop) nor under
    GUETZLI_TPU_ZEROING_FUSED=0; under GUETZLI_TPU_PALLAS=0 not for the
    4:4:4 pass (JAX's auto keeps the 4:2:0 passes fused whatever PALLAS
    says); else fused, on both devices (on the CPU the fused loop is the
    kernels' plain twin, with the same rails as the staged loop)."""
    f = config.zeroing_fused()
    if mode == "444p" or f is False:
        return False
    return not (f is None and mode == "444" and config.pallas() == 0)


def _moved_aux(*aux):
    """Frozen state with the block axis moved last, where the loop
    gathers its lanes."""
    return tuple(a.movedim(0, -1).contiguous() for a in aux)


def _lane_aux(mode, lanes=True):
    """The transpose of a mode's frozen state into the loop's operands."""
    if mode == "444p" or not lanes:
        return _moved_aux
    return tl.LANE_AUX[mode]


def _compare_kernel(mode):
    """The mode's block compare kernel over lane-major candidates: C for
    "444p", else A, A' or A''."""
    return (kc.compare_lanes if mode == "444p"
            else partial(tile_compare_lanes, mode=mode))


def _compare_blocks_leading(mode):
    """The mode's blocks-leading compare (ops/tiles.py; the JAX package's
    modes "444", "420y", "420c" of GUETZLI_TPU_LANES=0) on the loop's
    operands: candidates [3, 8, 8, M] and _moved_aux state."""
    def evaluate(cand_t, *aux_l):
        aux = [a.movedim(-1, 0) for a in aux_l]
        cand = cand_t.permute(3, 0, 1, 2).reshape(-1, 3, 64)
        if mode == "444":
            xyb0_tiles, scales, ysel, xsel = aux
            lin = tile_ops.tiles_to_linear_rgb(cand, xsel, ysel)
            return tile_ops.compare_blocks(xyb0_tiles, lin, scales)
        if mode == "420y":
            return tile_ops.compare_blocks_420y(cand[:, 0], *aux)
        return tile_ops.compare_blocks_420c(cand[:, 1], cand[:, 2], *aux)
    return evaluate


def candidate_scores(blocks, orig_blocks, comp_mask, new_model=True):
    """Zeroing priority of each (channel, coeff) slot (processor.cc:
    393-409) of tensors [NB, 3, 64] on any device -> [NB, K] float32 on
    it (JAX search/zeroing.candidate_scores), float32 elementwise. Lower =
    zeroed earlier; invalid slots (DC, zero coefficients, masked channels)
    get +inf."""
    nb = blocks.shape[0]
    dev = blocks.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    absorig = orig_blocks.abs().to(torch.float32)
    if new_model:
        score = absorig * t(consts.ZEROING_CSF)[None] \
            + t(consts.ZEROING_BIAS)[None]
    else:
        zigzag = t(consts.JPEG_ZIGZAG_ORDER)
        score = ((absorig - zigzag[None, None] / 64.0)
                 * t(consts.ZEROING_OLD_WEIGHT)[None, :, None]
                 / t(consts.OLD_CSF)[None, None])
    chan_ok = torch.tensor([bool((comp_mask >> c) & 1) for c in range(3)],
                           device=dev)
    k_ok = torch.arange(64, device=dev) >= 1
    valid = (blocks != 0) & chan_ok[None, :, None] & k_ok[None, None, :]
    return torch.where(valid, score, torch.inf).reshape(nb, K)


def candidate_scores_host(blocks, orig_blocks, comp_mask, new_model=True):
    """candidate_scores of numpy arrays on the host, as numpy."""
    return candidate_scores(torch.as_tensor(np.ascontiguousarray(blocks)),
                            torch.as_tensor(np.ascontiguousarray(orig_blocks)),
                            comp_mask, new_model).numpy()


def _argsort_rows_stable(scores):
    """Row-wise stable argsort of [NB, K] float32, permutation-identical
    to np.argsort(kind='stable'); torch's CPU stable sort runs the rows on
    all host cores at large NB (same by-value stability)."""
    if scores.shape[0] >= 16384:
        return torch.from_numpy(scores).argsort(dim=1, stable=True).numpy()
    return np.argsort(scores, axis=1, kind="stable")


def loop_inputs(blocks, orig_blocks, limit, aux, comp_mask, device,
                mode="444", new_model=True, sort=True, lanes=True):
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
    .zeroing_loop in the count-sorted block order `perm` (`sort` False:
    the blocks' own order, the full-batch loop's). With `lanes` False the
    state keeps its blocks-leading layout, its block axis moved last.
    """
    nb = blocks.shape[0]
    limit = np.asarray(limit, dtype=np.float32)
    chan_ok = np.array([(comp_mask >> c) & 1 for c in range(3)], bool)
    valid = (np.asarray(blocks) != 0) & chan_ok[None, :, None]
    valid[:, :, 0] = False
    n_cand_host = valid.reshape(nb, K).sum(axis=1).astype(np.int64)
    perm = (np.argsort(-n_cand_host, kind="stable") if sort
            else np.arange(nb))
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
    aux_lanes = _lane_aux(mode, lanes)(
        *[torch.as_tensor(a, device=device)[perm_d] for a in aux])
    args = (up(blocks_perm.reshape(nb, K).T.astype(np.int32)), up(order0.T),
            up(n_cand), up(lim_p), aux_lanes)
    return args, perm, inv_perm, limit


def greedy_rails(blocks, orig_blocks, limit, aux, comp_mask, device,
                 mode="444", lookahead=3, new_model=True, early_exit=False,
                 fused=None, sort=True):
    """Run the greedy loop of every block (arguments as loop_inputs).

    `fused` None: fused_wanted(mode). Fused: the mode's kernel B, B' or
    B''. Else the staged loop (zeroing_loop_plain), which compacts the
    active lanes at every step and evaluates them with the mode's compare
    kernel A, A', A'' or C, or under GUETZLI_TPU_LANES=0 with the
    blocks-leading compare of ops/tiles.py (JAX's modes "444", "420y",
    "420c"). Returns (bank_idx, bank_err, perm, inv_perm, limit_np):
    [NB, K] rails on `device` in the block order `perm`."""
    t0 = time.time()
    if fused is None:
        fused = fused_wanted(mode)
    lanes = fused or mode == "444p" or config.lanes()
    args, perm, inv_perm, limit = loop_inputs(
        blocks, orig_blocks, limit, aux, comp_mask, device, mode, new_model,
        sort, lanes)
    t0 = debug(device, t0, "zeroing: nb=%d upload+scores", len(perm))
    if fused:
        out_idx, out_err = zl.zeroing_loop(*args, mode=mode,
                                           lookahead=lookahead,
                                           early_exit=early_exit)
        debug(device, t0, "zeroing-fused: kernel %s (nb %d)",
              zl.ENTRY[mode], len(perm))
    else:
        evaluate = (_compare_kernel(mode) if lanes
                    else _compare_blocks_leading(mode))
        out_idx, out_err = zl.zeroing_loop_plain(
            *args, mode=mode, lookahead=lookahead, early_exit=early_exit,
            evaluate=evaluate)
        debug(device, t0, "zeroing: staged loop (%s, %s) nb=%d",
              mode, "lanes" if lanes else "blocks leading", len(perm))
    if lanes:
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
    t0 = time.time()
    counts = (num - z).cpu().numpy().astype(np.int64)
    t0 = debug(dev, t0, "zeroing-csr: counts pull")
    nbr = len(counts)
    offsets = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    m = int(offsets[-1])
    t0 = debug(dev, t0, "zeroing-csr: host build m=%d", m)
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
    debug(dev, t0, "zeroing-csr: gather pull")
    return offsets, cand_idx, cand_err


def compute_zeroing_csr(blocks, orig_blocks, limit, aux, comp_mask, device,
                        mode="444", real_index=None, lookahead=3,
                        new_model=True, early_exit=False, fused=None,
                        bands=None, factor=1):
    """Greedy zeroing of every block + CSR compaction on the rails'
    device (the port of compute_zeroing_csr_staged). See greedy_rails
    (`fused` None: fused_wanted) and csr_from_rails.
    Under a mesh (`bands`, parallel/mesh.RowBands; exact geometry) the
    greedy loop runs on this rank's rows of the pass's grid alone (its
    blocks are 8 * `factor` pixels high: 1 for the 4:4:4 and 4:2:0 Y
    passes, 2 for the chroma pass's macroblocks), with `aux` the
    comparator's state of those rows, and the rails of every rank are
    gathered before the compaction, so every rank builds the same CSR."""
    if bands is not None:
        idx, err, limit = _banded_rails(
            blocks, orig_blocks, limit, aux, comp_mask, device, mode,
            lookahead, new_model, early_exit, fused, True,
            bands.span(8 * factor))
        ident = np.arange(blocks.shape[0], dtype=np.int64)
        return csr_from_rails(idx, err, ident, ident, limit)
    if blocks.shape[0] == 0:
        n = 0 if real_index is None else len(real_index)
        return (np.zeros(n + 1, np.int64), np.empty(0, np.int32),
                np.empty(0, np.float32))
    rails = greedy_rails(blocks, orig_blocks, limit, aux, comp_mask, device,
                         mode, lookahead, new_model, early_exit, fused)
    return csr_from_rails(*rails, real_index=real_index)


def compute_zeroing_order(blocks, orig_blocks, limit, aux, comp_mask,
                          device, mode="444", real_index=None, lookahead=3,
                          new_model=True, early_exit=False, bands=None,
                          factor=1):
    """The full-batch route (GUETZLI_TPU_STAGED_ZEROING=0; JAX
    compute_zeroing_order_with): the staged loop over every block in its
    own order, no count sort, its rails pulled whole to the host, where
    the suffix-min and the cut at the limit run (processor.cc:467-479).
    Arguments as compute_zeroing_csr. Returns numpy (out_idx [NBR, K]
    int32, out_err [NBR, K] float32 suffix-minimized, num [NBR] int32)
    of the rows real_index (all when None); csr_from_zeroing compacts
    them."""
    limit = np.asarray(limit, dtype=np.float32)
    if bands is not None:
        idx, err, limit = _banded_rails(
            blocks, orig_blocks, limit, aux, comp_mask, device, mode,
            lookahead, new_model, early_exit, False, False,
            bands.span(8 * factor))
    elif blocks.shape[0] == 0:
        idx = torch.zeros((0, K), dtype=torch.int32)
        err = torch.zeros((0, K), dtype=torch.float32)
    else:
        idx, err, _perm, _inv, limit = greedy_rails(
            blocks, orig_blocks, limit, aux, comp_mask, device, mode,
            lookahead, new_model, early_exit, fused=False, sort=False)
    t0 = time.time()
    idx, err = idx.cpu().numpy(), err.cpu().numpy()
    debug(device, t0, "zeroing: rails pull [%d, %d]", *err.shape)
    if real_index is not None:
        idx, err = idx[real_index], err[real_index]
        if limit.ndim:
            limit = limit[real_index]
    rev = np.minimum.accumulate(err[:, ::-1], axis=1)[:, ::-1]
    lim = limit[:, None] if limit.ndim else limit
    num = (rev <= lim).sum(axis=1).astype(np.int32)
    return idx, np.ascontiguousarray(rev), num


def csr_from_zeroing(out_idx, out_err, num, limit):
    """CSR candidate arrays (processor.cc:694-716) of host rails (JAX
    Processor.csr_from_zeroing): per row the slots below `num` with an
    error in (0, limit], the float32 limit a scalar or one per row. The
    same arrays as csr_from_rails of the same rails."""
    limit = np.asarray(limit, dtype=np.float32)
    lim = limit[:, None] if limit.ndim else limit
    slot = np.arange(out_err.shape[1])[None, :]
    sel = (slot < num[:, None]) & (out_err > 0) & (out_err <= lim)
    offsets = np.zeros(len(num) + 1, dtype=np.int64)
    np.cumsum(sel.sum(axis=1), out=offsets[1:])
    return (offsets, out_idx[sel].astype(np.int32),
            out_err[sel].astype(np.float32))


def _banded_rails(blocks, orig_blocks, limit, aux, comp_mask, device, mode,
                  lookahead, new_model, early_exit, fused, sort, bs):
    """The greedy loop of this rank's block rows (bs, a Span of the
    pass's grid), the rails all-gathered in block order: (idx, err [NB,
    K] on `device`, limit). The blocks are independent, so each block's
    rails are those of the single-device loop."""
    bw = blocks.shape[0] // bs.size
    sl = slice(bs.lo * bw, bs.hi * bw)
    limit = np.asarray(limit, dtype=np.float32)
    if bs.n:
        idx, err, _perm, inv_perm, _lim = greedy_rails(
            blocks[sl], orig_blocks[sl], limit[sl] if limit.ndim else limit,
            aux, comp_mask, device, mode, lookahead, new_model, early_exit,
            fused, sort)
        back = torch.as_tensor(inv_perm, dtype=torch.int64, device=device)
        idx, err = idx[back], err[back]
    else:
        idx = torch.zeros((0, K), dtype=torch.int32, device=device)
        err = torch.zeros((0, K), dtype=torch.float32, device=device)
    counts = [c * bw for c in bs.counts()]
    idx = bs.group.all_gather_rows(idx.contiguous(), counts)
    err = bs.group.all_gather_rows(err.contiguous(), counts)
    return idx, err, limit
