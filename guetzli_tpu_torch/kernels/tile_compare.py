"""Kernel C: the per-block compare over blocks-leading candidates, with the
edge replication as per-block 0/1 selection contractions.

Port of guetzli_tpu/kernels/tile_compare.py (_tile_compare_pallas, body
_kernel, helper _selection_matrices). The CUDA kernel is
csrc/tile_compare.cu, a team compare like kernel A: one CTA of 64 threads
per block loads the block's contiguous operands into shared memory and
runs the evaluation of csrc/compare_team.cuh, whose pixel stage for C
contracts with the selection matrices. ``tile_compare_plain`` below is its
plain PyTorch version. For one-hot selection matrices the contraction
equals the clamp gather of kernel A in int32, so C equals A bit for bit on
the same blocks.

Two users: ``--checkcuda`` (checkcl.run_checkcl) and the opt-in zeroing
mode "444p" (GUETZLI_TPU_PALLAS=1; search/zeroing.py runs the staged
greedy loop with C per step, through ``compare_lanes``).

``tile_compare`` runs the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

import torch

from guetzli_tpu_torch.kernels import build
from guetzli_tpu_torch.kernels.tile_compare_lanes import (check, geometry,
                                                          table_buffer)
from guetzli_tpu_torch.ops import tiles_lanes as tl

# Kernel launches since the last reset (a caller may zero it).
launches = 0

# The C entry point (csrc/tile_compare.cu).
ENTRY = "tile_compare"

_F32 = torch.float32
_I32 = torch.int32


def selection_matrices(ysel, xsel):
    """[N, 8] clamped gather indices -> (sy, sx), [N, 8, 8] int32 0/1
    selection matrices on the indices' device: row i of a block's sy has
    its one at column ysel[i]."""
    ysel = torch.as_tensor(ysel)
    xsel = torch.as_tensor(xsel)
    eye = torch.arange(8, device=ysel.device)
    sy = (ysel[:, :, None] == eye).to(_I32)
    sx = (xsel[:, :, None] == eye).to(_I32)
    return sy, sx


def _select(sel, v, axis):
    """out[.., i, ..] = sum_j sel[i, j, n] * v[.., j, .., n] over `axis`,
    in int32, j in order: sel [8, 8, N] per-lane matrices, v [..., N]."""
    vm = v.movedim(axis, 0)                               # [8(j), ..., N]
    s = sel.reshape((8, 8) + (1,) * (vm.dim() - 2) + (sel.shape[-1],))
    prod = s * vm.unsqueeze(0)                            # [8(i), 8(j), ...]
    acc = prod[:, 0]
    for j in range(1, 8):
        acc = acc + prod[:, j]
    return acc.movedim(0, axis)


def tile_compare_plain(cand, xyb0_tiles, scales, sy, sx):
    """The plain PyTorch version of kernel C, in its order: the integer
    IDCT, the selection contractions (rows by sy, then columns by sx), the
    color transform, then the lane-major float stage
    (ops/tiles_lanes.finish_lanes) on the transposed block, in closed form
    whatever GUETZLI_TPU_EXACT_LUT says (the JAX kernel has its own closed
    forms). Arguments and result as ``tile_compare``."""
    n = cand.shape[0]
    v = tl.idct_lanes(cand.reshape(n, 3, 8, 8).permute(1, 2, 3, 0))
    v = _select(sy.permute(1, 2, 0), v, -3)               # rows (y)
    v = _select(sx.permute(1, 2, 0), v, -2)               # columns (x)
    rgb = tl.ycbcr_to_rgb_lanes(v[0], v[1], v[2])
    x0 = xyb0_tiles.reshape(n, 3, 8, 8).permute(1, 2, 3, 0)
    return tl.finish_lanes(rgb, x0, scales.transpose(0, 1), exact_lut=False)


def tile_compare(cand, xyb0_tiles, scales, sy, sx):
    """Block errors [N] float32 (the layout of the JAX kernel's operands).

    cand: [N, 3, 64] int32 dequantized candidate coefficients (channel,
    u*8 + x); xyb0_tiles: [N, 3, 64] float32 original opsin tiles; scales:
    [N, 3] float32 whole-image mask values; sy, sx: [N, 8, 8] int32 0/1
    selection matrices of the edge replication (selection_matrices)."""
    global launches
    n = cand.shape[0]
    dev = cand.device
    check(cand, "cand", _I32, (n, 3, 64), dev)
    check(xyb0_tiles, "xyb0_tiles", _F32, (n, 3, 64), dev)
    check(scales, "scales", _F32, (n, 3), dev)
    check(sy, "sy", _I32, (n, 8, 8), dev)
    check(sx, "sx", _I32, (n, 8, 8), dev)
    if dev.type == "cpu":
        return tile_compare_plain(cand, xyb0_tiles, scales, sy, sx)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    fn = build.load(ENTRY)
    tab = table_buffer(dev)
    out = torch.empty(n, dtype=_F32, device=dev)
    rc = fn(cand.data_ptr(), xyb0_tiles.data_ptr(), scales.data_ptr(),
            sy.data_ptr(), sx.data_ptr(), tab.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (ENTRY, rc))
    with build.lock:
        launches += 1
    return out


def team_geometry(device):
    """Kernel C's launch geometry on `device` (see
    tile_compare_lanes.geometry)."""
    return geometry("tile_compare_geometry", 0, device)


# -- the staged greedy loop's layout (mode "444p") ---------------------------

def compare_lanes(cand_t, x0_l, sc_l, sy_l, sx_l):
    """Kernel C on the staged loop's operands: lane-major candidates
    [3, 8, 8, N] and the mode's state with the block axis last
    (search/zeroing._moved_aux: [3, 64, N], [3, N], [8, 8, N], [8, 8, N]),
    moved back to blocks leading for ``tile_compare``. Returns [N]
    float32."""
    def lead(a):
        return a.movedim(-1, 0).contiguous()
    n = cand_t.shape[-1]
    return tile_compare(lead(cand_t).reshape(n, 3, 64), lead(x0_l),
                        lead(sc_l), lead(sy_l), lead(sx_l))
