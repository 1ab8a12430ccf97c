"""Kernel A and its 4:2:0 twins: the per-block compare over lane-major
candidates.

Port of guetzli_tpu/kernels/tile_compare_lanes.py (_tile_compare_lanes),
mode "444" (kernel A), and of the JAX package's XLA compares
ops/tiles_lanes.compare_blocks_lanes420y / 420c (A' and A'', which the
zeroing driver needs to check kernels B' and B''). The CUDA kernels are
csrc/tile_compare_lanes.cu, all three team compares: one CTA per lane
(block or macroblock) loads its candidates and state into the
shared-memory layout of the mode's greedy kernel (B, B', B'') and runs
that kernel's evaluation (csrc/compare_team.cuh). Their plain PyTorch
versions are ops/tiles_lanes.COMPARE.

``tile_compare_lanes`` runs the plain version for CPU tensors only. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

import ctypes

import torch

from guetzli_tpu_torch.kernels import build, tables
from guetzli_tpu_torch.ops.tiles_lanes import COMPARE

# Kernel launches per mode since the last reset (a caller may zero them).
launches = {"444": 0, "420y": 0, "420c": 0}

# The C entry point (csrc/tile_compare_lanes.cu) of each mode.
ENTRY = {"444": "tile_compare_lanes", "420y": "tile_compare_lanes_420y",
         "420c": "tile_compare_lanes_420c"}

# The team compares' index in gt_tile_compare_lanes_geometry.
TEAM = {"420c": 0, "444": 1, "420y": 2}

_tables = {}

_F32 = torch.float32
_I32 = torch.int32


def table_buffer(device):
    """The kernels' constant table buffer on `device` (built once)."""
    key = str(device)
    if key not in _tables:
        _tables[key] = tables.build(device)
    return _tables[key]


def check(t, name, dtype, shape, device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if t.device != device:
        raise ValueError("%s is on %s, expected %s"
                         % (name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def aux_specs(mode, n):
    """(name, dtype, shape) of each frozen-state operand of a mode's block
    compare over n lanes, in argument order."""
    if mode == "444":
        return [("x0", _F32, (3, 8, 8, n)), ("sc", _F32, (3, n)),
                ("ymax", _I32, (n,)), ("xmax", _I32, (n,))]
    if mode == "420y":
        return [("chroma", _I32, (2, 8, 8, n))] + aux_specs("444", n)
    if mode == "420c":
        return [("nu", _I32, (10, 10, n)), ("nv", _I32, (10, 10, n)),
                ("y16", _I32, (16, 16, n)),
                ("x0c", _F32, (2, 2, 3, 8, 8, n)),
                ("scc", _F32, (2, 2, 3, n)), ("ymaxc", _I32, (2, 2, n)),
                ("xmaxc", _I32, (2, 2, n)), ("validc", _I32, (2, 2, n))]
    raise ValueError("unknown mode %r" % (mode,))


def check_aux(aux, mode, n, device):
    specs = aux_specs(mode, n)
    if len(aux) != len(specs):
        raise TypeError("mode %s takes %d state operands, got %d"
                        % (mode, len(specs), len(aux)))
    for a, (name, dtype, shape) in zip(aux, specs):
        check(a, name, dtype, shape, device)


def tile_compare_lanes(cand_t, *aux, mode="444"):
    """Block errors [N] float32.

    cand_t: [3, 8, 8, N] int32 dequantized candidate coefficients (mode
    "420y" reads plane 0, "420c" planes 1 and 2); aux: the mode's
    lane-major frozen state (aux_specs): for "444" x0 [3, 8, 8, N] float32
    original opsin tiles, sc [3, N] float32 mask scales, ymax, xmax [N]
    int32 edge clamps."""
    n = cand_t.shape[-1]
    dev = cand_t.device
    check(cand_t, "cand_t", _I32, (3, 8, 8, n), dev)
    check_aux(aux, mode, n, dev)
    if dev.type == "cpu":
        return COMPARE[mode](cand_t, *aux)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    fn = build.load(ENTRY[mode])
    tab = table_buffer(dev)
    out = torch.empty(n, dtype=_F32, device=dev)
    rc = fn(cand_t.data_ptr(), *[a.data_ptr() for a in aux],
            tab.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d"
                           % (ENTRY[mode], rc))
    with build.lock:
        launches[mode] += 1
    return out


def geometry(entry, index, device):
    """The launch geometry of team kernel `index` of geometry query `entry`
    (build.SIGNATURES) on `device`: {"threads", "smem_bytes"} per CTA and
    "ctas_per_sm", the CTAs that fit on one SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = build.load(entry)
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = fn(index, *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError("%s(%d) failed: CUDA error %d" % (entry, index, rc))
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"),
                    (v.value for v in vals)))


def team_geometry(mode, device):
    """The launch geometry of team compare `mode` ("444": A, "420y": A',
    "420c": A'') on `device` (see ``geometry``)."""
    return geometry("tile_compare_lanes_geometry", TEAM[mode], device)
