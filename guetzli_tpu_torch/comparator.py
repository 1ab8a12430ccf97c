"""Butteraugli comparator: the metric side of the search, 4:4:4 and 4:2:0.

Port of guetzli_tpu/comparator.py (guetzli/butteraugli_comparator.{h,cc}),
at the image's exact geometry or on its padded bucket (ops/padgeom.py,
config.pad). A Comparator computes the original image's opsin once and
keeps it on its device, and offers:

  * the whole-image compare (ButteraugliComparator::Compare, :60-70) and
    the fused compare + block weights of the back-end loop, of a 4:4:4 or
    a 4:2:0 coefficient image;
  * the frozen per-block state of the zeroing passes (StartBlockComparisons
    :72-79 and SwitchBlock :85-111, hoisted out of the loop), with the
    4:2:0 passes' frozen chroma bytes, Y bytes, chroma neighborhoods and
    macroblock children; on a bucket, every per-block array has the
    bucket's block grid, its padded rows zero.

It also offers the JAX package's accelerator search route, which the
search takes wherever supports_quant_batch and supports_sparse say it
can (everywhere but under a mesh):

  * the batched quant compare: B requantizations of a device-resident
    base, each trial's score bit for bit that of its single compare
    (dispatch_quant_batch, for search/quant_tree.py);
  * the back end's device-resident coefficient state, updated by sparse
    per-coefficient deltas instead of whole-plane uploads
    (backend_sync_full, dispatch_compare_sparse_coeffs);
  * on a bucket, CompareBatcher: the lockstep corpus driver's compares
    of different images of one bucket run as one stacked compare, each
    row bit for bit its image's single padded compare.

PyTorch runs eagerly and CUDA work is queued asynchronously, so the
dispatch_* / fetch_* pairs keep the JAX package's structure: a dispatch
queues the device work, its fetch reads the results on the host. On a
CUDA device (and not under a mesh) the compares run as CUDA graphs,
captured once and replayed (compare_graphs.py), shared by every
comparator of the device at one geometry (the image's size, and its
bucket when padded) and keyed by what else fixes their op sequence and
shapes (and the knobs that choose ops): "plain", the whole-image
compare of a 4:4:4 or 4:2:0 coefficient image to its flat score and
diffmap, by its block grids, which the plain compare, the compare +
weights of a coefficient image and the resident state's compare share
(the resident state is copied into the graph's input); "weights", the
block weights of such a compare's diffmap, by direction, float32
target and grid factors; and "quant", a wave (its size in its input's
shape). The compare and wave graphs take the image's own device state
(_state: the original's opsin, and on a bucket its size and border
scales) as inputs beside the coefficients. The CompareBatcher's stacks
and the banded compares stay eager. `counters` (a dict; the serial
search sets its ProcessStats.counters) counts each dispatch as
compare_graph_captures, compare_graph_replays or compare_eager, the
replays of graphs another comparator captured also as
compare_graph_shared, the graphs a capture evicted as
compare_graph_evictions, and the bytes of the compares' host-to-device
copies as compare_upload_bytes.

Three spans (spans.py) time them on the host, into the comparator's
`timings` dict (None: the profiler's trace only):

  * compare_dispatch: launching a whole-image compare's device work,
    where it is launched: dispatch_compare, dispatch_quant_batch, and
    the run of dispatch_compare_with_weights and of the sparse
    dispatches (the resident state's scatter and compare), at once or,
    for a DeferredCompare, at its resolve; and the uploads of the quant
    search's base (quant_base_upload) and of the back end's resident
    state (backend_sync_full). Nested sites count once;
  * compare_upload, inside compare_dispatch: the host-to-device copies
    of a compare's coefficient inputs, their pinning included
    (compare_graphs.uploading): the planes of a whole-image compare and
    a wave's matrices as compare_graphs loads them, the quant base, the
    resident state's full upload and the sparse dispatches' index and
    value arrays. The CompareBatcher's stacks (pad on) and the banded
    compares (a mesh) are not counted;
  * compare_wait: blocked in the device-to-host copy of a compare's
    results (fetch_compare_plain, fetch_quant_scores, fetch_compare_pure,
    fetch_compare_many).
"""

import functools
import math
import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from guetzli_tpu_torch import compare_graphs, config, consts, runtime, spans
from guetzli_tpu_torch.ops import devconst
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import tiles as tile_ops
from guetzli_tpu_torch.ops import upsample as us
from guetzli_tpu_torch.ops.opsin import (opsin_dynamics_image,
                                         opsin_dynamics_image_dyn)
from guetzli_tpu_torch.ops.padgeom import PadGeom, split_scales
from guetzli_tpu_torch.parallel import banded
from guetzli_tpu_torch.parallel.mesh import (RowBands, mesh_from_env,
                                             put_blocks)

_F32 = np.float32

# Per thread: `dispatching` inside a compare_dispatch span, so that a
# nested dispatch site adds no second span.
_span_state = threading.local()


@contextmanager
def dispatch_span(timings):
    """The compare_dispatch span on `timings`, or nothing when this thread
    is inside one already."""
    if getattr(_span_state, "dispatching", False):
        yield
        return
    _span_state.dispatching = True
    try:
        with spans.timed(timings, "compare_dispatch"):
            yield
    finally:
        _span_state.dispatching = False


def wait_span(timings):
    """The compare_wait span on `timings`."""
    return spans.timed(timings, "compare_wait")


def _dispatches(method):
    """A Comparator method that launches a compare's device work, inside
    a compare_dispatch span on the comparator's timings."""
    @functools.wraps(method)
    def dispatch(self, *args):
        with dispatch_span(self.timings):
            return method(self, *args)
    return dispatch


def score_jpeg(distance, size, target):
    """ScoreJPEG (score.cc:23-41)."""
    k_scale = 50.0
    k_max_exponent = 10.0
    k_large = 1e30
    diff = distance - target
    if diff <= 0.0:
        return float(size)
    exponent = k_scale * diff
    if exponent > k_max_exponent:
        return k_large * math.exp(k_max_exponent) * diff + size
    return math.exp(exponent) * size


def _full_compare(coeffs, xyb0, bw, bh, w, h):
    """coeffs [3, NB, 64] int32 -> (score, diffmap [H, W])."""
    lin = img_ops.coeffs_to_linear_rgb(coeffs, bw, bh, w, h)
    dmap = dm.diffmap_opsin_dynamics(xyb0, opsin_dynamics_image(lin))
    return dm.score_from_diffmap(dmap), dmap


def _full_compare_420(y_coeffs, u_coeffs, v_coeffs, xyb0, ybw, ybh, cbw,
                      cbh, w, h):
    """4:2:0 coefficients -> (score, diffmap [H, W]) (the compare half of
    guetzli_tpu/comparator._compare_weights_420)."""
    srgb = img_ops.coeffs420_to_srgb(y_coeffs, u_coeffs, v_coeffs, ybw, ybh,
                                     cbw, cbh, w, h)
    xyb1 = opsin_dynamics_image(img_ops.srgb_to_linear(srgb))
    dmap = dm.diffmap_opsin_dynamics(xyb0, xyb1)
    return dm.score_from_diffmap(dmap), dmap


def _device_quantize(c, q):
    """Round int32 coefficients to multiples of q (guetzli/quantize.h):
    the device twin of search/state.quantize, with C truncation
    semantics, bit for bit (JAX comparator._device_quantize)."""
    r = torch.sign(c) * torch.remainder(c.abs(), q)
    delta = torch.where(2 * r > q, q - r,
                        torch.where(-2 * r > q, -q - r, -r))
    return c + delta


def _quant_scores_444(base, qs, xyb0, bw, bh, w, h):
    """B requantizations of a 4:4:4 base [3, NB, 64] by qs [B, 3, 64] ->
    scores [B] (JAX _quant_batch_444_dyn at exact geometry). The chain
    carries the trials on axis 1 of its planes; each trial's score is
    that of _full_compare on its coefficients, bit for bit."""
    coeffs = _device_quantize(base[:, None], qs.transpose(0, 1)[:, :, None])
    lin = img_ops.coeffs_to_linear_rgb(coeffs, bw, bh, w, h, trial_axis=1)
    xyb1 = opsin_dynamics_image(lin, trial_axis=1)
    return dm.score_from_diffmap(dm.diffmap_opsin_dynamics(xyb0, xyb1))


def _quant_scores_420(ybase, ubase, vbase, qs, xyb0, ybw, ybh, cbw, cbh, w,
                      h):
    """The 4:2:0 counterpart (JAX _quant_batch_420_dyn): bases [NB, 64]
    per component -> scores [B]."""
    y, u, v = (_device_quantize(b[None], qs[:, c, None])
               for c, b in enumerate((ybase, ubase, vbase)))
    srgb = img_ops.coeffs420_to_srgb(y, u, v, ybw, ybh, cbw, cbh, w, h)
    xyb1 = opsin_dynamics_image(img_ops.srgb_to_linear(srgb, 1), 1)
    return dm.score_from_diffmap(dm.diffmap_opsin_dynamics(xyb0, xyb1))


def _dilate_max(x):
    """3x3 max with -inf outside ([H, W])."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def _weights_all_radii_impl(distmap, target, sizex, sizey, bw, bh,
                            direction_pos):
    """ComputeBlockErrorAdjustmentWeights for all rblock radii 1..4 on the
    device (butteraugli_comparator.cc:169-233) -> [4, bw*bh] float32.
    `target` is a float32 value."""
    h, w = distmap.shape
    pad = torch.zeros((bh * sizey, bw * sizex), dtype=distmap.dtype,
                      device=distmap.device)
    pad[:h, :w] = distmap
    max_dist = F.max_pool2d(pad[None, None], (sizey, sizex))[0, 0]
    t = _F32(target)
    weights = []
    local = max_dist
    if direction_pos:
        for _ in range(4):
            local = _dilate_max(local)
            ml = torch.clamp(local, min=float(t))
            weights.append(((max_dist <= float(t))
                            & (ml <= float(_F32(1.1) * t))).float())
    else:
        for r in range(1, 5):
            local = _dilate_max(local)
            ml = torch.clamp(local, min=float(t))
            src = max_dist > (float(_F32(0.5) * t) + 0.5 * ml)
            w_r = torch.zeros_like(max_dist)
            reach = src.float()
            for d in range(r + 1):
                w_r = torch.maximum(w_r, reach * float(_F32(1.0 / (d + 1))))
                if d < r:
                    reach = _dilate_max(reach)
            weights.append(w_r)
    return torch.stack(weights).reshape(4, bw * bh)


def _gather_block_scales(mask_xyz, ys, xs):
    """mask_xyz [3, H, W] -> [NB, 3] values at (ys, xs) per block."""
    return mask_xyz[:, ys, xs].T.contiguous()


# -- padded bucket geometry (JAX comparator.py:134-330) ----------------------
#
# The cores take B images of one bucket stacked on an image axis: each row
# has its own coefficients, original opsin xyb0 [3, B, Hp, Wp], true size
# w, h [B], border scales sc (ops/padgeom.split_scales) and targets tgt
# [B, 3] float32 (t, 1.1 t, 0.5 t, the weights' thresholds rounded on the
# host as JAX rounds them). A single padded compare is the stack of one.

def _targets(ts):
    """float32 [B, 3] rows (t, 1.1 t, 0.5 t) of the targets `ts`."""
    t = np.asarray(ts, np.float32)
    return np.stack([t, _F32(1.1) * t, _F32(0.5) * t], axis=-1)


def _compare_dyn(kind, coeffs, xyb0, w, h, sc, wp, hp):
    """(scores [B], diffmaps [B, Hp, Wp]) of B padded images: `coeffs` is
    [3, B, NBp, 64] for "444", the (y, u, v) planes [B, NB*, 64] on the
    bucket's luma and chroma grids for "420"."""
    if kind == "444":
        lin = img_ops.coeffs_to_linear_rgb(coeffs, wp // 8, hp // 8, wp, hp,
                                           trial_axis=1)
    else:
        srgb = img_ops.coeffs420_to_srgb_dyn(*coeffs, wp // 8, hp // 8,
                                             wp // 16, hp // 16, wp, hp, w, h)
        lin = img_ops.srgb_to_linear(srgb, 1)
    xyb1 = opsin_dynamics_image_dyn(lin, w, h, sc)
    dmap = dm.diffmap_opsin_dynamics_dyn(xyb0, xyb1, w, h, sc)
    return dm.score_from_diffmap(dmap), dmap


def _dilate_max_rows(x):
    """3x3 max with -inf outside, of each image of [B, H, W]."""
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _weights_all_radii_dyn(dmap, tgt, sizex, sizey, direction_pos):
    """_weights_all_radii_impl of B padded diffmaps [B, Hp, Wp] with
    their own targets tgt [B, 3] -> [B, 4, GBHp, GBWp] on the bucket's
    block grid. Padded blocks have a max distance of 0 where the exact
    grid has none; the distances are >= 0, so no real block's weight
    changes (JAX _weights_all_radii_impl on the bucket)."""
    max_dist = F.max_pool2d(dmap[:, None], (sizey, sizex))[:, 0]
    t, t11, t05 = (tgt[:, i, None, None] for i in range(3))
    weights = []
    local = max_dist
    if direction_pos:
        for _ in range(4):
            local = _dilate_max_rows(local)
            ml = torch.maximum(local, t)
            weights.append(((max_dist <= t) & (ml <= t11)).float())
    else:
        for r in range(1, 5):
            local = _dilate_max_rows(local)
            ml = torch.maximum(local, t)
            src = max_dist > (t05 + 0.5 * ml)
            w_r = torch.zeros_like(max_dist)
            reach = src.float()
            for d in range(r + 1):
                w_r = torch.maximum(w_r, reach * float(_F32(1.0 / (d + 1))))
                if d < r:
                    reach = _dilate_max_rows(reach)
            weights.append(w_r)
    return torch.stack(weights, 1)


def _cw444_dyn_core(coeffs, xyb0, tgt, w, h, sc, wp, hp, sizex, sizey,
                    direction_pos):
    """The fused padded compare + weights of B 4:4:4 images ->
    (scores [B], diffmaps [B, Hp, Wp], weights [B, 4, GBHp, GBWp])."""
    score, dmap = _compare_dyn("444", coeffs, xyb0, w, h, sc, wp, hp)
    return score, dmap, _weights_all_radii_dyn(dmap, tgt, sizex, sizey,
                                               direction_pos)


def _cw420_dyn_core(y, u, v, xyb0, tgt, w, h, sc, wp, hp, sizex, sizey,
                    direction_pos):
    """The 4:2:0 counterpart: (y [B, NBp, 64], u, v [B, NBCp, 64])."""
    score, dmap = _compare_dyn("420", (y, u, v), xyb0, w, h, sc, wp, hp)
    return score, dmap, _weights_all_radii_dyn(dmap, tgt, sizex, sizey,
                                               direction_pos)


def _quant_scores_444_dyn(base, qs, xyb0, w, h, sc, wp, hp):
    """B requantizations of a padded 4:4:4 base [3, NBp, 64] -> scores
    [B], each that of a single padded compare bit for bit (JAX
    _quant_batch_444_dyn); xyb0 [3, 1, Hp, Wp], w, h, sc of one image,
    broadcast over the trials."""
    b = qs.shape[0]
    coeffs = _device_quantize(base[:, None], qs.transpose(0, 1)[:, :, None])
    return _compare_dyn("444", coeffs, *_broadcast_rows(b, xyb0, w, h, sc),
                        wp, hp)[0]


def _quant_scores_420_dyn(ybase, ubase, vbase, qs, xyb0, w, h, sc, wp, hp):
    """The 4:2:0 counterpart (JAX _quant_batch_420_dyn)."""
    planes = tuple(_device_quantize(p[None], qs[:, c, None])
                   for c, p in enumerate((ybase, ubase, vbase)))
    return _compare_dyn("420", planes,
                        *_broadcast_rows(qs.shape[0], xyb0, w, h, sc),
                        wp, hp)[0]


def _broadcast_rows(b, xyb0, w, h, sc):
    """One image's row state repeated for b trials (views)."""
    return (xyb0.expand(-1, b, -1, -1), w.expand(b), h.expand(b),
            {k: (sx.expand(b, -1), sy.expand(b, -1))
             for k, (sx, sy) in sc.items()})


def _row(xyb0, w, h, sc_flat, wp, hp):
    """(xyb0 [3, 1, Hp, Wp], w, h, sc): one padded image's state
    (Comparator._state) as a stack of one."""
    return xyb0[:, None], w, h, split_scales(sc_flat[None], wp, hp)


def _pad_rows_dev(a, real, nbp):
    """Rows of `a` [NB, ...] placed at rows `real` (an int64 index on a's
    device) of a zero [nbp, ...] array: pad_blocks on the device (JAX
    _pad_rows_dev)."""
    out = a.new_zeros((nbp,) + tuple(a.shape[1:]))
    return out.index_copy_(0, real, a)


class CompareBatcher:
    """One stacked compare for the compares of several Comparators of one
    bucket (JAX comparator.py:357-427).

    The lockstep corpus driver (parallel/lockstep.py) gives every padded
    comparator of a corpus the same batcher. Their whole-image compares
    (the first compare, the quant rounds without the tree, the back end's
    plain dispatches) then only enqueue a request; the first read of a
    result flushes the queue: requests are grouped by kind ("444" or
    "420") and the bucket's statics (Wp, Hp, the weight grid and the
    direction), and each group runs once through the padded core with a
    leading image axis, each row with its own coefficients, original,
    size, target and border scales. Every row equals its image's single
    padded compare bit for bit (ops/diffmap.py's padded section).

    JAX pads each group's batch axis to a power of two to bound XLA's
    compiles; PyTorch compiles nothing, so a group is exactly its rows.
    Requests may come from any thread (the corpus back end's pool only
    enqueues); a flush runs on the thread that reads, and nothing in it
    waits for the device. An out-of-memory error in a flush replays the
    same stack (runtime.py); if it persists, every row of the group
    raises it when read, and each owner's recovery replays its own
    request alone. It never falls back to unbatched compares."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._queue = []
        self._ready = {}
        self._next = 0
        self.rows = 0        # requests run in stacks
        self.flushes = 0     # stacked compares run

    def enqueue(self, comp, kind, key, coeffs, target, grid):
        """Queue a compare of `comp`: coeffs are its padded numpy planes
        ([3, NBp, 64] for "444", the (y, u, v) planes for "420"), key =
        (sizex, sizey, direction_pos), target the float weights target,
        grid the real weight grid (gbw, gbh). Returns the request's id."""
        g = comp.geom
        with self._lock:
            idx = self._next
            self._next += 1
            self._queue.append((idx, comp, (kind, g.wp, g.hp) + key,
                                coeffs, target, grid))
            return idx

    def result(self, idx):
        """(score, diffmap [Hp, Wp], weights [4, gbh*gbw]) of request
        `idx`, device tensors; flushes the queue if it is not ready."""
        with self._lock:
            if idx not in self._ready:
                self._flush_locked()
            out = self._ready.pop(idx)
        if isinstance(out, BaseException):
            raise out
        return out

    def _flush_locked(self):
        groups = {}
        for item in self._queue:
            groups.setdefault(item[2], []).append(item)
        self._queue = []
        pending = list(groups.items())
        while pending:
            key, items = pending.pop(0)
            try:
                outs = self._run_group(key, items)
            except BaseException as e:
                # Any other error: every request not run raises it.
                for _k, rest in [(key, items)] + pending:
                    for item in rest:
                        self._ready[item[0]] = e
                raise
            for item, out in zip(items, outs):
                self._ready[item[0]] = out
            self.flushes += 1
            self.rows += len(items)

    @staticmethod
    def _run_group(key, items):
        """_run_stack with the runtime's replay of the same stack; a
        persistent out-of-memory error becomes every row's result."""
        for attempt in range(runtime.ATTEMPTS):
            try:
                return _run_stack(key, items)
            except runtime.RECOVERABLE as e:
                if attempt == runtime.ATTEMPTS - 1:
                    return [e] * len(items)
                runtime.release_memory(items[0][1].device,
                                       "a batched compare")


def _run_stack(key, items):
    """One group of CompareBatcher requests through the padded core:
    [(score, diffmap, real-grid weights)] in the items' order."""
    kind, wp, hp, sizex, sizey, direction_pos = key
    comps = [it[1] for it in items]
    dev = comps[0].device

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    xyb0 = torch.stack([c.xyb0 for c in comps], 1)
    w = up(np.array([c.width for c in comps], np.int64))
    h = up(np.array([c.height for c in comps], np.int64))
    sc = split_scales(torch.stack([c._sc_flat for c in comps]), wp, hp)
    tgt = up(_targets([it[4] for it in items]))
    if kind == "444":
        score, dmap, w4 = _cw444_dyn_core(
            up(np.stack([it[3] for it in items], 1)), xyb0, tgt, w, h, sc,
            wp, hp, sizex, sizey, direction_pos)
    else:
        planes = [up(np.stack([it[3][c] for it in items])) for c in range(3)]
        score, dmap, w4 = _cw420_dyn_core(*planes, xyb0, tgt, w, h, sc, wp,
                                          hp, sizex, sizey, direction_pos)
    return [(score[j], dmap[j], _real_weights(w4[j], *it[5]))
            for j, it in enumerate(items)]


def _real_weights(w4, gbw, gbh):
    """[4, GBHp, GBWp] bucket-grid weights -> [4, gbh*gbw] of the real
    grid (JAX _unpad_w4, on the device)."""
    return w4[:, :gbh, :gbw].reshape(4, gbh * gbw)


class DeferredCompare:
    """A compare whose device work runs when it is read, on the reading
    thread: a request on a CompareBatcher, or a comparator's direct
    dispatch deferred (Comparator.batcher). `args` is what
    Comparator.replay needs (None for a plain compare)."""

    def __init__(self, run, args):
        self._run = run
        self.args = args

    def resolve(self):
        """The handle as a direct dispatch gives it: (score, diffmap,
        weights, args)."""
        return self._run() + (self.args,)


def _score_weights(score, w4):
    """score and w4 as one flat vector: the prefix of the buffer a
    compare + weights wrote them into (Comparator._weighted), else their
    concatenation."""
    base = score._base
    if base is not None and w4._base is base and base.dim() == 1 \
            and score.storage_offset() == 0 and w4.storage_offset() == 1 \
            and w4.is_contiguous():
        return base[:1 + w4.numel()]
    return torch.cat([score.reshape(1), w4.reshape(-1)])


def _resolved(handle):
    return handle.resolve() if isinstance(handle, DeferredCompare) \
        else handle


class Comparator:
    """Per-image butteraugli comparator with device-resident state.

    rgb: uint8 [h, w, 3] (numpy); device: a torch.device. ``xyb0`` may be
    passed in (interop.py) instead of computed from rgb (exact geometry
    only). ``padded`` puts the image on its bucket (ops/padgeom.py):
    None reads GUETZLI_TPU_PAD (config.pad: padded only when it is 1).
    On a bucket, xyb0 and the distmaps are [.., Hp, Wp], zero or garbage
    outside the image, and the per-block state has the bucket's block
    grid.

    ``mesh`` (a parallel/dist.Group) encodes the image over the ranks of
    the group: this rank's device state and compares cover its band of rows
    (parallel/banded.py), the score is the max over the ranks and the
    block weights are every rank's rows gathered, so every rank's host
    search reads the same numbers. None reads GUETZLI_TPU_MESH
    (mesh_from_env); False is one device whatever the environment says.
    Under a mesh the compares (4:4:4 and 4:2:0) run at exact geometry,
    the frozen zeroing state is this rank's block rows, and the routes
    that keep per-image device state stay off, as in the JAX package:
    supports_quant_batch and supports_sparse are False, so the search
    takes the serial quant loop and whole-plane back-end compares.

    ``batcher`` (a CompareBatcher, set by the lockstep corpus driver) makes
    a padded comparator's dispatch_compare and
    dispatch_compare_with_weights enqueue their compare there. With a
    batcher set, the device work of every back-end dispatch (the
    batcher's stacks, an exact comparator's compares, the sparse
    dispatches of the resident state) runs when the handle is read, on
    the reading thread: the corpus's pool threads that advance the back
    ends issue none of it."""

    def __init__(self, rgb, width, height, target_distance, device,
                 xyb0=None, padded=None, mesh=None):
        self.width = width
        self.height = height
        self.target_distance = float(target_distance)
        self.device = torch.device(device)
        self.rgb_orig = np.asarray(rgb, dtype=np.uint8).reshape(
            height, width, 3)
        if mesh is None:
            mesh = mesh_from_env()
        self.mesh = mesh or None
        self.bands = RowBands(height, self.mesh) if self.mesh else None
        if padded is None:
            padded = (xyb0 is None and self.mesh is None
                      and config.pad() is True)
        if padded and self.mesh is not None:
            raise ValueError("the padded geometry stays off under a mesh")
        self.geom = PadGeom(width, height) if padded else None
        self.batcher = None
        # Whole-image compares dispatched (a wave counts its trials).
        self.compares = 0
        # Where the compare spans add their seconds (module docstring);
        # the serial search sets its ProcessStats.timings, the corpus
        # driver its phase walls.
        self.timings = None
        # Dispatches by how they ran (module docstring).
        self.counters = {}
        self._graphs = compare_graphs.CompareGraphs(
            self.device, self.device.type == "cuda" and self.mesh is None,
            (width, height) + ((self.geom.wp, self.geom.hp) if padded
                               else ()))
        self.xyb0 = self._original_opsin() if xyb0 is None else xyb0
        self.distance = 0.0
        self.distmap = None
        # The back end's device-resident coefficients (backend_sync_full).
        self._dev_coeffs = None
        # Block-comparison state (built by start_block_comparisons).
        self._mask_xyz = None
        self._block_state = {}
        # Frozen 4:2:0 zeroing state handed in from elsewhere (interop.py):
        # "chroma_bytes", "y16", "neighborhoods" or "children"; a present
        # key is returned instead of computed.
        self.frozen_state = {}

    def _up(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _up_async(self, a):
        """_up without waiting for the stream (compare_graphs.to_device)."""
        return compare_graphs.to_device(a, self.device)

    def _uploading(self, *arrays):
        """The compare_upload span and counter of a compare's uploads of
        host `arrays` (compare_graphs.uploading)."""
        return compare_graphs.uploading(self.timings, self.counters,
                                        compare_graphs.host_bytes(arrays))

    def _original_opsin(self):
        """The original's opsin [3, H, W], or [3, Hp, Wp] on a bucket
        (then also the image's row state: _w, _h, _sc_flat)."""
        lut = consts.SRGB_TO_LINEAR.astype(np.float32)
        if self.bands is not None:
            px = self.bands.pixels()
            lin0 = lut[self.rgb_orig[px.lo:px.hi]].transpose(2, 0, 1)
            return banded.opsin(self._up(lin0), px)
        lin0 = lut[self.rgb_orig].transpose(2, 0, 1)
        if self.geom is None:
            return opsin_dynamics_image(self._up(lin0))
        g = self.geom
        self._w = self._up(np.array([g.w], np.int64))
        self._h = self._up(np.array([g.h], np.int64))
        self._sc_flat = self._up(g.scales_flat())
        return opsin_dynamics_image_dyn(self._up(g.pad_plane(lin0))[:, None],
                                        self._w, self._h, self._sc())[:, 0]

    def _sc(self):
        """This image's border scales as one row (split_scales)."""
        return split_scales(self._sc_flat[None], self.geom.wp, self.geom.hp)

    def _state(self):
        """The image's device state a compare reads: (xyb0,), and on a
        bucket (xyb0, w, h, sc_flat)."""
        if self.geom is None:
            return (self.xyb0,)
        return self.xyb0, self._w, self._h, self._sc_flat

    def _pad(self, comp, gbwp, gbhp):
        """A component's coefficients [NB, 64] on a padded grid."""
        return self.geom.pad_blocks(comp.coeffs, comp.bw, comp.bh, gbwp,
                                    gbhp)

    def _padded_planes(self, img):
        """The image's coefficients on the bucket's grids (numpy): [3, NBp,
        64] for 4:4:4, the (y, u, v) planes for 4:2:0."""
        g = self.geom
        if img.is_444():
            return g.pad_blocks(img.coeffs, img.bw, img.bh)
        y, u, v = img.comps
        return (self._pad(y, g.bwp, g.bhp), self._pad(u, g.wp // 16,
                                                      g.hp // 16),
                self._pad(v, g.wp // 16, g.hp // 16))

    def recover_device_state(self):
        """Rebuild the device state after a recoverable error (runtime.py):
        recompute the original's opsin on the same device and drop the
        last distmap, the mask and the block state, which the next compare
        or start_block_comparisons rebuilds, and the back end's resident
        coefficients, which a replay re-syncs from the host image. The
        search state lives on the host, so a replayed dispatch gives the
        same result. The device's compare graphs are dropped: the next
        use of each key captures again."""
        compare_graphs.drop(self.device)
        self.xyb0 = self._original_opsin()
        self.distmap = None
        self._dev_coeffs = None
        self._mask_xyz = None
        self._block_state = {}

    # -- full-image comparison ------------------------------------------

    def _count(self, mode=compare_graphs.EAGER):
        compare_graphs.count(self.counters, mode)

    def _graph_run(self, key, fn, inputs):
        """(fn(*inputs), how it ran) by the compare graph of this
        comparator's geometry, `key` and the knobs that choose the
        chain's ops (compare_graphs.py)."""
        key += (config.lane_safe(), config.exact_lut(), config.sel_matmul())
        return self._graphs.run(key, fn, inputs, self.timings, self.counters)

    def _flat_compare(self, kind, compare, planes):
        """(the flat [1 + diffmap pixels] score and diffmap of a compare
        of `planes`, how it ran): the graph of ("plain", kind, grid) for
        compare = _compare_fn's (fn, grid), which the plain compare, the
        compare + weights of a coefficient image and the resident
        compare share."""
        fn, grid = compare

        def flat(*args):
            score, dmap = fn(*args)
            return (torch.cat([score.reshape(1), dmap.reshape(-1)]),)
        (out,), mode = self._graph_run(("plain", kind) + grid, flat,
                                       tuple(planes) + self._state())
        return out, mode

    def _kind(self, img):
        return "444" if img.is_444() else "420"

    def _planes(self, img):
        """An image's coefficient planes for a compare (numpy): ([3, NB,
        64],) for 4:4:4, (y, u, v) for 4:2:0, on the bucket's grids if
        padded."""
        if self.geom is not None:
            planes = self._padded_planes(img)
            return (planes,) if img.is_444() else planes
        if img.is_444():
            return (img.coeffs,)
        return tuple(c.coeffs for c in img.comps)

    def _compare_fn(self, img):
        """(fn, grid): fn(*planes on the device (_planes), *_state()) ->
        (score, diffmap) of this comparator's single compare, reading
        nothing of the comparator; grid, the block grids it reads
        besides the geometry."""
        if self.geom is not None:
            kind, wp, hp = self._kind(img), self.geom.wp, self.geom.hp
            n = 1 if kind == "444" else 3

            def padded(*args):
                planes, state = args[:n], args[n:]
                coeffs = planes[0][:, None] if kind == "444" else tuple(
                    p[None] for p in planes)
                score, dmap = _compare_dyn(kind, coeffs,
                                           *_row(*state, wp, hp), wp, hp)
                return score[0], dmap[0]
            return padded, ()
        w, h = self.width, self.height
        if img.is_444():
            bw, bh = img.bw, img.bh
            return (lambda c, xyb0: _full_compare(c, xyb0, bw, bh, w, h),
                    (bw, bh))
        y, u, _v = img.comps
        grid = (y.bw, y.bh, u.bw, u.bh)
        return (lambda yc, uc, vc, xyb0: _full_compare_420(
            yc, uc, vc, xyb0, *grid, w, h), grid)

    def _dmap_shape(self):
        g = self.geom
        return (g.hp, g.wp) if g is not None else (self.height, self.width)

    @_dispatches
    def dispatch_compare(self, img):
        """Queue a whole-image compare of a CoeffImage (4:4:4 or 4:2:0);
        fetch_compare_plain completes it. With a batcher the compare is
        the fused compare + unit-target weights of its bucket group, as
        in the JAX package."""
        self.compares += 1
        if self.geom is not None and self.batcher is not None:
            self._count()
            return self._enqueue(img, 1, 1.0, 1, 1, None)
        if self.bands is not None:
            self._count()
            return self._band_compare(img)
        out, mode = self._flat_compare(self._kind(img), self._compare_fn(img),
                                       self._planes(img))
        self._count(mode)
        return out[0], out[1:].view(self._dmap_shape())

    def _band_compare(self, img):
        """(score over every rank, the band's diffmap rows) of a 4:4:4 or
        4:2:0 image under a mesh."""
        px = self.bands.pixels()
        dmap = self.xyb0.new_zeros((0, self.width))
        if px.n:
            if img.is_444():
                lin = banded.linear_rgb(
                    put_blocks(self.bands, img.coeffs, self.device, axis=1),
                    img.bw, self.bands, self.width)
            else:
                y, u, _v = img.comps
                lin = banded.linear_rgb_420(
                    put_blocks(self.bands, y.coeffs, self.device),
                    self._band_chroma(img), y.bw, u.bw, self.bands,
                    self.width)
            xyb1 = banded.opsin(lin, px)
            dmap = banded.diffmap(self.xyb0, xyb1, self.bands)
        return banded.score(dmap, self.bands), dmap

    def _band_chroma(self, img):
        """This rank's chroma block rows of a 4:2:0 image, [2, NBc_band,
        64] on the device."""
        return torch.stack([put_blocks(self.bands, c.coeffs, self.device,
                                       div=16) for c in img.comps[1:]])

    def fetch_compare_plain(self, handle):
        handle = _resolved(handle)
        with wait_span(self.timings):
            self.distance = float(handle[0])
        self.distmap = handle[1]
        return self.distance

    def compare_img(self, img):
        return self.fetch_compare_plain(self.dispatch_compare(img))

    # -- batched quant-matrix trials (search/quant_tree.py) --------------

    def supports_quant_batch(self):
        """True. The JAX package ties its waves to padded bucket geometry
        because XLA compiles one program per bucket and batch size; the
        port runs its eager chain with any number of trials at either
        geometry, so every comparator takes them (a padded one on its
        bucket, with or without a batcher: waves are per image), but
        not one under a mesh (JAX comparator.py:655)."""
        return self.mesh is None

    @_dispatches
    def quant_base_upload(self, img):
        """Put the quant search's base (the dequantized input coefficients
        every trial requantizes) on the device, on the bucket's grids if
        padded: an opaque handle for dispatch_quant_batch."""
        kind = self._kind(img)
        if self.geom is not None:
            grid = None
        elif img.is_444():
            grid = (img.bw, img.bh)
        else:
            y, u, _v = img.comps
            grid = (y.bw, y.bh, u.bw, u.bh)
        planes = self._planes(img)
        with self._uploading(*planes):
            return kind, tuple(self._up(p) for p in planes), grid

    # JAX's wave sizes: the tree's waves hold at most the largest.
    _QUANT_BATCH_SIZES = (4, 8)
    # Device bytes per image (or bucket) pixel one trial of a wave adds at
    # its peak, rounded up from the largest measured: 888-899 B on the two
    # mosaics (4:4:4 and 4:2:0, waves of 4 and 8), 900-957 B at
    # photo_mosaic1 tiled 2x2 (5.24 MPix) and 1,070 B per bucket pixel
    # there on its bucket (2944x1920) (chip_smoke.py's route phase); at
    # 3072x2048 (6.29 MPix) a wave's peak is ~690 B a pixel plus ~730 B a
    # trial, 1,413-1,425 B a trial in a wave of one, 1,071-1,077 B in a
    # wave of two, 958-962 B in one of three; 4:2:0 at 2048x1536 and
    # 3072x2048 as much, so one constant serves both kinds: 1,424-1,431
    # B a trial in a wave of one (its capture; 1,406-1,407 B eager),
    # 1,073-1,074 B in a wave of two, 957-958 B in one of three; on an
    # NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
    _QUANT_TRIAL_BYTES_PER_PIXEL = 1472
    # The share of the card's free memory a wave may take.
    _QUANT_WAVE_MEMORY_SHARE = 0.5

    def quant_batch_sizes(self):
        """The wave sizes this image may use: JAX's (4, 8) where a wave
        fits in half of the card's free memory (the allocator's cached
        blocks count as free, but not those of the compare graphs'
        pools, which only their graphs use) at the measured bytes per
        trial, else the number that fits, at least 1; on a bucket the
        pixels are the bucket's. The CPU takes (4, 8)."""
        if self.device.type != "cuda":
            return self._QUANT_BATCH_SIZES
        free, _total = torch.cuda.mem_get_info(self.device)
        free += max(0, torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device)
                    - compare_graphs.pool_bytes(self.device))
        g = self.geom
        return self.wave_sizes(
            free, (g.wp * g.hp if g else self.width * self.height)
            * self._QUANT_TRIAL_BYTES_PER_PIXEL)

    @classmethod
    def wave_sizes(cls, free, per_trial):
        """The wave sizes for `free` bytes of the card when one trial
        takes `per_trial` bytes: those of JAX's (4, 8) that fit in the
        wave's share of `free`, else the number that fits, at least 1."""
        cap = max(1, int(free * cls._QUANT_WAVE_MEMORY_SHARE // per_trial))
        sizes = tuple(s for s in cls._QUANT_BATCH_SIZES if s <= cap)
        return sizes or (min(cap, cls._QUANT_BATCH_SIZES[0]),)

    @_dispatches
    def dispatch_quant_batch(self, base, qs):
        """Queue len(qs) quant-matrix trials as one batched compare; the
        handle's fetch is fetch_quant_scores. The wave runs exactly its
        trials: no padding to a batch size (JAX pads for its compile
        cache)."""
        q = np.stack([np.asarray(x, np.int32).reshape(3, 64) for x in qs])
        self.compares += len(qs)
        kind, planes, grid = base
        n = len(planes)
        if self.geom is not None:
            fn = _quant_scores_444_dyn if kind == "444" \
                else _quant_scores_420_dyn
            wp, hp = self.geom.wp, self.geom.hp

            def wave(q, *args):
                return (fn(*args[:n], q, *_row(*args[n:], wp, hp), wp, hp),)
        else:
            fn = _quant_scores_444 if kind == "444" else _quant_scores_420
            w, h = self.width, self.height

            def wave(q, *args):
                return (fn(*args[:n], q, args[n], *grid, w, h),)
        (scores,), mode = self._graph_run(
            ("quant", kind) + (grid or ()), wave,
            (q,) + tuple(planes) + self._state())
        self._count(mode)
        return scores, len(qs)

    def fetch_quant_scores(self, handle):
        """[B] float64 scores (one device-to-host copy)."""
        scores, b = handle
        with wait_span(self.timings):
            return scores.cpu().numpy()[:b].astype(np.float64)

    def set_quant_result(self, handle, row, score):
        """Adopt trial `row` of a fetched wave as the current distance.
        The distmap is left as it was: nothing reads it between the quant
        search and the first back-end compare, which replaces it (the
        first up-iteration uses unit weights; zeroing works from the
        whole-image mask) -- JAX comparator.set_quant_result."""
        del handle, row
        self.distance = float(score)

    def distance_ok(self, target_mul):
        return self.distance <= target_mul * self.target_distance

    def score_output_size(self, size):
        return score_jpeg(self.distance, size, self.target_distance)

    def block_error_limit(self):
        return self.target_distance

    # -- per-block comparison state -------------------------------------

    def start_block_comparisons(self):
        if self.bands is not None:
            self._mask_xyz = (
                banded.mask(self.xyb0, self.xyb0, self.bands)[0]
                if self.bands.pixels().n else self.xyb0.new_zeros(
                    (3, 0, self.width)))
            return
        if self.geom is None:
            self._mask_xyz = dm.mask(self.xyb0, self.xyb0)[0]
            return
        x, w, h, sc = _row(*self._state(), self.geom.wp, self.geom.hp)
        self._mask_xyz = dm.mask_dyn(x, x, w, h, sc)[0][:, 0]

    def finish_block_comparisons(self):
        self._mask_xyz = None
        self._block_state = {}

    def block_state(self, factor_x, factor_y):
        """(xyb0_tiles [NB, 3, 64] f32, scales [NB, 3] f32, ysel [NB, 8]
        int32, xsel [NB, 8] int32) on the device, for the 8x8 pixel blocks
        of the full-resolution image (row-major). On a bucket NB is the
        bucket's block grid, the padded rows zero."""
        key = (factor_x, factor_y)
        if key not in self._block_state:
            if self._mask_xyz is None:
                raise RuntimeError("call start_block_comparisons first")
            w, h = self.width, self.height
            bw = (w + 7) // 8
            bh = (h + 7) // 8
            # Under a mesh: this rank's block rows [b0, b1) alone.
            b0, b1, y0 = 0, bh, 0
            if self.bands is not None:
                bs = self.bands.blocks()
                b0, b1, y0 = bs.lo, bs.hi, self.bands.lo
            xyb0_tiles = tile_ops.original_opsin_tiles(
                self.rgb_orig[y0:], w, h - y0, bw, b1 - b0, self.device)
            bx = np.tile(np.arange(bw), b1 - b0)
            by = np.repeat(np.arange(b1 - b0), bw)
            scales = _gather_block_scales(
                self._mask_xyz, torch.as_tensor(8 * by, device=self.device),
                torch.as_tensor(8 * bx, device=self.device))
            ysel, xsel = (a[b0 * bw:b1 * bw] for a in
                          tile_ops.edge_gather_indices(bw, bh, w, h))
            if self.geom is not None:
                g = self.geom
                real = self._up(g.real_index(bw, bh, g.bwp))
                nbp = g.bwp * g.bhp
                xyb0_tiles = _pad_rows_dev(xyb0_tiles, real, nbp)
                scales = _pad_rows_dev(scales, real, nbp)
                ysel, xsel = g.pad_blocks(ysel), g.pad_blocks(xsel)
            self._block_state[key] = (xyb0_tiles, scales, self._up(ysel),
                                      self._up(xsel))
        return self._block_state[key]

    def _pad_grid(self, a, gbw, gbh, gbwp, gbhp):
        """A per-block device array [gbh*gbw, ...] on the padded grid
        (gbwp x gbhp); unchanged at exact geometry."""
        if self.geom is None:
            return a
        return _pad_rows_dev(a, self._up(self.geom.real_index(gbw, gbh,
                                                              gbwp)),
                             gbwp * gbhp)

    # -- 4:2:0 per-block evaluation state ---------------------------------

    def frozen_chroma_blocks(self, img):
        """[NBy, 2, 8, 8] int32 frozen Cb/Cr bytes of each full-res 8x8
        block for the 4:2:0 Y pass, edge bytes replicated by a clamped
        gather. On a bucket the bytes come from the padded chroma planes
        and NBy is the bucket's block grid."""
        if "chroma_bytes" in self.frozen_state:
            return self.frozen_state["chroma_bytes"]
        u, v = img.comps[1], img.comps[2]
        w, h = self.width, self.height
        bw, bh = (w + 7) // 8, (h + 7) // 8
        # Under a mesh: this rank's block rows [b0, b1), whose pixels are
        # the band's rows from y0 on.
        b0, b1, y0 = 0, bh, 0
        g = self.geom
        if self.bands is not None:
            bs = self.bands.blocks()
            b0, b1, y0 = bs.lo, bs.hi, self.bands.lo
            planes = banded.chroma_bytes(self._band_chroma(img), u.bw,
                                         self.bands, w)
        elif g is None:
            planes = torch.stack([
                img_ops.chroma_byte_plane(self._up(c.coeffs), c.bw, c.bh, w,
                                          h) for c in (u, v)])   # [2, h, w]
        else:
            cbwp, cbhp = g.wp // 16, g.hp // 16
            planes = img_ops.chroma_byte_plane_dyn(
                self._up(np.stack([self._pad(c, cbwp, cbhp)
                                   for c in (u, v)])),
                cbwp, cbhp, g.wp, g.hp, self._w, self._h)  # [2, hp, wp]
        gx = np.minimum(np.tile(np.arange(bw), b1 - b0)[:, None] * 8
                        + np.arange(8)[None, :], w - 1)        # [NB, 8]
        gy = np.minimum(np.repeat(np.arange(b0, b1), bw)[:, None] * 8
                        + np.arange(8)[None, :], h - 1) - y0
        out = planes[:, self._up(gy)[:, :, None], self._up(gx)[:, None, :]]
        out = out.permute(1, 0, 2, 3).contiguous()
        return out if g is None else self._pad_grid(out, bw, bh, g.bwp,
                                                    g.bhp)

    def frozen_y_16x16(self, img, cbw, cbh):
        """[NBc, 16, 16] int32 frozen Y bytes of each 16x16 macroblock for
        the 4:2:0 chroma pass (clamped gather); on a bucket NBc is the
        bucket's chroma grid."""
        if "y16" in self.frozen_state:
            return self.frozen_state["y16"]
        y = img.comps[0]
        w, h = self.width, self.height
        g = self.geom
        # Under a mesh: this rank's macroblock rows [m0, m1), whose pixels
        # are the band's rows from y0 on.
        m0, m1, y0 = 0, cbh, 0
        if self.bands is not None:
            ms = self.bands.span(16)
            m0, m1, y0 = ms.lo, ms.hi, self.bands.lo
            plane = banded.y_bytes(put_blocks(self.bands, y.coeffs,
                                              self.device), y.bw,
                                   self.bands, w)
        else:
            if g is None:
                coeffs, grid = self._up(y.coeffs), (y.bw, y.bh, w, h)
            else:
                coeffs = self._up(self._pad(y, g.bwp, g.bhp))
                grid = (g.bwp, g.bhp, g.wp, g.hp)
            plane = img_ops.byte_plane(img_ops.blocks_to_plane(
                img_ops.idct_blocks(coeffs) << 4, *grid))
        gx = np.minimum(np.tile(np.arange(cbw), m1 - m0)[:, None] * 16
                        + np.arange(16)[None, :], w - 1)
        gy = np.minimum(np.repeat(np.arange(m0, m1), cbw)[:, None] * 16
                        + np.arange(16)[None, :], h - 1) - y0
        out = plane[self._up(gy)[:, :, None], self._up(gx)[:, None, :]]
        return out if g is None else self._pad_grid(out, cbw, cbh,
                                                    g.wp // 16, g.hp // 16)

    def frozen_neighborhoods(self, img):
        """(neigh_u, neigh_v): [NBc, 10, 10] int32 x16 subsampled
        neighborhoods of each macroblock's Cb and Cr for the 4:2:0 chroma
        pass (the frame the candidate's own IDCT is written into); on a
        bucket NBc is the bucket's chroma grid."""
        if "neighborhoods" in self.frozen_state:
            return self.frozen_state["neighborhoods"]
        if self.bands is not None:
            # This rank's macroblock rows, from the band's subsampled rows
            # and one row of each neighbour's.
            return tuple(banded.neighborhoods(
                self._band_chroma(img), img.comps[1].bw, self.bands,
                self.width))
        ws, hs = (img.width + 1) // 2, (img.height + 1) // 2
        out = []
        for c in (img.comps[1], img.comps[2]):
            sub = img_ops.blocks_to_plane(
                img_ops.idct_blocks(self._up(c.coeffs)) << 4, c.bw, c.bh,
                ws, hs)
            neigh = us.neighborhoods_10x10(sub, c.bw, c.bh)
            if self.geom is not None:
                neigh = self._pad_grid(neigh, c.bw, c.bh, self.geom.wp // 16,
                                       self.geom.hp // 16)
            out.append(neigh)
        return tuple(out)

    def children_state(self, cbw, cbh):
        """The full-res block state gathered into [NBc, 2, 2, ...] for the
        2x2 children of each 16x16 macroblock: (xyb0_tiles, scales, ysel,
        xsel, valid [NBc, 2, 2] bool); invalid children (outside the
        image) gather block 0. On a bucket the macroblock axis is the
        bucket's chroma grid, the children strided over its block grid.
        Under a mesh: this rank's macroblock rows, whose children are its
        own block rows (block_state); their validity is the whole grid's,
        and an invalid child gathers the band's first block."""
        if "children" in self.frozen_state:
            return self.frozen_state["children"]
        xyb0_tiles, scales, ysel, xsel = self.block_state(1, 1)
        bw, bh = (self.width + 7) // 8, (self.height + 7) // 8
        stride = bw
        m0, m1, r0 = 0, cbh, 0
        if self.geom is not None:
            cbw, cbh = self.geom.wp // 16, self.geom.hp // 16
            m1, stride = cbh, self.geom.bwp
        if self.bands is not None:
            ms = self.bands.span(16)
            m0, m1, r0 = ms.lo, ms.hi, self.bands.blocks().lo
        cbx = np.tile(np.arange(cbw), m1 - m0)
        cby = np.repeat(np.arange(m0, m1), cbw)
        ix = np.arange(2)
        child_x = cbx[:, None, None] * 2 + ix[None, None, :]   # [NBc,1,2]
        child_y = cby[:, None, None] * 2 + ix[None, :, None]   # [NBc,2,1]
        valid = (child_x < bw) & (child_y < bh)                # [NBc,2,2]
        idx = self._up(np.where(valid, (child_y - r0) * stride + child_x, 0)
                       .reshape(-1))
        nbc = cbw * (m1 - m0)

        def g(a):
            return a[idx].reshape((nbc, 2, 2) + tuple(a.shape[1:]))

        return (g(xyb0_tiles), g(scales), g(ysel), g(xsel),
                self._up(valid))

    # -- block error adjustment weights ---------------------------------

    def _grid_dims(self, factor_x, factor_y):
        sizex, sizey = 8 * factor_x, 8 * factor_y
        gbw = (self.width + sizex - 1) // sizex
        gbh = (self.height + sizey - 1) // sizey
        return sizex, sizey, gbw, gbh

    def _weights(self, dmap, direction, target_mul, factor_x, factor_y):
        """[4, NB] weights (device) of a distmap on the real grid."""
        sizex, sizey, gbw, gbh = self._grid_dims(factor_x, factor_y)
        target = self.target_distance * target_mul
        if self.bands is not None:
            return banded.weights(dmap, _F32(target), sizex, sizey, gbw,
                                  gbh, direction > 0, self.bands)
        if self.geom is None:
            return _weights_all_radii_impl(dmap, _F32(target), sizex, sizey,
                                           gbw, gbh, direction > 0)
        tgt = devconst.get(("weights_targets", float(_F32(target))),
                           self.device, lambda: _targets([target]))
        w4 = _weights_all_radii_dyn(dmap[None], tgt, sizex, sizey,
                                    direction > 0)
        return _real_weights(w4[0], gbw, gbh)

    def weights_all_radii(self, direction, target_mul, factor_x, factor_y):
        """[4, NB] weights for rblock radii 1..4 from the distmap of the
        last compare."""
        return self._weights(self.distmap, direction, target_mul, factor_x,
                             factor_y).cpu().numpy()

    def _with_weights(self, score, dmap, img, direction, target_mul,
                      factor_x, factor_y, resident):
        """A compare's handle with the next iteration's block weights:
        (score, dmap, w4, args), args being what replay() needs."""
        return score, dmap, self._weights(
            dmap, direction, target_mul, factor_x, factor_y), (
                img, direction, target_mul, factor_x, factor_y, resident)

    def _enqueue(self, img, direction, target_mul, factor_x, factor_y,
                 args):
        """Put this compare on the batcher: a DeferredCompare."""
        sizex, sizey, gbw, gbh = self._grid_dims(factor_x, factor_y)
        idx = self.batcher.enqueue(
            self, "444" if img.is_444() else "420",
            (sizex, sizey, direction > 0), self._padded_planes(img),
            self.target_distance * target_mul, (gbw, gbh))
        return DeferredCompare(self._timed_run(
            lambda: self.batcher.result(idx)), args)

    def dispatch_compare_with_weights(self, img, direction, target_mul,
                                      factor_x, factor_y):
        """Queue the compare + next-iteration block weights; returns a
        handle for fetch_compare() or fetch_compare_many()."""
        args = (img, direction, target_mul, factor_x, factor_y, False)
        if self.batcher is not None and self.geom is not None:
            self.compares += 1
            self._count()
            return self._enqueue(img, direction, target_mul, factor_x,
                                 factor_y, args)
        return self._deferred(lambda: self._compare_weights(img, args), args)

    def _compare_weights(self, img, args):
        """(score, dmap, w4) of a coefficient image's compare + weights."""
        self.compares += 1
        if self.bands is not None:
            self._count()
            return self._with_weights(*self._band_compare(img), *args)[:3]
        return self._weighted(self._kind(img), self._planes(img), args)

    def _weighted(self, kind, inputs, args):
        """(score, dmap, w4) of a compare of `inputs` (_planes of args'
        image, or the resident state) and its block weights (args as
        replay's): the compare's graph (_flat_compare), then the graph
        of the weights' key, whose output starts with the score and the
        weights (fetch_compare_pure copies that prefix)."""
        img, direction, target_mul, factor_x, factor_y, _res = args
        _sx, _sy, gbw, gbh = self._grid_dims(factor_x, factor_y)
        shape = self._dmap_shape()
        cmp, mode = self._flat_compare(kind, self._compare_fn(img), inputs)

        def weights(flat):
            w4 = self._weights(flat[1:].view(shape), direction, target_mul,
                               factor_x, factor_y)
            return (torch.cat([flat[:1], w4.reshape(-1)]),)
        key = ("weights", direction > 0,
               float(_F32(self.target_distance * target_mul)), factor_x,
               factor_y)
        (sw,), mode2 = self._graph_run(key, weights, (cmp,))
        self._count(compare_graphs.combined(mode, mode2))
        return sw[0], cmp[1:].view(shape), sw[1:].view(4, gbh * gbw)

    def _deferred(self, run, args):
        """run() -> (score, dmap, w4) now, or at the handle's read when a
        batcher is set (the class docstring); either way inside a
        compare_dispatch span."""
        run = self._timed_run(run)
        if self.batcher is not None:
            return DeferredCompare(run, args)
        return run() + (args,)

    def _timed_run(self, run):
        """run, its call inside a compare_dispatch span."""
        def timed():
            with dispatch_span(self.timings):
                return run()
        return timed

    def replay(self, handle):
        """Queue a handle's compare again. The image is the one the handle
        was dispatched for: until the handle is fetched, its owner does
        not change its coefficients, so the replay gives the same
        result. A compare of the resident state first re-syncs it from
        that image (a recovery may have dropped it)."""
        img, direction, target_mul, factor_x, factor_y, resident = \
            handle.args if isinstance(handle, DeferredCompare) else handle[3]
        if not resident:
            return self.dispatch_compare_with_weights(
                img, direction, target_mul, factor_x, factor_y)
        self.backend_sync_full(img)
        return self.dispatch_compare_sparse(img, (), direction, target_mul,
                                            factor_x, factor_y)

    def fetch_compare(self, handle):
        """Complete a compare handle: (distance, [4, NB])."""
        d, w4, dmap = self.fetch_compare_pure(handle)
        self.distance = d
        self.distmap = dmap
        return d, w4

    def fetch_compare_pure(self, handle):
        """fetch_compare without side effects on the comparator:
        (distance, [4, NB] weights, the device distmap), in one
        device-to-host copy."""
        with dispatch_span(self.timings):
            score, dmap, w4, _args = _resolved(handle)
            flat = _score_weights(score, w4)
        with wait_span(self.timings):
            flat = flat.cpu().numpy()
        return float(flat[0]), flat[1:].reshape(w4.shape), dmap

    # -- device-resident back-end coefficient state ----------------------

    # Sparse coefficient deltas: a wave of m flipped coefficients ships
    # its m (index, value) pairs as they are -- the port compiles nothing
    # per size, so JAX's fixed rungs (_SPARSE_COEFF_SIZES, which pad a
    # wave for its compile cache) have no use here. A wave above
    # _SPARSE_COEFF_TOP entries first goes in scatter-only chunks of
    # _SPARSE_COEFF_CHUNK entries, as in JAX, which bounds the size of
    # one upload (tests/test_torch_sparse_backend.py shrinks both).
    _SPARSE_COEFF_TOP = 1 << 20
    _SPARSE_COEFF_CHUNK = 1 << 20

    def supports_sparse(self, img, comp_mask):
        """The resident state is the 4:4:4 pass's [3, NB, 64] planes (JAX
        supports_sparse; the 4:2:0 passes upload whole planes). Sparse
        compares bypass a batcher: the state is the image's own. Off
        under a mesh."""
        return comp_mask == 7 and img.is_444() and self.mesh is None

    @_dispatches
    def backend_sync_full(self, img):
        """Upload the back end's coefficient state [3, NB, 64] int32 from
        the host image (on a bucket [3, NBp, 64]) into its buffer, without
        waiting for the stream; the sparse dispatches update it in
        place."""
        host = img.coeffs if self.geom is None else self._padded_planes(img)
        if self._dev_coeffs is None or \
                tuple(self._dev_coeffs.shape) != host.shape:
            self._dev_coeffs = torch.empty(host.shape, dtype=torch.int32,
                                           device=self.device)
        with self._uploading(host):
            compare_graphs.copy_into(self._dev_coeffs, host)
        self._dev_grid = (img.bw, img.bh)

    def _state_rows(self, blocks):
        """Rows of the resident state of blocks on the image's grid."""
        if self.geom is None:
            return blocks
        bw = self._dev_grid[0]
        return (blocks // bw) * self.geom.bwp + blocks % bw

    def _scatter(self, cidx, cvals):
        """Set flat entries c*NB*64 + b*64 + k of the resident state."""
        with self._uploading(cidx, cvals):
            vals = self._up_async(cvals)
            idx = self._up_async(cidx)
        self._dev_coeffs.view(-1)[idx] = vals

    def dispatch_compare_sparse_coeffs(self, img, blocks_idx, cks, vals,
                                       direction, target_mul, factor_x,
                                       factor_y):
        """dispatch_compare_with_weights of the resident state after the
        flip loop's (block, c*64+k, new value) triplets are written into
        it: 12 bytes per flipped coefficient instead of the whole planes
        (JAX _scatter_coeff_compare_444_dyn, and _scatter_coeffs_only
        for the chunks of a wave above _SPARSE_COEFF_TOP)."""
        cks = np.asarray(cks, np.int64)
        cidx = ((cks >> 6) * (self._dev_coeffs.shape[1] * 64)
                + self._state_rows(np.asarray(blocks_idx, np.int64)) * 64
                + (cks & 63))
        cvals = np.asarray(vals, np.int32)
        args = (img, direction, target_mul, factor_x, factor_y, True)

        def run():
            m, pos = len(cidx), 0
            while m - pos > self._SPARSE_COEFF_TOP:
                end = pos + self._SPARSE_COEFF_CHUNK
                self._scatter(cidx[pos:end], cvals[pos:end])
                pos = end
            if pos < m:
                self._scatter(cidx[pos:], cvals[pos:])
            return self._compare_resident(args)
        return self._deferred(run, args)

    def dispatch_compare_sparse(self, img, changed, direction, target_mul,
                                factor_x, factor_y):
        """The per-block form (JAX _scatter_compare_444_dyn): the blocks
        `changed` (indexes on the image's grid) are written whole from the
        host image into the resident state, then compared."""
        changed = np.asarray(changed, np.int64)
        args = (img, direction, target_mul, factor_x, factor_y, True)

        def run():
            if len(changed):
                rows = self._state_rows(changed)
                blocks = np.stack([c.coeffs[changed] for c in img.comps])
                with self._uploading(rows, blocks):
                    vals = self._up_async(blocks)
                    idx = self._up_async(rows)
                self._dev_coeffs[:, idx, :] = vals
            return self._compare_resident(args)
        return self._deferred(run, args)

    def _compare_resident(self, args):
        """(score, dmap, w4) of the resident state; args as replay's (its
        image has the resident state's grid)."""
        self.compares += 1
        return self._weighted("444", (self._dev_coeffs,), args)


def fetch_compare_many(comps, handles):
    """Complete many dispatch_compare_with_weights handles (one per
    comparator in `comps`) with ONE device-to-host copy: every score and
    flattened w4 concatenated. Batched handles resolve first, which
    flushes their batcher's groups without waiting for the device. Leaves
    each comparator as fetch_compare would (distance, distmap) and
    returns the same [(distance, w4)]. Its compare spans (the handles'
    runs, the concatenation and the copy) go to the first comparator's
    timings: the corpus driver gives every comparator the same dict."""
    if not handles:
        return []
    timings = comps[0].timings
    with dispatch_span(timings):
        handles = [_resolved(h) for h in handles]
        flat = torch.cat([_score_weights(h[0], h[2]) for h in handles])
    with wait_span(timings):
        flat = flat.cpu().numpy()
    out, pos = [], 0
    for c, (_score, dmap, w4, _args) in zip(comps, handles):
        n = w4.numel()
        c.distance = float(flat[pos])
        c.distmap = dmap
        out.append((c.distance, flat[pos + 1:pos + 1 + n].reshape(w4.shape)))
        pos += 1 + n
    return out
