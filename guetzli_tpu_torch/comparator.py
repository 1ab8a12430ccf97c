"""Butteraugli comparator: the metric side of the search, 4:4:4 and 4:2:0.

Port of guetzli_tpu/comparator.py (guetzli/butteraugli_comparator.{h,cc})
at exact image geometry. A Comparator computes the original image's opsin
once and keeps it on its device, and offers:

  * the whole-image compare (ButteraugliComparator::Compare, :60-70) and
    the fused compare + block weights of the back-end loop, of a 4:4:4 or
    a 4:2:0 coefficient image;
  * the frozen per-block state of the zeroing passes (StartBlockComparisons
    :72-79 and SwitchBlock :85-111, hoisted out of the loop), with the
    4:2:0 passes' frozen chroma bytes, Y bytes, chroma neighborhoods and
    macroblock children.

PyTorch runs eagerly and CUDA work is queued asynchronously, so the
dispatch_* / fetch_* pairs keep the JAX package's structure: a dispatch
queues the device work, its fetch reads the results on the host.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import tiles as tile_ops
from guetzli_tpu_torch.ops import upsample as us
from guetzli_tpu_torch.ops.opsin import opsin_dynamics_image

_F32 = np.float32


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


class Comparator:
    """Per-image butteraugli comparator with device-resident state.

    rgb: uint8 [h, w, 3] (numpy); device: a torch.device. ``xyb0`` may be
    passed in (interop.py) instead of computed from rgb."""

    def __init__(self, rgb, width, height, target_distance, device,
                 xyb0=None):
        self.width = width
        self.height = height
        self.target_distance = float(target_distance)
        self.device = torch.device(device)
        self.rgb_orig = np.asarray(rgb, dtype=np.uint8).reshape(
            height, width, 3)
        self.xyb0 = self._original_opsin() if xyb0 is None else xyb0
        self.distance = 0.0
        self.distmap = None
        # Block-comparison state (built by start_block_comparisons).
        self._mask_xyz = None
        self._block_state = {}
        # Frozen 4:2:0 zeroing state handed in from elsewhere (interop.py):
        # "chroma_bytes", "y16", "neighborhoods" or "children"; a present
        # key is returned instead of computed.
        self.frozen_state = {}

    def _up(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _original_opsin(self):
        lut = consts.SRGB_TO_LINEAR.astype(np.float32)
        lin0 = torch.as_tensor(
            np.ascontiguousarray(lut[self.rgb_orig].transpose(2, 0, 1)),
            device=self.device)
        return opsin_dynamics_image(lin0)

    def recover_device_state(self):
        """Rebuild the device state after a recoverable error (runtime.py):
        recompute the original's opsin on the same device and drop the
        last distmap, the mask and the block state, which the next compare
        or start_block_comparisons rebuilds. The search state lives on the
        host, so a replayed dispatch gives the same result."""
        self.xyb0 = self._original_opsin()
        self.distmap = None
        self._mask_xyz = None
        self._block_state = {}

    # -- full-image comparison ------------------------------------------

    def dispatch_compare(self, img):
        """Queue a whole-image compare of a CoeffImage (4:4:4 or 4:2:0);
        fetch_compare_plain completes it."""
        if img.is_444():
            return _full_compare(self._up(img.coeffs), self.xyb0, img.bw,
                                 img.bh, self.width, self.height)
        y, u, v = img.comps
        return _full_compare_420(self._up(y.coeffs), self._up(u.coeffs),
                                 self._up(v.coeffs), self.xyb0, y.bw, y.bh,
                                 u.bw, u.bh, self.width, self.height)

    def fetch_compare_plain(self, handle):
        score, dmap = handle
        self.distance = float(score)
        self.distmap = dmap
        return self.distance

    def compare_img(self, img):
        return self.fetch_compare_plain(self.dispatch_compare(img))

    def distance_ok(self, target_mul):
        return self.distance <= target_mul * self.target_distance

    def score_output_size(self, size):
        return score_jpeg(self.distance, size, self.target_distance)

    def block_error_limit(self):
        return self.target_distance

    # -- per-block comparison state -------------------------------------

    def start_block_comparisons(self):
        self._mask_xyz = dm.mask(self.xyb0, self.xyb0)[0]

    def finish_block_comparisons(self):
        self._mask_xyz = None
        self._block_state = {}

    def block_state(self, factor_x, factor_y):
        """(xyb0_tiles [NB, 3, 64] f32, scales [NB, 3] f32, ysel [NB, 8]
        int32, xsel [NB, 8] int32) on the device, for the 8x8 pixel blocks
        of the full-resolution image (row-major)."""
        key = (factor_x, factor_y)
        if key not in self._block_state:
            if self._mask_xyz is None:
                raise RuntimeError("call start_block_comparisons first")
            w, h = self.width, self.height
            bw = (w + 7) // 8
            bh = (h + 7) // 8
            xyb0_tiles = tile_ops.original_opsin_tiles(
                self.rgb_orig, w, h, bw, bh, self.device)
            bx = np.tile(np.arange(bw), bh)
            by = np.repeat(np.arange(bh), bw)
            scales = _gather_block_scales(
                self._mask_xyz, torch.as_tensor(8 * by, device=self.device),
                torch.as_tensor(8 * bx, device=self.device))
            ysel, xsel = tile_ops.edge_gather_indices(bw, bh, w, h)
            self._block_state[key] = (
                xyb0_tiles, scales,
                torch.as_tensor(ysel, device=self.device),
                torch.as_tensor(xsel, device=self.device))
        return self._block_state[key]

    # -- 4:2:0 per-block evaluation state ---------------------------------

    def frozen_chroma_blocks(self, img):
        """[NBy, 2, 8, 8] int32 frozen Cb/Cr bytes of each full-res 8x8
        block for the 4:2:0 Y pass, edge bytes replicated by a clamped
        gather."""
        if "chroma_bytes" in self.frozen_state:
            return self.frozen_state["chroma_bytes"]
        u, v = img.comps[1], img.comps[2]
        w, h = self.width, self.height
        bw, bh = (w + 7) // 8, (h + 7) // 8
        planes = torch.stack([
            img_ops.chroma_byte_plane(self._up(c.coeffs), c.bw, c.bh, w, h)
            for c in (u, v)])                          # [2, h, w]
        gx = np.minimum(np.tile(np.arange(bw), bh)[:, None] * 8
                        + np.arange(8)[None, :], w - 1)        # [NB, 8]
        gy = np.minimum(np.repeat(np.arange(bh), bw)[:, None] * 8
                        + np.arange(8)[None, :], h - 1)
        out = planes[:, self._up(gy)[:, :, None], self._up(gx)[:, None, :]]
        return out.permute(1, 0, 2, 3).contiguous()

    def frozen_y_16x16(self, img, cbw, cbh):
        """[NBc, 16, 16] int32 frozen Y bytes of each 16x16 macroblock for
        the 4:2:0 chroma pass (clamped gather)."""
        if "y16" in self.frozen_state:
            return self.frozen_state["y16"]
        y = img.comps[0]
        w, h = self.width, self.height
        plane = img_ops.byte_plane(img_ops.blocks_to_plane(
            img_ops.idct_blocks(self._up(y.coeffs)) << 4, y.bw, y.bh, w, h))
        gx = np.minimum(np.tile(np.arange(cbw), cbh)[:, None] * 16
                        + np.arange(16)[None, :], w - 1)
        gy = np.minimum(np.repeat(np.arange(cbh), cbw)[:, None] * 16
                        + np.arange(16)[None, :], h - 1)
        return plane[self._up(gy)[:, :, None], self._up(gx)[:, None, :]]

    def frozen_neighborhoods(self, img):
        """(neigh_u, neigh_v): [NBc, 10, 10] int32 x16 subsampled
        neighborhoods of each macroblock's Cb and Cr for the 4:2:0 chroma
        pass (the frame the candidate's own IDCT is written into)."""
        if "neighborhoods" in self.frozen_state:
            return self.frozen_state["neighborhoods"]
        ws, hs = (img.width + 1) // 2, (img.height + 1) // 2
        out = []
        for c in (img.comps[1], img.comps[2]):
            sub = img_ops.blocks_to_plane(
                img_ops.idct_blocks(self._up(c.coeffs)) << 4, c.bw, c.bh,
                ws, hs)
            out.append(us.neighborhoods_10x10(sub, c.bw, c.bh))
        return tuple(out)

    def children_state(self, cbw, cbh):
        """The full-res block state gathered into [NBc, 2, 2, ...] for the
        2x2 children of each 16x16 macroblock: (xyb0_tiles, scales, ysel,
        xsel, valid [NBc, 2, 2] bool); invalid children (outside the
        image) gather block 0."""
        if "children" in self.frozen_state:
            return self.frozen_state["children"]
        xyb0_tiles, scales, ysel, xsel = self.block_state(1, 1)
        bw, bh = (self.width + 7) // 8, (self.height + 7) // 8
        cbx = np.tile(np.arange(cbw), cbh)
        cby = np.repeat(np.arange(cbh), cbw)
        ix = np.arange(2)
        child_x = cbx[:, None, None] * 2 + ix[None, None, :]   # [NBc,1,2]
        child_y = cby[:, None, None] * 2 + ix[None, :, None]   # [NBc,2,1]
        valid = (child_x < bw) & (child_y < bh)                # [NBc,2,2]
        idx = self._up(np.where(valid, child_y * bw + child_x, 0)
                       .reshape(-1))
        nbc = cbw * cbh

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

    def weights_all_radii(self, direction, target_mul, factor_x, factor_y):
        """[4, NB] weights for rblock radii 1..4 from the distmap of the
        last compare."""
        sizex, sizey, gbw, gbh = self._grid_dims(factor_x, factor_y)
        out = _weights_all_radii_impl(
            self.distmap, _F32(self.target_distance * target_mul),
            sizex, sizey, gbw, gbh, direction > 0)
        return out.cpu().numpy()

    def dispatch_compare_with_weights(self, img, direction, target_mul,
                                      factor_x, factor_y):
        """Queue the compare + next-iteration block weights; returns a
        handle for fetch_compare() or fetch_compare_many(): (score, dmap,
        w4, args), args being this call's arguments for replay()."""
        sizex, sizey, gbw, gbh = self._grid_dims(factor_x, factor_y)
        score, dmap = self.dispatch_compare(img)
        w4 = _weights_all_radii_impl(
            dmap, _F32(self.target_distance * target_mul), sizex, sizey,
            gbw, gbh, direction > 0)
        return score, dmap, w4, (img, direction, target_mul, factor_x,
                                 factor_y)

    def replay(self, handle):
        """Queue a handle's compare again. The image is the one the handle
        was dispatched for: until the handle is fetched, its owner does
        not change its coefficients, so the replay gives the same
        result."""
        return self.dispatch_compare_with_weights(*handle[3])

    def fetch_compare(self, handle):
        """Complete a dispatch_compare_with_weights: (distance, [4, NB])."""
        score, dmap, w4, _args = handle
        self.distance = float(score)
        self.distmap = dmap
        return self.distance, w4.cpu().numpy()

    def compute_block_error_adjustment_weights(
            self, direction, max_block_dist, target_mul, factor_x, factor_y,
            distmap):
        """butteraugli_comparator.cc:169-233 for one radius, in numpy."""
        target = self.target_distance * target_mul
        w, h = self.width, self.height
        sizex, sizey = 8 * factor_x, 8 * factor_y
        bw = (w + sizex - 1) // sizex
        bh = (h + sizey - 1) // sizey
        d = np.asarray(distmap, dtype=np.float32).reshape(h, w)
        pad = np.zeros((bh * sizey, bw * sizex), dtype=np.float32)
        pad[:h, :w] = d
        max_dist = pad.reshape(bh, sizey, bw, sizex).max(axis=(1, 3))

        r = max_block_dist
        local = max_dist
        for _ in range(r):
            p = np.pad(local, 1, mode='edge')
            local = np.maximum.reduce([
                p[0:-2, 0:-2], p[0:-2, 1:-1], p[0:-2, 2:],
                p[1:-1, 0:-2], p[1:-1, 1:-1], p[1:-1, 2:],
                p[2:, 0:-2], p[2:, 1:-1], p[2:, 2:]])
        max_local = np.maximum(local, target)

        weight = np.zeros((bh, bw), dtype=np.float32)
        if direction > 0:
            ok = (max_dist <= target) & (max_local <= 1.1 * target)
            weight[ok] = 1.0
        else:
            k_local_max_weight = 0.5
            src = max_dist > ((1 - k_local_max_weight) * target
                              + k_local_max_weight * max_local)
            # weight = 1/(dmin+1), dmin = Chebyshev distance to the
            # nearest src block within radius r.
            reach = src.copy()
            for dist in range(r + 1):
                contrib = np.float32(1.0 / (dist + 1.0))
                weight = np.maximum(weight, np.where(reach, contrib, 0.0))
                if dist < r:
                    p = np.pad(reach, 1, mode='constant')
                    reach = (p[0:-2, 0:-2] | p[0:-2, 1:-1] | p[0:-2, 2:]
                             | p[1:-1, 0:-2] | p[1:-1, 1:-1] | p[1:-1, 2:]
                             | p[2:, 0:-2] | p[2:, 1:-1] | p[2:, 2:])
        return weight.reshape(-1)


def fetch_compare_many(comps, handles):
    """Complete many dispatch_compare_with_weights handles (one per
    comparator in `comps`) with ONE device-to-host copy: every score and
    flattened w4 concatenated. Leaves each comparator as fetch_compare
    would (distance, distmap) and returns the same [(distance, w4)]."""
    if not handles:
        return []
    flat = torch.cat([torch.cat([h[0].reshape(1), h[2].reshape(-1)])
                      for h in handles]).cpu().numpy()
    out, pos = [], 0
    for c, (_score, dmap, w4, _args) in zip(comps, handles):
        n = w4.numel()
        c.distance = float(flat[pos])
        c.distmap = dmap
        out.append((c.distance, flat[pos + 1:pos + 1 + n].reshape(w4.shape)))
        pos += 1 + n
    return out
