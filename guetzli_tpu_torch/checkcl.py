"""Runtime kernel verification: the CHECKCL/CHECKCUDA analog.

Port of guetzli_tpu/checkcl.py. The reference's --checkcl mode runs every
OpenCL kernel next to the CPU implementation on the same inputs and
reports per-stage mismatch counts at tol=0.001 (clguetzli_test.cpp:21-36,
one tcl* comparator per stage at :38-449). Here the "CPU implementation"
is ops/numpy_ref.py, a float64 NumPy build of every butteraugli stage,
and each stage of the port runs on the caller's device and is diffed
against it on the user's own image:

  each blur sigma, opsin, MaskHighIntensityChange, EdgeDetectorMap,
  BlockDiffMap (dc+ac), EdgeDetectorLowFreq, DiffPrecompute, Average5x5,
  MinSquareVal, Mask(+dc), CombineChannels, CalculateDiffmap, score, and
  the per-block CompareBlock (blocks-leading, then lane-major).

Then the block compare kernels run on every block of the image against
the blocks-leading compare: kernel C (kernels/tile_compare.py) and kernel
A (kernels/tile_compare_lanes.py). On a CUDA device the lines say
``(cuda)`` and the kernels launch or raise: an exception propagates, no
line is skipped. On the CPU the wrappers run their plain versions and the
lines say ``(plain)``. The sharded-blur check of the JAX package waits for
the multi-GPU slice of the port.

Every line goes to stderr as ``checkcl <stage>: <bad>/<n> mismatches over
tol <tol> (max rel err <e>)``, the JAX package's format.
"""

import sys

import numpy as np
import torch

_TOL = 1e-3  # clguetzli_test.cpp:27 floatCompare tolerance


def _host64(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).ravel()


def _report(stage, got, want, tol=_TOL):
    got = _host64(got)
    want = _host64(want)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    bad = int((err > tol).sum())
    sys.stderr.write(
        f"checkcl {stage}: {bad}/{got.size} mismatches over tol {tol:g} "
        f"(max rel err {float(err.max() if err.size else 0):.2e})\n")
    return bad


def _quant3_jpeg(rgb, w, h):
    """The image encoded at quant 3 everywhere: the realistic distorted
    second image of the checks."""
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    return encode_rgb_to_jpeg(rgb, w, h,
                              quant=np.full((3, 64), 3, dtype=np.int32))


def _blocks(jpg):
    """[NB, 3, 64] int32 dequantized coefficients of a quant-3 jpg."""
    coeffs = np.stack([c.coeffs.astype(np.int32) * 3
                       for c in jpg.components])
    return np.ascontiguousarray(np.transpose(coeffs, (1, 0, 2)))


def _stage_checks(rgb, w, h, device):
    """Diff every butteraugli stage of the port, on `device`, against the
    float64 NumPy oracle on this image. Returns the total mismatch
    count."""
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.ops import diffmap as dm_ops
    from guetzli_tpu_torch.ops import numpy_ref as nr
    from guetzli_tpu_torch.ops import opsin as opsin_ops
    from guetzli_tpu_torch.ops import tiles as tile_ops
    from guetzli_tpu_torch.ops import tiles_lanes as tl
    from guetzli_tpu_torch.ops.blur import blur
    from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb

    total = 0
    lut = consts.SRGB_TO_LINEAR.astype(np.float64)
    rgb = np.asarray(rgb, dtype=np.uint8).reshape(h, w, 3)
    lin0 = lut[rgb].transpose(2, 0, 1)                       # [3, H, W]
    # Candidate: the quant-3 reconstruction, decoded through the
    # production path.
    jpg = _quant3_jpeg(rgb, w, h)
    rgb1 = decode_jpeg_to_rgb(jpg)
    lin1 = lut[rgb1].transpose(2, 0, 1)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)

    # Stage: blur, each sigma the pipeline uses (tclBlur analog).
    sigmas = sorted({consts.OPSIN_SIGMA, consts.EDGE_LF_SIGMA,
                     consts.DIFFMAP_SIGMA}
                    | set(consts.EDGE_DETECTOR_SIGMAS)
                    | set(consts.MASK_SIGMAS))
    for s in sigmas:
        total += _report(f"Blur sigma={s:g}", blur(f32(lin0[1]), s, 0.0),
                         nr.blur(lin0[1], s, 0.0))

    # Stage: opsin dynamics (tclOpsinDynamicsImage). The sensitivity
    # division gamma(pre)/pre amplifies float32-vs-float64 blur noise, so
    # this stage is held at 5e-3, as in the JAX package.
    xyb0 = nr.opsin_dynamics_image(lin0)
    xyb1 = nr.opsin_dynamics_image(lin1)
    total += _report("OpsinDynamicsImage",
                     opsin_ops.opsin_dynamics_image(f32(lin0)), xyb0,
                     tol=5e-3)

    m0, m1 = nr.mask_high_intensity_change(xyb0, xyb1)
    g0, g1 = dm_ops.mask_high_intensity_change(f32(xyb0), f32(xyb1))
    total += _report("MaskHighIntensityChange", torch.stack([g0, g1]),
                     np.stack([m0, m1]))

    want_edge = nr.edge_detector_map(m0, m1)
    total += _report("EdgeDetectorMap",
                     dm_ops.edge_detector_map(f32(m0), f32(m1)), want_edge)

    want_dc, want_ac = nr.block_diff_map(m0, m1)
    got_dc, got_ac = dm_ops.block_diff_map(f32(m0), f32(m1))
    total += _report("BlockDiffMap(dc)", got_dc, want_dc)
    total += _report("BlockDiffMap(ac)", got_ac, want_ac)

    want_ac2 = nr.edge_detector_low_freq(m0, m1, want_ac)
    total += _report("EdgeDetectorLowFreq",
                     dm_ops.edge_detector_low_freq(f32(m0), f32(m1),
                                                   f32(want_ac)), want_ac2)

    want_pre = nr.diff_precompute(m0, m1)
    total += _report("DiffPrecompute",
                     dm_ops.diff_precompute(f32(m0), f32(m1)), want_pre)
    want_avg = np.stack([nr.average5x5(p) for p in want_pre])
    total += _report("Average5x5", dm_ops.average5x5(f32(want_pre)),
                     want_avg)
    want_min = np.stack([nr.min_square_val(p) for p in want_avg])
    total += _report("MinSquareVal", dm_ops.min_square_val(f32(want_avg)),
                     want_min)
    want_mask, want_mask_dc = nr.mask(m0, m1)
    got_mask, got_mask_dc = dm_ops.mask(f32(m0), f32(m1))
    total += _report("Mask", got_mask, want_mask)
    total += _report("Mask(dc)", got_mask_dc, want_mask_dc)

    want_res = nr.combine_channels(want_mask, want_mask_dc, want_dc,
                                   want_ac2, want_edge, h, w)
    total += _report("CombineChannels", dm_ops.combine_channels(
        f32(want_mask), f32(want_mask_dc), f32(want_dc), f32(want_ac2),
        f32(want_edge), h, w), want_res)
    want_dm = nr.calculate_diffmap(want_res, h, w)
    got_dm = dm_ops.calculate_diffmap(f32(want_res), h, w)
    total += _report("CalculateDiffmap", got_dm, want_dm)
    total += _report("ButteraugliScore", dm_ops.score_from_diffmap(got_dm),
                     nr.score_from_diffmap(want_dm))

    # Stage: the per-block CompareBlock on up to 128 blocks, blocks
    # leading and then lane-major, against the oracle.
    bw, bh = -(-w // 8), -(-h // 8)
    nb = min(bw * bh, 128)
    xyb0_tiles = tile_ops.original_opsin_tiles(rgb, w, h, bw, bh,
                                               device)[:nb]
    cand = torch.as_tensor(_blocks(jpg)[:nb], device=device)
    ysel, xsel = tile_ops.edge_gather_indices(bw, bh, w, h)
    ysel = torch.as_tensor(ysel[:nb], device=device)
    xsel = torch.as_tensor(xsel[:nb], device=device)
    cand_lin = tile_ops.tiles_to_linear_rgb(cand, xsel, ysel)
    corner = np.arange(nb)
    scales = np.ascontiguousarray(np.stack(
        [want_mask[c, (corner // bw) * 8, (corner % bw) * 8]
         for c in range(3)], axis=-1))
    want_cb = nr.compare_blocks(
        xyb0_tiles.cpu().numpy().reshape(nb, 3, 8, 8).astype(np.float64),
        cand_lin.cpu().numpy().astype(np.float64), scales)
    got_cb = tile_ops.compare_blocks(xyb0_tiles, cand_lin, f32(scales))
    total += _report(f"CompareBlock[{nb} blocks]", got_cb, want_cb)
    aux_t = tl.transpose_aux_444(xyb0_tiles, f32(scales), ysel, xsel)
    total += _report(f"CompareBlockLanes[{nb} blocks]",
                     tl.compare_blocks_lanes444(cand, *aux_t), want_cb)
    return total


def run_checkcl(rgb, w, h, device="cuda") -> int:
    """Verify every stage and both block compare kernels on this image,
    on `device`. Returns the total mismatch count (0 = all agree)."""
    from guetzli_tpu_torch.comparator import Comparator
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.kernels import tile_compare as kc
    from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
    from guetzli_tpu_torch.ops import tiles as tile_ops
    from guetzli_tpu_torch.ops import tiles_lanes as tl

    dev = resolve(device)
    total = _stage_checks(rgb, w, h, dev)
    label = "cuda" if dev.type == "cuda" else "plain"

    # Every block of the image, from the exact-geometry Comparator: the
    # candidates and the block state have the same row count.
    cand = torch.as_tensor(_blocks(_quant3_jpeg(rgb, w, h)), device=dev)
    comp = Comparator(rgb, w, h, 1.0, dev, padded=False)
    comp.start_block_comparisons()
    xyb0_tiles, scales, ysel, xsel = comp.block_state(1, 1)
    xyb0_tiles = xyb0_tiles.contiguous()
    want = tile_ops.compare_blocks(
        xyb0_tiles, tile_ops.tiles_to_linear_rgb(cand, xsel, ysel), scales)

    # Kernel C (the analog of tclComputeBlockZeroingOrder).
    sy, sx = kc.selection_matrices(ysel, xsel)
    got = kc.tile_compare(cand, xyb0_tiles, scales, sy, sx)
    total += _report(f"tile_compare({label})", got, want)

    # Kernel A. Its agreement band with the blocks-leading compare is 5e-3
    # (different reduction orders; tests/test_pallas_kernel.py), as in
    # the JAX package.
    ct = cand.reshape(-1, 3, 8, 8).permute(1, 2, 3, 0).contiguous()
    got = ka.tile_compare_lanes(
        ct, *tl.transpose_aux_444(xyb0_tiles, scales, ysel, xsel))
    total += _report(f"tile_compare_lanes({label})", got, want, tol=5e-3)

    ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
    sys.stderr.write("checkcl blur(sharded): %s\n" % _sharded_blur_note(ndev))
    return total


def _sharded_blur_note(ndev):
    """Why the sharded-blur check of the JAX package does not run here."""
    if ndev > 1:
        return ("SKIPPED (%d devices: the sharded blur waits for the "
                "multi-GPU slice of the port)" % ndev)
    return "SKIPPED (1 device)"
