"""The port's padded bucket geometry (guetzli_tpu_torch/ops/padgeom.py)
against the JAX package's (guetzli_tpu/ops/padgeom.py), on the CPU:

  * bucket_dim at the bucket edges and over a range of sizes;
  * PadGeom's grids, its pad/unpad round trips on seeded blocks and
    planes, and its real_index, equal to JAX's bit for bit;
  * the float64-accumulated blur border scales of every blur, and the
    flat vector the port carries them in, equal to JAX's bit for bit;
  * blur_dyn of a zero-padded image equal to the exact blur at its valid
    pixels, and a stacked image's rows equal to each image alone.
"""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu.ops import blur as jblur
from guetzli_tpu.ops import padgeom as jpg

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops import blur as tblur
from guetzli_tpu_torch.ops import padgeom as tpg

SIZES = [(97, 63), (111, 64), (128, 64), (160, 120), (1444, 908),
         (33, 513)]


def test_bucket_dim_edges_and_range():
    for n in (1, 31, 32, 33, 256, 257, 512, 513, 1024, 1025, 4000):
        assert tpg.bucket_dim(n) == jpg.bucket_dim(n)
    got = [tpg.bucket_dim(n) for n in range(1, 3000, 7)]
    assert got == [jpg.bucket_dim(n) for n in range(1, 3000, 7)]
    assert tpg.bucket_dim(97) == tpg.bucket_dim(128) == 128
    assert tpg.bucket_dim(63) == 64


@pytest.mark.parametrize("w,h", SIZES)
def test_padgeom_grids_and_round_trips(w, h):
    t, j = tpg.PadGeom(w, h), jpg.PadGeom(w, h)
    for k in ("w", "h", "wp", "hp", "bw", "bh", "bwp", "bhp"):
        assert getattr(t, k) == getattr(j, k), k
    rng = np.random.RandomState(w * 7 + h)
    blocks = rng.randint(-1000, 1000, size=(3, t.bh * t.bw, 64)) \
        .astype(np.int32)
    pb = t.pad_blocks(blocks)
    np.testing.assert_array_equal(pb, j.pad_blocks(blocks))
    np.testing.assert_array_equal(
        t.unpad_blocks(pb[0]), j.unpad_blocks(pb[0]))
    np.testing.assert_array_equal(t.unpad_blocks(pb[1]), blocks[1])
    plane = rng.rand(3, h, w).astype(np.float32)
    pp = t.pad_plane(plane)
    np.testing.assert_array_equal(pp, j.pad_plane(plane))
    assert pp.shape == (3, t.hp, t.wp) and not pp[:, h:].any()
    np.testing.assert_array_equal(pp[:, :h, :w], plane)
    # A factor-2 grid (the 4:2:0 chroma pass's) and its weight rows.
    cbw, cbh = -(-w // 16), -(-h // 16)
    cbwp, cbhp = t.wp // 16, t.hp // 16
    c = rng.randint(0, 9, size=(cbh * cbw, 5)).astype(np.int32)
    pc = t.pad_blocks(c, cbw, cbh, cbwp, cbhp)
    np.testing.assert_array_equal(pc, j.pad_blocks(c, cbw, cbh, cbwp,
                                                   cbhp))
    w4 = rng.rand(4, cbhp * cbwp).astype(np.float32)
    np.testing.assert_array_equal(t.unpad_grid(w4, cbw, cbh, cbwp, cbhp),
                                  j.unpad_grid(w4, cbw, cbh, cbwp, cbhp))
    ri = t.real_index(cbw, cbh, cbwp)
    np.testing.assert_array_equal(pc[ri], c)
    assert len(np.unique(ri)) == cbw * cbh


@pytest.mark.parametrize("w,h", SIZES)
def test_scales_bit_for_bit(w, h):
    t, j = tpg.PadGeom(w, h), jpg.PadGeom(w, h)
    ts, js = t.scales(), j.scales()
    assert list(ts) == list(js)
    for name in js:
        for a, b in zip(ts[name], js[name]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=name)
    flat = torch.as_tensor(t.scales_flat())[None]
    for name, (sx, sy) in tpg.split_scales(flat, t.wp, t.hp).items():
        np.testing.assert_array_equal(sx[0].numpy(), js[name][0])
        np.testing.assert_array_equal(sy[0].numpy(), js[name][1])


@pytest.mark.parametrize("sigma,br", [(1.1, 0.0), (14.0, 0.0),
                                      (consts.DIFFMAP_SIGMA,
                                       consts.DIFFMAP_BORDER_RATIO)])
def test_border_scales_match_jax(sigma, br):
    for size, padded in ((97, 128), (59, 64), (1444, 1536), (32, 32)):
        np.testing.assert_array_equal(
            tblur.border_scales(size, padded, sigma, br),
            jblur.border_scales(size, padded, sigma, br))


@pytest.mark.parametrize("sigma", [1.1, 0.586, 9.65781083553, 14.0])
def test_blur_dyn_valid_pixels_and_stacking(sigma):
    rng = np.random.RandomState(int(sigma * 100))
    sizes = [(97, 63), (111, 64), (128, 64)]
    planes, want, geoms = [], [], []
    for w, h in sizes:
        x = rng.rand(2, h, w).astype(np.float32)
        g = tpg.PadGeom(w, h)
        geoms.append(g)
        want.append(tblur.blur(torch.as_tensor(x), sigma))
        planes.append(torch.as_tensor(g.pad_plane(x)))
    name = {1.1: "opsin", 0.586: "ed1", 14.0: "edlf"}.get(sigma, "mask0")
    flat = torch.stack([torch.as_tensor(g.scales_flat()) for g in geoms])
    sx, sy = tpg.split_scales(flat, 128, 64)[name]
    stacked = tblur.blur_dyn(torch.stack(planes, 1), sigma, sx, sy)
    for i, ((w, h), g) in enumerate(zip(sizes, geoms)):
        one = tblur.blur_dyn(planes[i][:, None], sigma, sx[i:i + 1],
                             sy[i:i + 1])[:, 0]
        assert torch.equal(stacked[:, i], one)
        torch.testing.assert_close(one[:, :h, :w], want[i], rtol=0,
                                   atol=0)
