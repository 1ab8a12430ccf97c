"""guetzli_tpu_torch image ops and butteraugli stages vs the JAX package
and the reference-dumped fixtures, on the CPU.

Tolerances: integer stages are bit-exact. The float stages are held to
the JAX package and to the reference fixtures at the tolerances
tests/test_butteraugli_stages.py holds the JAX package to. Both
implementations are float32 chains of the same operations, but sums and
the blur/DFT contractions run in another order, and the opsin gamma's
Clenshaw recursion turns a one-ulp input difference into ~4e-5 relative,
so every stage after the opsin is held at its stage tolerance. The blur
alone is held to the JAX package within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from guetzli_tpu import consts as jconsts
from guetzli_tpu.ops import blockdiff as jbd
from guetzli_tpu.ops import diffmap as jdm
from guetzli_tpu.ops import image as jimg
from guetzli_tpu.ops.blur import blur as jblur
from guetzli_tpu.ops.opsin import opsin_dynamics_image as jopsin

from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img
from guetzli_tpu_torch.ops.blur import blur
from guetzli_tpu_torch.ops.opsin import opsin_dynamics_image
from guetzli_tpu_torch.search import state as st

from tests.conftest import load_f32, load_u8
from tests.torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor

# The blur alone: float32 correlations summed in another order.
RTOL_BLUR_JAX = 1e-5

# The JAX references run jitted: one compile instead of op-by-op dispatch.
_jblur = jax.jit(jblur, static_argnums=(1, 2))
_jopsin = jax.jit(jopsin)
_jmhic = jax.jit(jdm.mask_high_intensity_change)
_jmask = jax.jit(jdm.mask)
_jedge = jax.jit(jdm.edge_detector_map)
_jbdm = jax.jit(jdm.block_diff_map)
_jblockdiff = jax.jit(jbd.block_diff)
_jdiffmap = jax.jit(jdm.diffmap_opsin_dynamics)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _block_weights_np(direction, max_block_dist, target, factor, distmap):
    """The back-end block weights of one radius in numpy
    (butteraugli_comparator.cc:169-233), at `target` (the comparator's
    target distance times the multiplier), the oracle of the device
    form's radii."""
    h, w = distmap.shape
    sizex = sizey = 8 * factor
    bw = (w + sizex - 1) // sizex
    bh = (h + sizey - 1) // sizey
    pad = np.zeros((bh * sizey, bw * sizex), dtype=np.float32)
    pad[:h, :w] = np.asarray(distmap, dtype=np.float32)
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
        # weight = 1/(dmin+1), dmin = Chebyshev distance to the nearest
        # src block within radius r.
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



def _lin(w, h, which=0):
    rgb = load_u8(f"{w}x{h}_rgb{which}.u8", (h * w, 3))
    lut = jconsts.SRGB_TO_LINEAR.astype(np.float32)
    return np.ascontiguousarray(lut[rgb].T.reshape(3, h, w))


# -- integer stages: bit for bit ------------------------------------------

def test_idct_blocks_bit_exact():
    rng = np.random.default_rng(3)
    c = rng.integers(-1024, 1024, (5, 7, 64)).astype(np.int32)
    c[..., 0] = rng.integers(-2048, 2048, (5, 7))
    want = np.asarray(jimg.idct_blocks(jnp.asarray(c)))
    got = _np(img.idct_blocks(T(c)))
    np.testing.assert_array_equal(got, want)


def test_ycbcr_to_rgb_bit_exact():
    rng = np.random.default_rng(4)
    y, cb, cr = (rng.integers(0, 256, (16, 16)).astype(np.int32)
                 for _ in range(3))
    want = np.asarray(jimg.ycbcr_to_rgb(jnp.asarray(y), jnp.asarray(cb),
                                        jnp.asarray(cr)))
    got = _np(img.ycbcr_to_rgb(T(y), T(cb), T(cr)))
    np.testing.assert_array_equal(got, want)


def test_quantize_bit_exact():
    from guetzli_tpu.search import state as jst
    rng = np.random.default_rng(5)
    c = rng.integers(-4096, 4097, (50, 64)).astype(np.int32)
    q = rng.integers(1, 256, 64).astype(np.int32)
    want = np.asarray(jimg.quantize_coeffs(jnp.asarray(c), jnp.asarray(q)))
    np.testing.assert_array_equal(st.quantize(c, q[None, :]),
                                  jst.quantize(c, q[None, :]))
    np.testing.assert_array_equal(st.quantize(c, q[None, :]), want)


def test_coeffs_to_srgb_bit_exact(size):
    w, h = size
    bw, bh = -(-w // 8), -(-h // 8)
    rng = np.random.default_rng(6)
    c = rng.integers(-300, 300, (3, bw * bh, 64)).astype(np.int32)
    c[:, :, 0] = rng.integers(-1000, 1000, (3, bw * bh))
    want = np.asarray(jimg.coeffs_to_srgb(jnp.asarray(c), bw, bh, w, h))
    got = _np(img.coeffs_to_srgb(T(c), bw, bh, w, h))
    np.testing.assert_array_equal(got, want)


def test_roundtrip_srgb_fixture(size):
    """IDCT + pixel cache + color of the reference's own first JPEG
    reproduce the reference's decoded bytes."""
    w, h = size
    bw, bh = -(-w // 8), -(-h // 8)
    coeffs = load_f32(f"{w}x{h}_init_coeffs.f32", (3, bh * bw, 64))
    ref = load_u8(f"{w}x{h}_roundtrip_srgb.u8", (h, w, 3))
    got = _np(img.coeffs_to_srgb(T(coeffs.astype(np.int32)), bw, bh, w, h))
    np.testing.assert_array_equal(got.transpose(1, 2, 0), ref)


def test_srgb_to_linear():
    v = np.arange(256, dtype=np.int32)
    want = np.asarray(jimg.srgb_to_linear(jnp.asarray(v)))
    _close(img.srgb_to_linear(T(v)), want, 1e-6, 0)
    _close(img.srgb_to_linear(T(v)),
           jconsts.SRGB_TO_LINEAR.astype(np.float32), 1e-5, 1e-6)


# -- float stages ---------------------------------------------------------

@pytest.mark.parametrize("sigma,tag", [
    (1.1, "blur_1.100000"), (1.5, "blur_1.500000"),
    (0.586, "blur_0.586000"), (0.4, "blur_0.400000"),
    (4.53358927369, "blur_4.533589"), (9.65781083553, "blur_9.657811"),
    (14.2644604355, "blur_14.264460"), (8.8510880283, "blur_8.851088"),
])
def test_blur(size, sigma, tag):
    w, h = size
    x = _lin(w, h)[1]
    got = blur(T(x), sigma, 0.0)
    _close(got, load_f32(f"{w}x{h}_{tag}.f32", (h, w)), 2e-4, 2e-3)
    _close(got, _jblur(jnp.asarray(x), sigma, 0.0), RTOL_BLUR_JAX, 1e-6)


def test_blur_border_ratio(size):
    w, h = size
    x = _lin(w, h)[1]
    got = blur(T(x), 8.8510880283, 0.03027655136)
    _close(got, load_f32(f"{w}x{h}_blur_diffmap_border.f32", (h, w)),
           2e-4, 2e-3)
    _close(got, _jblur(jnp.asarray(x), 8.8510880283, 0.03027655136),
           RTOL_BLUR_JAX, 1e-6)


def test_opsin_dynamics(size):
    w, h = size
    for which in (0, 1):
        lin = _lin(w, h, which)
        got = opsin_dynamics_image(T(lin))
        _close(got, load_f32(f"{w}x{h}_xyb{which}.f32", (3, h, w)),
               5e-4, 5e-3)
        _close(got, _jopsin(jnp.asarray(lin)), 5e-4, 5e-3)


def _xyb(w, h):
    return (load_f32(f"{w}x{h}_xyb0.f32", (3, h, w)),
            load_f32(f"{w}x{h}_xyb1.f32", (3, h, w)))


def _mhic_fixture(w, h):
    return (load_f32(f"{w}x{h}_mhic0.f32", (3, h, w)),
            load_f32(f"{w}x{h}_mhic1.f32", (3, h, w)))


def test_mask_high_intensity_change(size):
    w, h = size
    x0, x1 = _xyb(w, h)
    m0, m1 = dm.mask_high_intensity_change(T(x0), T(x1))
    r0, r1 = _mhic_fixture(w, h)
    _close(m0, r0, 2e-4, 2e-3)
    _close(m1, r1, 2e-4, 2e-3)
    j0, j1 = _jmhic(jnp.asarray(x0), jnp.asarray(x1))
    _close(m0, j0, 2e-4, 2e-3)
    _close(m1, j1, 2e-4, 2e-3)


def test_mask(size):
    w, h = size
    m0, m1 = _mhic_fixture(w, h)
    mask, mask_dc = dm.mask(T(m0), T(m1))
    _close(mask, load_f32(f"{w}x{h}_mask.f32", (3, h, w)), 2e-3, 2e-3)
    _close(mask_dc, load_f32(f"{w}x{h}_mask_dc.f32", (3, h, w)), 2e-3, 2e-3)
    jm, jmdc = _jmask(jnp.asarray(m0), jnp.asarray(m1))
    _close(mask, jm, 2e-3, 2e-3)
    _close(mask_dc, jmdc, 2e-3, 2e-3)


def _res_grid(w, h, step=3):
    return -(-w // step), -(-h // step)


def test_edge_detector_map(size):
    w, h = size
    rx, ry = _res_grid(w, h)
    m0, m1 = _mhic_fixture(w, h)
    got = _np(dm.edge_detector_map(T(m0), T(m1)))
    want = np.asarray(_jedge(jnp.asarray(m0), jnp.asarray(m1)))
    ny, nx = want.shape[:2]
    assert got.shape == (ry, rx, 3)
    _close(got[:ny, :nx], want, 5e-4, 5e-4)
    ref = load_f32(f"{w}x{h}_edge_map.f32", (ry, rx, 3))
    _close(got, ref, 5e-4, 5e-4)


def test_block_diff_map(size):
    w, h = size
    rx, ry = _res_grid(w, h)
    m0, m1 = _mhic_fixture(w, h)
    dc, ac = dm.block_diff_map(T(m0), T(m1))
    _close(dc, load_f32(f"{w}x{h}_block_dc.f32", (ry, rx, 3)), 1e-3, 1e-3)
    _close(ac, load_f32(f"{w}x{h}_block_ac.f32", (ry, rx, 3)), 1e-3, 1e-3)
    jdc, jac = _jbdm(jnp.asarray(m0), jnp.asarray(m1))
    ny, nx = np.asarray(jdc).shape[:2]
    _close(_np(dc)[:ny, :nx], jdc, 1e-3, 1e-3)
    _close(_np(ac)[:ny, :nx], jac, 1e-3, 1e-3)


def test_edge_detector_low_freq(size):
    w, h = size
    rx, ry = _res_grid(w, h)
    m0, m1 = _mhic_fixture(w, h)
    _, ac = dm.block_diff_map(T(m0), T(m1))
    got = dm.edge_detector_low_freq(T(m0), T(m1), ac)
    _close(got, load_f32(f"{w}x{h}_block_ac_lf.f32", (ry, rx, 3)),
           1e-3, 1e-3)


def test_blockdiff_8x8():
    w, h = 96, 64
    ref = load_f32(f"{w}x{h}_blockdiff.f32", (4, 3, 3))
    m0, m1 = _mhic_fixture(w, h)
    b0, b1 = [], []
    for bi in range(4):
        bx, by = (bi % 2) * 8, (bi // 2) * 8
        b0.append(m0[:, by:by + 8, bx:bx + 8].reshape(3, 64))
        b1.append(m1[:, by:by + 8, bx:bx + 8].reshape(3, 64))
    b0, b1 = np.stack(b0), np.stack(b1)
    dc, ac, edge = bd.block_diff(T(b0), T(b1))
    got = np.stack([_np(dc), _np(ac), _np(edge)], axis=1)
    _close(got, ref, 1e-3, 1e-3)
    want = np.stack([np.asarray(a) for a in _jblockdiff(b0, b1)], axis=1)
    _close(got, want, 1e-3, 1e-3)


def test_full_diffmap_and_score(size):
    w, h = size
    x0, x1 = _xyb(w, h)
    got = dm.diffmap_opsin_dynamics(T(x0), T(x1))
    _close(got, load_f32(f"{w}x{h}_diffmap.f32", (h, w)), 2e-3, 2e-3)
    ref_score = load_f32(f"{w}x{h}_score.f32", (1,))[0]
    score = float(dm.score_from_diffmap(got))
    assert abs(score - ref_score) < 2e-3 * max(1.0, ref_score)
    want = np.asarray(_jdiffmap(jnp.asarray(x0), jnp.asarray(x1)))
    _close(got, want, 2e-3, 2e-3)
    assert abs(score - float(want.max())) < 2e-3 * max(1.0, score)


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("factor", [1, 2])
def test_block_weights(direction, factor):
    """The back-end block weights: the device form for all four radii vs
    the port's host form and the JAX package's device form (0/1 and
    1/(d+1) values from maxima and comparisons: exact)."""
    from guetzli_tpu.comparator import Comparator as JComparator
    from guetzli_tpu_torch.comparator import Comparator
    rng = np.random.RandomState(42)
    w, h = 96, 64
    rgb = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
    distmap = (rng.rand(h, w) * 2.0).astype(np.float32)
    comp = Comparator(rgb, w, h, 1.0, "cpu")
    comp.distmap = T(distmap)
    w4 = comp.weights_all_radii(direction, 0.97, factor, factor)
    jcomp = JComparator(rgb, w, h, 1.0, padded=False)
    jcomp.distmap = jnp.asarray(distmap)
    np.testing.assert_array_equal(
        w4, jcomp.weights_all_radii(direction, 0.97, factor, factor))
    for rblock in range(1, 5):
        want = _block_weights_np(direction, rblock,
                                 comp.target_distance * 0.97, factor,
                                 distmap)
        np.testing.assert_allclose(w4[rblock - 1], want, atol=1e-6)


def test_whole_image_compare_matches_jax():
    """Comparator.compare_img (coefficients -> diffmap -> score) on bees
    at its first JPEG, within the diffmap stage tolerance."""
    from guetzli_tpu.comparator import Comparator as JComparator
    from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
    from guetzli_tpu.io.png import read_png as jread_png
    from guetzli_tpu.search import state as jst
    from guetzli_tpu_torch.comparator import Comparator
    from tests.conftest import FIXTURES
    rgb, w, h = jread_png((FIXTURES / "bees96x64.png").read_bytes())
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    img = jst.CoeffImage.from_jpeg(jpg)
    jcomp = JComparator(rgb, w, h, 1.0, padded=False)
    want = jcomp.compare(img.coeffs, img.bw, img.bh)
    comp = Comparator(rgb, w, h, 1.0, "cpu")
    got = comp.compare_img(img)
    assert abs(got - want) < 2e-3 * max(1.0, want)
    _close(comp.distmap, jcomp.distmap, 2e-3, 2e-3)
