"""The plain version of kernel A (guetzli_tpu_torch ops/tiles_lanes.py, and
kernels/tile_compare_lanes.tile_compare_lanes on CPU tensors) vs the JAX
lane-major compare and its Pallas kernel in interpret mode.

Both sides evaluate the same frozen block state: the JAX Comparator's
(unpadded) block state is carried across with interop. Integer stages are
bit-exact; block errors agree with JAX run op by op within rtol 1e-5. The
Pallas kernel runs jitted, where XLA's CPU backend contracts multiply-adds
into FMAs; against it the port is held to JAX's own op-by-op distance
from it, plus 1e-5.

The sRGB->linear step is a float32 power. XLA's and PyTorch's pow differ
by one ulp at 6 of the 256 byte values, and the opsin gamma's Chebyshev
recursion amplifies such an ulp to ~1e-4 in a block error. So the 1e-5
comparisons hand the port JAX's own 256 values (``jax_srgb``, as the
frozen state is handed over); the table itself is held to JAX within 1e-6
in test_torch_ops.py, and test_compare_blocks_own_srgb_table measures the
port with its own table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import consts as jconsts
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.kernels import tile_compare_lanes as jtcl
from guetzli_tpu.ops import tiles_lanes as jtl
from guetzli_tpu.search import state as jst

from guetzli_tpu_torch import interop
from guetzli_tpu_torch.kernels import tile_compare_lanes as tcl
from guetzli_tpu_torch.ops import tiles_lanes as tl

T = torch.as_tensor
RTOL = 1e-5


@pytest.fixture(scope="module")
def bees_state():
    """The bees image's q95 coefficients [NB, 3, 64] and the JAX
    comparator's block state, as numpy."""
    with open(FIXTURES / "bees96x64.png", "rb") as f:
        rgb, w, h = jread_png(f.read())
    target = jconsts.butteraugli_score_for_quality(95)
    comp = JComparator(rgb, w, h, target, padded=False)
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    img = jst.CoeffImage.from_jpeg(jpg)
    comp.start_block_comparisons()
    aux = tuple(np.asarray(a) for a in comp.block_state(1, 1))
    cand = np.ascontiguousarray(img.coeffs.transpose(1, 0, 2))
    port = interop.comparator_state_from_numpy(
        rgb, w, h, target, np.asarray(comp.xyb0),
        np.asarray(comp._mask_xyz), aux, device="cpu")
    return cand, aux, port


@pytest.fixture
def jax_srgb(monkeypatch):
    """Make the port's block compare read JAX's sRGB->linear values."""
    from guetzli_tpu_torch.ops import image as img_ops
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: T(lut).to(device))
    return lut


def _zeroed(cand, seed):
    """Each block with one nonzero AC coefficient zeroed (a zeroing
    candidate)."""
    rng = np.random.default_rng(seed)
    out = cand.copy()
    for b in range(out.shape[0]):
        nz = np.flatnonzero(out[b].reshape(-1) % 64 != 0)
        nz = [k for k in nz if out[b].reshape(-1)[k] != 0]
        if nz:
            out[b].reshape(-1)[rng.choice(nz)] = 0
    return out


def test_idct_lanes_bit_exact():
    rng = np.random.default_rng(7)
    c = rng.integers(-600, 600, (3, 8, 8, 40)).astype(np.int32)
    want = np.asarray(jtl.idct_lanes(jnp.asarray(c)))
    np.testing.assert_array_equal(tl.idct_lanes(T(c)).numpy(), want)


def test_edge_replicate_lanes_bit_exact():
    rng = np.random.default_rng(8)
    v = rng.integers(0, 256, (3, 8, 8, 64)).astype(np.int32)
    ymax = rng.integers(0, 8, 64).astype(np.int32)
    xmax = rng.integers(0, 8, 64).astype(np.int32)
    want = np.asarray(jtl.edge_replicate_lanes(
        jnp.asarray(v), jnp.asarray(ymax), jnp.asarray(xmax)))
    got = tl.edge_replicate_lanes(T(v), T(ymax), T(xmax)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_state_carried_across(bees_state):
    """interop hands the port exactly the JAX comparator's state, and the
    port's own block state agrees with it."""
    cand, aux, port = bees_state
    got = port.block_state(1, 1)
    for g, a in zip(got, aux):
        np.testing.assert_array_equal(g.numpy(), a)
    from guetzli_tpu_torch.comparator import Comparator
    with open(FIXTURES / "bees96x64.png", "rb") as f:
        rgb, w, h = jread_png(f.read())
    own = Comparator(rgb, w, h, 1.0, "cpu")
    own.start_block_comparisons()
    tiles, scales, ysel, xsel = own.block_state(1, 1)
    np.testing.assert_allclose(tiles.numpy(), aux[0], rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(scales.numpy(), aux[1], rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(ysel.numpy(), aux[2])
    np.testing.assert_array_equal(xsel.numpy(), aux[3])


@pytest.fixture(scope="module")
def jax_errors(bees_state):
    """Zeroing candidates of every block, and JAX's errors for them: the
    lane-major compare run op by op, and the Pallas kernel in interpret
    mode. The latter runs jitted, where XLA contracts multiply-adds into
    FMAs; the two JAX forms differ by ~1.6e-3 relative."""
    cand, aux, _port = bees_state
    cand = _zeroed(cand, 2)
    eager = np.asarray(jtl.compare_blocks_lanes444(
        jnp.asarray(cand), *jtl.transpose_aux_444(*aux)))
    n = cand.shape[0]
    npad = -(-n // jtcl.TILE_N) * jtcl.TILE_N

    def pad(a):
        return np.concatenate(
            [a, np.zeros((npad - n,) + a.shape[1:], a.dtype)])

    pallas = np.asarray(jtcl.tile_compare_pallas_lanes(
        jnp.asarray(pad(cand)), jnp.asarray(pad(aux[0])),
        jnp.asarray(pad(aux[1])), jnp.asarray(pad(aux[2])),
        jnp.asarray(pad(aux[3])), interpret=True))[:n]
    return cand, eager, pallas


def _port_errors(port, cand):
    """Kernel A's wrapper on CPU tensors (its plain version)."""
    ct = T(cand).reshape(-1, 3, 8, 8).permute(1, 2, 3, 0).contiguous()
    before = dict(tcl.launches)
    out = tcl.tile_compare_lanes(ct, *tl.transpose_aux_444(
        *port.block_state(1, 1))).numpy()
    assert tcl.launches == before     # the plain version launches nothing
    return out


def test_compare_blocks_lanes444(bees_state, jax_errors, jax_srgb):
    """Against JAX run op by op: the same float32 operations in the same
    order, so within rtol 1e-5 (in fact equal)."""
    _cand0, _aux, port = bees_state
    cand, eager, _pallas = jax_errors
    aux_t = tl.transpose_aux_444(*port.block_state(1, 1))
    got = tl.compare_blocks_lanes444(T(cand), *aux_t).numpy()
    np.testing.assert_allclose(got, eager, rtol=RTOL, atol=0)
    np.testing.assert_allclose(_port_errors(port, cand), eager, rtol=RTOL,
                               atol=0)


def test_kernel_a_plain_vs_pallas_interpret(bees_state, jax_errors,
                                            jax_srgb):
    """Against the Pallas kernel in interpret mode: per block, the port is
    no farther from it than JAX's own op-by-op result is, plus 1e-5."""
    _cand0, _aux, port = bees_state
    cand, eager, pallas = jax_errors
    got = _port_errors(port, cand)
    bound = np.abs(eager - pallas) + RTOL * np.abs(pallas)
    assert np.all(np.abs(got - pallas) <= bound)


def test_compare_blocks_own_srgb_table(bees_state, jax_errors):
    """With its own sRGB table the port stays within the 2e-3 band
    tests/test_tiles_lanes.py holds the JAX lane path to."""
    _cand0, _aux, port = bees_state
    cand, eager, _pallas = jax_errors
    np.testing.assert_allclose(_port_errors(port, cand), eager, rtol=2e-3,
                               atol=1e-3)


def test_kernel_a_wrapper_checks():
    n = 4
    ct = torch.zeros((3, 8, 8, n), dtype=torch.int32)
    x0 = torch.zeros((3, 8, 8, n))
    sc = torch.ones((3, n))
    ym = torch.full((n,), 7, dtype=torch.int32)
    with pytest.raises(TypeError):
        tcl.tile_compare_lanes(ct.float(), x0, sc, ym, ym)
    with pytest.raises(ValueError):
        tcl.tile_compare_lanes(ct, x0[..., :3], sc, ym, ym)
    with pytest.raises(ValueError):
        tcl.tile_compare_lanes(ct, x0.transpose(1, 2), sc, ym, ym)
    assert tcl.tile_compare_lanes(ct, x0, sc, ym, ym).shape == (n,)
