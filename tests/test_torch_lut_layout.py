"""GUETZLI_TPU_EXACT_LUT, GUETZLI_TPU_LANE_SAFE and GUETZLI_TPU_SEL_MATMUL
in the port against the JAX package under the same variable.

JAX reads these variables while it traces, and a jit cache does not key
on the environment, so every JAX reference under a knob here runs op by
op (jax.disable_jit) with the variable set by monkeypatch: a jitted trace
with a knob set would poison later tests of the same worker.

  * EXACT_LUT: the table reads (colour differences, masking, sRGB) equal
    JAX's bit for bit over a seeded sweep with negatives, the clamp
    edges and values past the last entry, and differ from the closed
    forms; the plain compares A and A' (the kernels' plain versions)
    within rtol 1e-5 of JAX's op-by-op compares (test_torch_tiles_lanes
    .py's bar), A'' within XLA's FMA band of JAX jitted (op by op: a slow
    test), with kernel C's plain version unmoved; one padded diffmap
    within the padded chain's stage tolerance (tests/test_torch_padded
    _compare.py) of JAX jitted. The jitted references run in a fresh
    process with the variable set.
  * SEL_MATMUL: the one-hot selection equals the gather bit for bit.
  * LANE_SAFE: the one-hot upsample equals the repeat bit for bit; the
    lane-major block_diff_map_dyn against JAX's with LANE_SAFE=1 within
    rtol 1e-5, and it is another rounding than the window-major form.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import consts as jconsts
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.ops import blockdiff as jbd
from guetzli_tpu.ops import diffmap as jdm
from guetzli_tpu.ops import image as jimg
from guetzli_tpu.ops import padgeom as jpg
from guetzli_tpu.ops import tiles_lanes as jtl
from guetzli_tpu.search import state as jst
from guetzli_tpu.search.processor import Params as JParams
from guetzli_tpu.search.processor import Processor as JProcessor
from guetzli_tpu.search.processor import ProcessStats as JProcessStats

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.kernels import tile_compare_lanes as tcl
from guetzli_tpu_torch.ops import blockdiff as bd
from guetzli_tpu_torch.ops import blur as tblur
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import padgeom as tpg
from guetzli_tpu_torch.ops import tiles_lanes as tl

T = torch.as_tensor
REPO = FIXTURES.parent.parent
RTOL = 1e-5
EXACT = "GUETZLI_TPU_EXACT_LUT"


def _sweep(top, seed=13, n=4000):
    """Seeded inputs: uniform over [-top, top], every integer and
    half-integer up to past the end, the clamp edges, huge values, -0."""
    rng = np.random.default_rng(seed)
    edges = np.arange(-2.0 * top, 2.0 * top + 0.5, 0.5)
    special = [0.0, -0.0, 1e-7, top - 1e-4, top + 1e-4, 1e6, -1e6, 1e30,
               -1e30, np.inf, -np.inf]
    return np.concatenate([rng.uniform(-top, top, n), edges,
                           special]).astype(np.float32)


def _jax(fn, *args):
    """fn(*args) in JAX op by op, as numpy."""
    with jax.disable_jit():
        return np.asarray(fn(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("name", ["color_diff_dy_hf", "color_diff_dx_hf",
                                  "color_diff_dy_lf"])
def test_colour_diff_tables_equal_jax(name, monkeypatch):
    monkeypatch.setenv(EXACT, "1")
    s = _sweep(21.0)
    want = _jax(getattr(jbd, name), s)
    got = getattr(bd, name)(T(s)).numpy()
    np.testing.assert_array_equal(got, want)
    closed = getattr(bd, name)(T(s), exact_lut=False).numpy()
    assert 0.1 < np.mean(closed != got) < 0.6


@pytest.mark.parametrize("key", sorted(consts.MASK_LUT_PARAMS))
def test_mask_tables_equal_jax(key, monkeypatch):
    monkeypatch.setenv(EXACT, "1")
    s = _sweep(520.0)
    want = _jax(lambda x: jbd.mask_lut(key, x), s)
    got = bd.mask_lut(key, T(s)).numpy()
    np.testing.assert_array_equal(got, want)
    closed = bd.mask_lut(key, T(s), exact_lut=False).numpy()
    assert np.mean(closed != got) > 0.05


def test_srgb_table_equals_jax(monkeypatch):
    """The 256 byte values read from the table under the knob, equal to
    JAX's; image.srgb_table (the kernels' table) keeps the closed form."""
    v = np.arange(256, dtype=np.int32).reshape(16, 16)
    closed = img_ops.srgb_to_linear(T(v)).numpy()
    monkeypatch.setenv(EXACT, "1")
    want = _jax(jimg.srgb_to_linear, v)
    got = img_ops.srgb_to_linear(T(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, consts.SRGB_TO_LINEAR.astype(np.float32).reshape(16, 16))
    assert int((got != closed).sum()) > 100
    np.testing.assert_array_equal(img_ops.srgb_table("cpu").numpy(),
                                  closed.reshape(-1))


@pytest.mark.slow
def test_block_diff_lanes_exact_lut_vs_jax(monkeypatch):
    """The lane-major block diff with the knob against JAX's op by op
    (~8 s; tier 1 holds it through the compares A and A' below)."""
    rng = np.random.default_rng(5)
    # Wide enough that the HF DY reads pass |s| = 1, below which the
    # table's first segment and the closed form agree bit for bit.
    b0 = rng.normal(0, 30.0, (3, 8, 8, 64)).astype(np.float32)
    b1 = (b0 + rng.normal(0, 10.0, b0.shape)).astype(np.float32)
    closed = tl.block_diff_lanes(T(b0), T(b1))
    monkeypatch.setenv(EXACT, "1")
    with jax.disable_jit():
        want = jtl.block_diff_lanes(jnp.asarray(b0), jnp.asarray(b1),
                                    dot=False)
    got = tl.block_diff_lanes(T(b0), T(b1))
    for g, w, c in zip(got, want, closed):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-9)
    assert not all(torch.equal(g, c) for g, c in zip(got, closed))


# -- the plain compares A, A', A'' and C under EXACT_LUT ---------------------

@pytest.fixture
def jax_srgb(monkeypatch):
    """The port's lane compares read JAX's 256 closed-form sRGB values
    (XLA's and PyTorch's pow differ by an ulp at 6 of them,
    test_torch_tiles_lanes.py)."""
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: T(lut).to(device))


@pytest.fixture(scope="module")
def states():
    """mode -> (candidates [N, 3, 64], JAX's blocks-leading state, as
    numpy): bees96x64's 4:4:4 blocks, and bees97x63 forced to 4:2:0 (Y
    pass and chroma pass), each block with one AC coefficient zeroed;
    the first 12 blocks or macroblocks."""
    out = {}
    rgb, w, h = jread_png((FIXTURES / "bees96x64.png").read_bytes())
    comp = JComparator(rgb, w, h, 1.0, padded=False)
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    img = jst.CoeffImage.from_jpeg(jpg)
    comp.start_block_comparisons()
    aux = tuple(np.asarray(a)[:12] for a in comp.block_state(1, 1))
    out["444"] = (np.ascontiguousarray(img.coeffs.transpose(1, 0, 2))[:12],
                  aux)
    rgb, w, h = jread_png((FIXTURES / "bees97x63.png").read_bytes())
    comp = JComparator(rgb, w, h, 1.0, padded=False)
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    img = jst.CoeffImage.from_jpeg(jpg)
    img.downsample()
    proc = JProcessor(JParams(), comp, JProcessStats())
    for mode, mask in (("420y", 1), ("420c", 6)):
        grid = img.comps[mask.bit_length() - 1]
        _jmode, aux = proc.masking_aux(img, mask, grid)
        blocks = np.zeros((grid.bw * grid.bh, 3, 64), np.int32)
        for c in range(3):
            if (mask >> c) & 1:
                blocks[:, c] = img.comps[c].coeffs
        out[mode] = (blocks[:12], tuple(np.asarray(a)[:12] for a in aux))
    for mode, (blocks, aux) in out.items():
        flat = blocks.reshape(len(blocks), -1)
        for b in range(len(flat)):
            nz = [k for k in np.flatnonzero(flat[b]) if k % 64]
            if nz:
                flat[b, nz[-1]] = 0
    return out


def _jax_compare(mode, cand, aux):
    cand = jnp.asarray(cand)
    aux = tuple(jnp.asarray(a) for a in aux)
    if mode == "444":
        return jtl.compare_blocks_lanes444(cand, *jtl.transpose_aux_444(*aux))
    if mode == "420y":
        return jtl.compare_blocks_lanes420y(cand[:, 0],
                                            *jtl.transpose_aux_420y(*aux))
    return jtl.compare_blocks_lanes420c(cand[:, 1], cand[:, 2],
                                        *jtl.transpose_aux_420c(*aux))


def _port_compare(mode, cand, aux, **kw):
    """Kernel A, A' or A'' through its wrapper on CPU tensors (its plain
    version)."""
    ct = T(cand).reshape(-1, 3, 8, 8).permute(1, 2, 3, 0).contiguous()
    lanes = tl.LANE_AUX[mode](*(T(np.array(a)) for a in aux))
    return tcl.tile_compare_lanes(ct, *lanes, mode=mode, **kw).numpy()


@pytest.mark.parametrize("mode", [
    "444", "420y", pytest.param("420c", marks=pytest.mark.slow)])
def test_plain_compares_exact_lut_vs_jax(states, jax_srgb, mode,
                                         monkeypatch):
    """A, A', A'' (plain) with the knob against JAX's lane compares run op
    by op with the knob; another function than the closed forms'. (A''
    op by op takes ~16 s: slow; tier 1 holds it to jitted JAX below.)"""
    cand, aux = states[mode]
    closed = _port_compare(mode, cand, aux)
    monkeypatch.setenv(EXACT, "1")
    with jax.disable_jit():
        want = np.asarray(_jax_compare(mode, cand, aux))
    got = _port_compare(mode, cand, aux)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(
        got, _port_compare(mode, cand, aux, exact_lut=True))
    assert not np.array_equal(got, closed)


def test_kernel_c_plain_ignores_exact_lut(states, monkeypatch):
    """Kernel C's plain version keeps its closed forms under the knob (the
    JAX kernel has its own, kernels/tile_compare.py:120-135)."""
    cand, aux = states["444"]
    x0, sc, ysel, xsel = (T(np.array(a)) for a in aux)
    sy, sx = kc.selection_matrices(ysel, xsel)
    args = (T(cand), x0, sc, sy, sx)
    before = kc.tile_compare(*args)
    monkeypatch.setenv(EXACT, "1")
    assert torch.equal(kc.tile_compare(*args), before)
    ct = T(cand).reshape(-1, 3, 8, 8).permute(1, 2, 3, 0)
    lanes = tl.transpose_aux_444(x0, sc, ysel, xsel)
    assert torch.equal(before, tl.compare_lanes(ct, *lanes, exact_lut=False))
    assert not torch.equal(before, tl.compare_lanes(ct, *lanes))


# -- the padded chain ----------------------------------------------------------

W, H = 57, 41


def _padded_planes(seed):
    """Two opsin-like [3, Hp, Wp] planes of a W x H image on its bucket
    (garbage outside it), the port's row state and JAX's."""
    g = jpg.PadGeom(W, H)
    rng = np.random.RandomState(seed)
    lut = jconsts.SRGB_TO_LINEAR.astype(np.float32)
    planes = []
    for k in range(2):
        lin = lut[rng.randint(0, 256, size=(3, H, W))] / 255.0
        planes.append(np.asarray(g.pad_plane(lin), np.float32))
    tg = tpg.PadGeom(W, H)
    assert (tg.wp, tg.hp) == (g.wp, g.hp)
    sc = tpg.split_scales(T(tg.scales_flat())[None], tg.wp, tg.hp)
    jsc = {k: (jnp.asarray(a), jnp.asarray(b))
           for k, (a, b) in g.scales().items()}
    return planes, sc, jsc


def _port_diffmap(p0, p1, sc):
    return dm.diffmap_opsin_dynamics_dyn(T(p0)[:, None], T(p1)[:, None],
                                         T([W]), T([H]), sc)[0]


@pytest.mark.slow
def test_diffmap_dyn_exact_lut_vs_jax_op_by_op(monkeypatch):
    """One padded diffmap with the knob against JAX's op by op with it
    (~30 s), within the padded chain's stage tolerance."""
    (p0, p1), sc, jsc = _padded_planes(3)
    monkeypatch.setenv(EXACT, "1")
    with jax.disable_jit():
        want = np.asarray(jdm.diffmap_opsin_dynamics_dyn(
            jnp.asarray(p0), jnp.asarray(p1), jnp.int32(W), jnp.int32(H),
            jsc))
    got = _port_diffmap(p0, p1, sc)
    np.testing.assert_allclose(got[:H, :W].numpy(), want[:H, :W],
                               rtol=2e-3, atol=2e-3)


_JITTED = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from guetzli_tpu.ops import diffmap as jdm
from guetzli_tpu.ops import padgeom as jpg
from guetzli_tpu.ops import tiles_lanes as jtl
d = np.load(sys.argv[1])
w, h = int(d["w"]), int(d["h"])
g = jpg.PadGeom(w, h)
sc = {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in g.scales().items()}
dmap = jax.jit(lambda a, b: jdm.diffmap_opsin_dynamics_dyn(
    a, b, jnp.int32(w), jnp.int32(h), sc))(d["p0"], d["p1"])
aux = [d["aux%d" % i] for i in range(int(d["naux"]))]
cand = jnp.asarray(d["cand"])
c420 = jax.jit(lambda c, *a: jtl.compare_blocks_lanes420c(
    c[:, 1], c[:, 2], *jtl.transpose_aux_420c(*a)))(cand, *aux)
np.savez(sys.argv[2], dmap=np.asarray(dmap), c420c=np.asarray(c420))
"""


@pytest.fixture(scope="module")
def jitted_exact(states, tmp_path_factory):
    """JAX's padded diffmap and chroma-pass compare A'' jitted in a fresh
    process with GUETZLI_TPU_EXACT_LUT=1 (a jitted trace in this worker
    would keep the knob's branch for later tests)."""
    d = tmp_path_factory.mktemp("jitted_exact")
    (p0, p1), _sc, _jsc = _padded_planes(3)
    cand, aux = states["420c"]
    np.savez(d / "in.npz", w=W, h=H, p0=p0, p1=p1, cand=cand,
             naux=len(aux), **{"aux%d" % i: a for i, a in enumerate(aux)})
    env = dict(os.environ, GUETZLI_TPU_EXACT_LUT="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JITTED, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def test_diffmap_dyn_exact_lut_vs_jax(jitted_exact, monkeypatch):
    """One padded diffmap with the knob against JAX's with it (jitted),
    within the padded chain's stage tolerance; the knob moves it."""
    (p0, p1), sc, _jsc = _padded_planes(3)
    closed = _port_diffmap(p0, p1, sc)
    monkeypatch.setenv(EXACT, "1")
    got = _port_diffmap(p0, p1, sc)
    np.testing.assert_allclose(got[:H, :W].numpy(),
                               jitted_exact["dmap"][:H, :W], rtol=2e-3,
                               atol=2e-3)
    assert not torch.equal(got, closed)


def test_chroma_compare_exact_lut_vs_jax_jitted(states, jax_srgb,
                                                jitted_exact, monkeypatch):
    """A'' (plain) with the knob against JAX's jitted chroma-pass compare
    with it, within XLA's FMA band (test_torch_zeroing420.py)."""
    cand, aux = states["420c"]
    monkeypatch.setenv(EXACT, "1")
    np.testing.assert_allclose(_port_compare("420c", cand, aux),
                               jitted_exact["c420c"], rtol=2e-3, atol=0)


def _sel_inputs(seed):
    rng = np.random.default_rng(seed)
    img = T(rng.normal(size=(6, 2, 40, 56)).astype(np.float32))
    ty = T(rng.integers(0, 40, size=(2, 24)))
    tx = T(rng.integers(0, 56, size=(2, 32)))
    return img, ty, tx


def test_select_forms_equal(monkeypatch):
    img, ty, tx = _sel_inputs(7)
    gather = dm._select_yx(img, ty, tx)
    monkeypatch.setenv("GUETZLI_TPU_SEL_MATMUL", "1")
    assert torch.equal(dm._select_yx(img, ty, tx), gather)
    assert gather.shape == (6, 2, 24, 32)


@pytest.mark.parametrize("sigma", [7.2, 8.85, 12.5])
def test_upsample_forms_equal(sigma, monkeypatch):
    """The strided blurs (steps 2, 2 and 4: sigma 7.2, the diffmap's 8.85,
    12.5) with the repeat and with the one-hot column pass."""
    rng = np.random.default_rng(9)
    x = T(rng.normal(size=(2, 37, 53)).astype(np.float32))
    want = tblur.blur(x, sigma, 0.0)
    monkeypatch.setenv("GUETZLI_TPU_LANE_SAFE", "1")
    got = tblur.blur(x, sigma, 0.0)
    assert torch.equal(got, want)
    u = T(tblur._upsample_matrix(5, 13, 3))
    assert torch.equal(u.sum(0), torch.ones(13))


def test_block_diff_map_dyn_lane_major_vs_jax(monkeypatch):
    """block_diff_map_dyn by the lane-major form (LANE_SAFE=1) against
    JAX's with LANE_SAFE=1, op by op; another rounding than the port's
    window-major form, within the stage tolerance of it."""
    (p0, p1), _sc, _jsc = _padded_planes(4)
    w, h = T([W]), T([H])
    win = dm.block_diff_map_dyn(T(p0)[:, None], T(p1)[:, None], w, h)
    monkeypatch.setenv("GUETZLI_TPU_LANE_SAFE", "1")
    with jax.disable_jit():
        want = jdm.block_diff_map_dyn(jnp.asarray(p0), jnp.asarray(p1),
                                      jnp.int32(W), jnp.int32(H))
    got = dm.block_diff_map_dyn(T(p0)[:, None], T(p1)[:, None], w, h)
    for g, wn, wj in zip(got, win, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(wj),
                                   rtol=RTOL, atol=1e-9)
        np.testing.assert_allclose(g.numpy(), wn.numpy(), rtol=1e-3,
                                   atol=1e-3)
    assert not all(torch.equal(g, wn) for g, wn in zip(got, win))
