"""The port's padded chain (the _dyn stages of guetzli_tpu_torch/ops/
diffmap.py, opsin, upsample, image, and the comparator's padded cores and
geometry branches) against the JAX package's padded chain, on the CPU
under JAX_PLATFORMS=cpu (lane_safe off: JAX's window-major block diff):

  * each _dyn stage at three sizes of one bucket (97x63, 111x64, 128x64
    -> 128x64), the port running the three as one stack, each stage fed
    the JAX stage's own inputs, within the stage tolerances of
    tests/test_butteraugli_stages.py;
  * the port's padded chain against its exact chain: opsin exact at the
    valid pixels, the diffmap within rtol 1e-5 / atol 1e-6 with zeros
    outside, the score within 1e-6 relative (tests/test_padded.py's
    tolerances for the JAX package);
  * _cw444_dyn_core and _cw420_dyn_core against JAX's on crops of
    tests/corpus/bees_a.png at the three sizes (4:2:0 by
    CoeffImage.downsample);
  * the padded comparator's block_state, frozen_chroma_blocks,
    frozen_y_16x16, frozen neighborhoods, children_state and
    weights_all_radii against JAX's Comparator(padded=True) on
    tests/corpus/bees_d-420.jpg;
  * a padded quant wave against single padded compares, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import comparator as jcmp
from guetzli_tpu import consts as jconsts
from guetzli_tpu.codec import reader as jreader
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.ops import diffmap as jdm
from guetzli_tpu.ops import image as jimg
from guetzli_tpu.ops import opsin as jopsin
from guetzli_tpu.ops import padgeom as jpg
from guetzli_tpu.ops import upsample as jus
from guetzli_tpu.search import state as jst

from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.ops import diffmap as dm
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import opsin
from guetzli_tpu_torch.ops import padgeom as tpg
from guetzli_tpu_torch.ops import upsample as us
from guetzli_tpu_torch.search import state as st

T = torch.as_tensor
CORPUS = FIXTURES.parent / "corpus"
SIZES = [(97, 63), (111, 64), (128, 64)]
TARGET = jconsts.butteraugli_score_for_quality(95)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _lin(w, h, seed):
    rng = np.random.RandomState(seed)
    lut = jconsts.SRGB_TO_LINEAR.astype(np.float32)
    return lut[rng.randint(0, 256, size=(3, h, w))]


def _jsc(g):
    return {k: (jnp.asarray(a), jnp.asarray(b))
            for k, (a, b) in g.scales().items()}


def _rows(sizes):
    """The port's stacked row state: w, h [B] and the scales."""
    gs = [tpg.PadGeom(w, h) for w, h in sizes]
    assert {(g.wp, g.hp) for g in gs} == {(128, 64)}
    w = T(np.array([g.w for g in gs]))
    h = T(np.array([g.h for g in gs]))
    sc = tpg.split_scales(torch.stack([T(g.scales_flat()) for g in gs]),
                          128, 64)
    return w, h, sc


@pytest.fixture(scope="module")
def jax_stages():
    """Per size, the JAX padded chain's stage outputs (numpy)."""
    out = []
    for i, (w, h) in enumerate(SIZES):
        g = jpg.PadGeom(w, h)
        sc = _jsc(g)
        wd, hd = jnp.int32(w), jnp.int32(h)
        lin0, lin1 = _lin(w, h, 10 + i), _lin(w, h, 20 + i)
        p0 = jnp.asarray(g.pad_plane(lin0))
        p1 = jnp.asarray(g.pad_plane(lin1))
        x0 = jopsin.opsin_dynamics_image_dyn(p0, wd, hd, sc)
        x1 = jopsin.opsin_dynamics_image_dyn(p1, wd, hd, sc)
        m0, m1 = jdm.mask_high_intensity_change_dyn(x0, x1, wd, hd)
        edge = jdm.edge_detector_map_dyn(m0, m1, wd, hd, sc)
        dc, ac = jdm.block_diff_map_dyn(m0, m1, wd, hd)
        ac_lf = jdm.edge_detector_low_freq_dyn(m0, m1, ac, wd, hd, sc)
        pre = jdm.diff_precompute_dyn(m0, m1, wd, hd)
        mk, mk_dc = jdm.mask_dyn(m0, m1, wd, hd, sc)
        res = jdm.combine_channels_dyn(mk, mk_dc, dc, ac_lf, edge, wd, hd,
                                       64, 128)
        dmap = jdm.calculate_diffmap_dyn(res, wd, hd, sc, 64, 128)
        full = jdm.diffmap_opsin_dynamics_dyn(x0, x1, wd, hd, sc)
        out.append({k: np.asarray(v) for k, v in dict(
            p0=p0, p1=p1, x0=x0, x1=x1, m0=m0, m1=m1, edge=edge, dc=dc,
            ac=ac, ac_lf=ac_lf, pre=pre, mask=mk, mask_dc=mk_dc, res=res,
            dmap=dmap, full=full).items()})
    return out


def _stack(stages, key, axis=1):
    return T(np.stack([s[key] for s in stages], axis))


def _valid(got, stages, key, rtol, atol):
    for i, (w, h) in enumerate(SIZES):
        _close(got[:, i, :h, :w], stages[i][key][:, :h, :w], rtol, atol)


def test_opsin_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    for which in ("0", "1"):
        got = opsin.opsin_dynamics_image_dyn(_stack(jax_stages, "p" + which),
                                             w, h, sc)
        _valid(got, jax_stages, "x" + which, 5e-4, 5e-3)


def test_mask_high_intensity_change_dyn(jax_stages):
    w, h, _sc = _rows(SIZES)
    m0, m1 = dm.mask_high_intensity_change_dyn(
        _stack(jax_stages, "x0"), _stack(jax_stages, "x1"), w, h)
    _valid(m0, jax_stages, "m0", 2e-4, 2e-3)
    _valid(m1, jax_stages, "m1", 2e-4, 2e-3)


def test_edge_detector_map_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    got = dm.edge_detector_map_dyn(_stack(jax_stages, "m0"),
                                   _stack(jax_stages, "m1"), w, h, sc)
    assert got.shape == (3, 3, 22, 43)
    _close(got, _stack(jax_stages, "edge"), 5e-4, 5e-4)


def test_block_diff_map_and_low_freq_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    m0, m1 = _stack(jax_stages, "m0"), _stack(jax_stages, "m1")
    dc, ac = dm.block_diff_map_dyn(m0, m1, w, h)
    _close(dc, _stack(jax_stages, "dc"), 1e-3, 1e-3)
    _close(ac, _stack(jax_stages, "ac"), 1e-3, 1e-3)
    got = dm.edge_detector_low_freq_dyn(m0, m1, _stack(jax_stages, "ac"),
                                        w, h, sc)
    _close(got, _stack(jax_stages, "ac_lf"), 1e-3, 1e-3)


def test_mask_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    m0, m1 = _stack(jax_stages, "m0"), _stack(jax_stages, "m1")
    _valid(dm.diff_precompute_dyn(m0, m1, w, h), jax_stages, "pre", 2e-3,
           2e-3)
    mk, mk_dc = dm.mask_dyn(m0, m1, w, h, sc)
    _valid(mk, jax_stages, "mask", 2e-3, 2e-3)
    _valid(mk_dc, jax_stages, "mask_dc", 2e-3, 2e-3)


def test_combine_and_calculate_diffmap_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    res = dm.combine_channels_dyn(
        _stack(jax_stages, "mask"), _stack(jax_stages, "mask_dc"),
        _stack(jax_stages, "dc"), _stack(jax_stages, "ac_lf"),
        _stack(jax_stages, "edge"), w, h, 64, 128)
    _close(res, _stack(jax_stages, "res", 0), 2e-3, 2e-3)
    got = dm.calculate_diffmap_dyn(_stack(jax_stages, "res", 0), w, h, sc,
                                   64, 128)
    _close(got, _stack(jax_stages, "dmap", 0), 2e-3, 2e-3)


def test_full_diffmap_dyn(jax_stages):
    w, h, sc = _rows(SIZES)
    got = dm.diffmap_opsin_dynamics_dyn(_stack(jax_stages, "x0"),
                                        _stack(jax_stages, "x1"), w, h, sc)
    _close(got, _stack(jax_stages, "full", 0), 2e-3, 2e-3)
    for i, (wi, hi) in enumerate(SIZES):
        assert not got[i, hi:].any() and not got[i, :, wi:].any()


@pytest.mark.parametrize("w,h", SIZES + [(91, 57), (100, 33), (65, 65)])
def test_padded_chain_against_exact_chain(w, h):
    """tests/test_padded.py's contract, for the port's two chains."""
    lin0, lin1 = _lin(w, h, w), _lin(w, h, h + 1)
    x0 = opsin.opsin_dynamics_image(T(lin0))
    x1 = opsin.opsin_dynamics_image(T(lin1))
    want = dm.diffmap_opsin_dynamics(x0, x1)
    g = tpg.PadGeom(w, h)
    wt, ht, sc = _rows([(w, h)]) if (g.wp, g.hp) == (128, 64) else (
        T([w]), T([h]),
        tpg.split_scales(T(g.scales_flat())[None], g.wp, g.hp))
    p0 = opsin.opsin_dynamics_image_dyn(T(g.pad_plane(lin0))[:, None], wt,
                                        ht, sc)
    p1 = opsin.opsin_dynamics_image_dyn(T(g.pad_plane(lin1))[:, None], wt,
                                        ht, sc)
    assert torch.equal(p0[:, 0, :h, :w], x0)
    got = dm.diffmap_opsin_dynamics_dyn(p0, p1, wt, ht, sc)[0]
    _close(got[:h, :w], want, 1e-5, 1e-6)
    assert not got[h:].any() and not got[:, w:].any()
    assert float(got.max()) == pytest.approx(float(want.max()), rel=1e-6)


def test_fancy_upsample_and_chroma_dyn():
    """The padded chroma bytes and 4:2:0 sRGB planes equal JAX's bit for
    bit at every pixel, and the exact path's at the valid ones."""
    rng = np.random.RandomState(5)
    ys, us_, vs, ws, hs = [], [], [], [], []
    want = []
    for w, h in SIZES:
        ybw, ybh = -(-w // 8), -(-h // 8)
        cbw, cbh = -(-w // 16), -(-h // 16)
        y = rng.randint(-300, 300, (ybw * ybh, 64)).astype(np.int32)
        u = rng.randint(-300, 300, (cbw * cbh, 64)).astype(np.int32)
        v = rng.randint(-300, 300, (cbw * cbh, 64)).astype(np.int32)
        g = jpg.PadGeom(w, h)
        yp = g.pad_blocks(y, ybw, ybh, 16, 8)
        up, vp = (g.pad_blocks(c, cbw, cbh, 8, 4) for c in (u, v))
        want.append(np.asarray(jimg.coeffs420_to_srgb_dyn(
            jnp.asarray(yp), jnp.asarray(up), jnp.asarray(vp), 16, 8, 8, 4,
            128, 64, jnp.int32(w), jnp.int32(h))))
        exact = img_ops.coeffs420_to_srgb(T(y), T(u), T(v), ybw, ybh, cbw,
                                          cbh, w, h)
        got = img_ops.coeffs420_to_srgb_dyn(
            T(yp)[None], T(up)[None], T(vp)[None], 16, 8, 8, 4, 128, 64,
            T([w]), T([h]))[:, 0]
        assert torch.equal(got[:, :h, :w], exact)
        ys.append(yp)
        us_.append(up)
        vs.append(vp)
        ws.append(w)
        hs.append(h)
        sub = np.asarray(jimg.blocks_to_plane(
            jimg.idct_blocks(jnp.asarray(up)) << 4, 8, 4, 64, 32))
        np.testing.assert_array_equal(
            us.fancy_upsample_dyn(T(sub.copy())[None], T([(w + 1) // 2]),
                                  T([(h + 1) // 2]))[0].numpy(),
            np.asarray(jus.fancy_upsample_dyn(jnp.asarray(sub),
                                              jnp.int32((w + 1) // 2),
                                              jnp.int32((h + 1) // 2))))
    got = img_ops.coeffs420_to_srgb_dyn(
        T(np.stack(ys)), T(np.stack(us_)), T(np.stack(vs)), 16, 8, 8, 4, 128,
        64, T(ws), T(hs))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def _crop_state(w, h):
    """A crop of bees_a.png and its starting coefficient image, for both
    packages (the port's and JAX's encoders give the same coefficients)."""
    rgb, _w, _h = jread_png((CORPUS / "bees_a.png").read_bytes())
    rgb = np.ascontiguousarray(rgb[:h, :w])
    pjpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(pjpg)
    jjpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jjpg)
    return rgb, st.CoeffImage.from_jpeg(pjpg), jst.CoeffImage.from_jpeg(jjpg)


@pytest.mark.parametrize("kind", ["444", "420"])
def test_padded_cores_against_jax(kind):
    """_cw444_dyn_core / _cw420_dyn_core of three images stacked, against
    JAX's core of each (score and diffmap at the diffmap tolerance; the
    weights, comparisons on the diffmap, equal), with direction -1 and
    the 4:2:0 pass's factor 2 for "420"."""
    comps, imgs, want = [], [], []
    fx = 1 if kind == "444" else 2
    for w, h in SIZES:
        rgb, pimg, jimg_ = _crop_state(w, h)
        if kind == "420":
            pimg.downsample()
            jimg_.downsample()
        jc = JComparator(rgb, w, h, TARGET, padded=True)
        g = jc.geom
        sx = 8 * fx
        kw = dict(wp=g.wp, hp=g.hp, sizex=sx, sizey=sx, gbwp=g.wp // sx,
                  gbhp=g.hp // sx, direction_pos=fx == 1)
        tgt = jnp.float32(TARGET)
        if kind == "444":
            s, d, w4 = jcmp._cw444_dyn_core(
                jnp.asarray(g.pad_blocks(jimg_.coeffs, jimg_.bw, jimg_.bh)),
                jc.xyb0, tgt, *jc._wh, jc._sc, bwp=g.bwp, bhp=g.bhp, **kw)
        else:
            yy, uu, vv = jimg_.comps
            s, d, w4 = jcmp._cw420_dyn_core(
                jnp.asarray(g.pad_blocks(yy.coeffs, yy.bw, yy.bh)),
                jnp.asarray(g.pad_blocks(uu.coeffs, uu.bw, uu.bh, 8, 4)),
                jnp.asarray(g.pad_blocks(vv.coeffs, vv.bw, vv.bh, 8, 4)),
                jc.xyb0, tgt, *jc._wh, jc._sc, ybwp=g.bwp, ybhp=g.bhp,
                cbwp=8, cbhp=4, **kw)
        want.append((float(s), np.asarray(d), np.asarray(w4)))
        comps.append(cmp_mod.Comparator(rgb, w, h, TARGET, "cpu",
                                        padded=True))
        imgs.append(pimg)
    b = cmp_mod.CompareBatcher()
    for c in comps:
        c.batcher = b
    hs = [c.dispatch_compare_with_weights(m, 1 if fx == 1 else -1, 1.0, fx,
                                          fx)
          for c, m in zip(comps, imgs)]
    got = cmp_mod.fetch_compare_many(comps, hs)
    assert (b.flushes, b.rows) == (1, 3)
    for (w, h), c, (gd, gw4), (wd, wdm, ww4) in zip(SIZES, comps, got, want):
        assert abs(gd - wd) < 2e-3 * max(1.0, wd)
        _close(c.distmap, wdm, 2e-3, 2e-3)
        gbw, gbh = -(-w // (8 * fx)), -(-h // (8 * fx))
        np.testing.assert_array_equal(
            gw4, jpg.PadGeom(w, h).unpad_grid(ww4, gbw, gbh, 128 // (8 * fx),
                                              64 // (8 * fx)))


@pytest.fixture(scope="module")
def state420p():
    """bees_d-420.jpg (97x63, bucket 128x64) as the encoder starts from
    it, with JAX's padded Comparator and the port's."""
    from guetzli_tpu.search.processor import decode_jpeg_to_rgb
    data = (CORPUS / "bees_d-420.jpg").read_bytes()
    jjpg = jreader.read_jpeg(data)
    rgb = decode_jpeg_to_rgb(jjpg)
    w, h = jjpg.width, jjpg.height
    jcomp = JComparator(rgb, w, h, TARGET, padded=True)
    jst.remove_original_quantization(jjpg)
    pjpg = reader.read_jpeg(data)
    st.remove_original_quantization(pjpg)
    comp = cmp_mod.Comparator(rgb, w, h, TARGET, "cpu", padded=True)
    return (jcomp, jst.CoeffImage.from_jpeg(jjpg), comp,
            st.CoeffImage.from_jpeg(pjpg))


def test_padded_original_and_block_state(state420p):
    jcomp, _jimg, comp, _pimg = state420p
    assert comp.xyb0.shape == (3, 64, 128)
    _close(comp.xyb0[:, :63, :97], np.asarray(jcomp.xyb0)[:, :63, :97],
           5e-4, 5e-3)
    jcomp.start_block_comparisons()
    comp.start_block_comparisons()
    got, want = comp.block_state(1, 1), jcomp.block_state(1, 1)
    assert got[0].shape == (16 * 8, 3, 64)
    _close(got[0], want[0], 5e-4, 5e-3)
    _close(got[1], want[1], 2e-3, 2e-3)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_padded_frozen_420_state(state420p):
    """frozen_chroma_blocks, frozen_y_16x16, the neighborhoods and
    children_state on the bucket grids: the integer arrays bit for bit,
    the children's float state at the stage tolerance."""
    from guetzli_tpu.search.processor import Params as JParams
    from guetzli_tpu.search.processor import Processor as JProcessor
    from guetzli_tpu.search.processor import ProcessStats as JProcessStats
    jcomp, jimg_, comp, pimg = state420p
    jcomp.start_block_comparisons()
    comp.start_block_comparisons()
    cbw, cbh = pimg.comps[2].bw, pimg.comps[2].bh
    cb = comp.frozen_chroma_blocks(pimg)
    assert cb.shape == (128, 2, 8, 8)
    np.testing.assert_array_equal(
        cb.numpy(), np.asarray(jcomp.frozen_chroma_blocks(jimg_)))
    y16 = comp.frozen_y_16x16(pimg, cbw, cbh)
    assert y16.shape == (32, 16, 16)
    np.testing.assert_array_equal(
        y16.numpy(), np.asarray(jcomp.frozen_y_16x16(jimg_, cbw, cbh)))
    _mode, jaux = JProcessor(JParams(), jcomp, JProcessStats()).masking_aux(
        jimg_, 6, jimg_.comps[2])
    for g, w in zip(comp.frozen_neighborhoods(pimg), jaux[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    children = comp.children_state(cbw, cbh)
    for i, (g, w) in enumerate(zip(children, jaux[3:])):
        if i < 2:
            _close(g, w, 2e-3, 5e-3)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("direction,factor", [(1, 1), (-1, 1), (-1, 2)])
def test_padded_weights_all_radii(state420p, direction, factor):
    """weights_all_radii of one padded distmap, port and JAX: equal."""
    jcomp, _jimg, comp, _pimg = state420p
    rng = np.random.RandomState(direction + 3 * factor)
    d = np.zeros((64, 128), np.float32)
    d[:63, :97] = rng.rand(63, 97).astype(np.float32) * 1.4
    jcomp.distmap = jnp.asarray(d)
    comp.distmap = T(d)
    got = comp.weights_all_radii(direction, 1.0, factor, factor)
    want = jcomp.weights_all_radii(direction, 1.0, factor, factor)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["bees_d.png", "bees_d-420.jpg"])
def test_padded_wave_equals_single_compares(name):
    """A padded quant wave of 3 matrices against 3 single padded compares
    of the host-requantized images, bit for bit."""
    from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb
    data = (CORPUS / name).read_bytes()
    if name.endswith(".jpg"):
        jpg = reader.read_jpeg(data)
        rgb = decode_jpeg_to_rgb(jpg)
    else:
        from guetzli_tpu_torch.io.png import read_png
        rgb, w, h = read_png(data)
        jpg = encode_rgb_to_jpeg(rgb, w, h)
    comp = cmp_mod.Comparator(rgb, jpg.width, jpg.height, TARGET, "cpu",
                              padded=True)
    q_in = st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    qs = [np.maximum(q_in + k, 1).astype(np.int32) for k in (0, 3, 9)]
    scores = comp.fetch_quant_scores(comp.dispatch_quant_batch(
        comp.quant_base_upload(img), qs))
    for q, s in zip(qs, scores):
        t = img.copy()
        t.apply_global_quantization(q)
        assert comp.compare_img(t) == s
