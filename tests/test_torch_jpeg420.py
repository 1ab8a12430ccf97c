"""guetzli_tpu_torch JPEG input and the 4:2:0 state vs the JAX package, on
the CPU.

Integer stages are bit-exact: the JPEG reader (both scan decoders), the
full decode of "unsupported" JPEGs, the chroma upsampling, the 4:2:0
pixel path, CoeffImage.downsample and the frozen 4:2:0 zeroing state. The
4:2:0 whole-image score and the [4, NB] block weights are float stages,
held to the JAX package at the diffmap stage tolerance of
tests/test_butteraugli_stages.py (2e-3; the weights are 0/1 and 1/(d+1)
values of comparisons on the diffmap, exact where the diffmaps agree on
the comparisons).
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import consts as jconsts
from guetzli_tpu import native as jnative
from guetzli_tpu.codec import full_decode as jfull
from guetzli_tpu.codec import reader as jreader
from guetzli_tpu.codec import writer as jwriter
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.ops import image as jimg
from guetzli_tpu.ops import upsample as jus
from guetzli_tpu.search import state as jst
from guetzli_tpu.search.processor import Params as JParams
from guetzli_tpu.search.processor import Processor as JProcessor
from guetzli_tpu.search.processor import ProcessStats as JProcessStats

from guetzli_tpu_torch import interop, native
from guetzli_tpu_torch.codec import full_decode, reader
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import upsample as us
from guetzli_tpu_torch.search import state as st

T = torch.as_tensor
CORPUS = FIXTURES.parent / "corpus"


@pytest.fixture(scope="module")
def rgb96x64():
    rgb, _w, _h = jread_png((FIXTURES / "bees96x64.png").read_bytes())
    return rgb


def _pil_jpeg(rgb, mode=None, **kw):
    from PIL import Image
    im = Image.fromarray(rgb)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _jpeg_case(rgb, case):
    if case == "444":
        return _pil_jpeg(rgb, quality=90, subsampling=0)
    if case == "420":
        return _pil_jpeg(rgb, quality=90, subsampling=2)
    if case == "444_progressive":
        return _pil_jpeg(rgb, quality=90, subsampling=0, progressive=True)
    if case == "420_progressive_odd":
        return _pil_jpeg(np.ascontiguousarray(rgb[:23, :17]), quality=90,
                         subsampling=2, progressive=True)
    if case == "restart_markers":
        return _pil_jpeg(rgb, quality=90, subsampling=0,
                         restart_marker_rows=2)
    if case == "dqt16":
        q = np.full((3, 64), 300, dtype=np.int32)
        q[:, 0] = 1000
        return jwriter.write_jpeg(jencode(rgb, 96, 64, quant=q))
    return (CORPUS / case).read_bytes()


def _assert_jpg_equal(got, want):
    assert (got.width, got.height) == (want.width, want.height)
    assert (got.max_h_samp_factor, got.max_v_samp_factor) == \
        (want.max_h_samp_factor, want.max_v_samp_factor)
    assert got.restart_interval == want.restart_interval
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert (g.id, g.h_samp_factor, g.v_samp_factor, g.quant_idx,
                g.width_in_blocks, g.height_in_blocks) == \
            (w.id, w.h_samp_factor, w.v_samp_factor, w.quant_idx,
             w.width_in_blocks, w.height_in_blocks)
        np.testing.assert_array_equal(g.coeffs, w.coeffs)
    assert len(got.quant) == len(want.quant)
    for g, w in zip(got.quant, want.quant):
        np.testing.assert_array_equal(g.values, w.values)
        assert g.precision == w.precision


@pytest.mark.parametrize("case", [
    "444", "420", "444_progressive", "420_progressive_odd",
    "restart_markers", "dqt16", "bees_d-420.jpg",
    "bees_d-progressive.jpg"])
def test_read_jpeg_matches_jax(rgb96x64, case, monkeypatch):
    """Components, coefficients and quant tables equal the JAX reader's,
    through the native scan decoder and through the Python one."""
    data = _jpeg_case(rgb96x64, case)
    want = jreader.read_jpeg(data)
    assert jnative.get_lib() is not None and native.get_lib() is not None
    _assert_jpg_equal(reader.read_jpeg(data), want)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _assert_jpg_equal(reader.read_jpeg(data), want)
    assert reader.check_jpeg_sanity(want) == jreader.check_jpeg_sanity(want)
    assert reader.peek_dimensions(data) == jreader.peek_dimensions(data)
    assert reader.has_ycbcr_colorspace(want) == \
        jreader.has_ycbcr_colorspace(want)


def test_read_jpeg_rejects_garbage():
    with pytest.raises(reader.JpegError):
        reader.read_jpeg(b"not a jpeg")
    with pytest.raises(reader.JpegError):
        reader.read_jpeg(b"\xff\xd8\xff\xc0\x00\x05trunc")


@pytest.mark.parametrize("mode,kw", [
    ("L", {}), (None, {"subsampling": 1}), ("CMYK", {})],
    ids=["gray", "422", "cmyk"])
def test_decode_any_to_rgb_matches_jax(rgb96x64, mode, kw):
    data = _pil_jpeg(np.ascontiguousarray(rgb96x64[:61, :45]), mode,
                     quality=88, **kw)
    jpg = reader.read_jpeg(data)
    got, w, h = full_decode.decode_any_to_rgb(jpg)
    want, jw, jh = jfull.decode_any_to_rgb(jreader.read_jpeg(data))
    assert (w, h) == (jw, jh) == (45, 61)
    np.testing.assert_array_equal(got, want)


# -- integer 4:2:0 pixel stages ---------------------------------------------

def test_fancy_upsample_bit_exact():
    rng = np.random.default_rng(21)
    for w, h in ((32, 24), (31, 17), (97, 63)):
        sub = rng.integers(0, 256 * 16, ((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.int32)
        want = np.asarray(jus.fancy_upsample(jnp.asarray(sub), w, h))
        np.testing.assert_array_equal(
            us.fancy_upsample(T(sub), w, h).numpy(), want)


def test_neighborhoods_and_upsample16_bit_exact():
    rng = np.random.default_rng(22)
    sub = rng.integers(0, 256 * 16, (29, 37)).astype(np.int32)
    bw, bh = 5, 4
    want = np.asarray(jus.neighborhoods_10x10(jnp.asarray(sub), bw, bh))
    got = us.neighborhoods_10x10(T(sub), bw, bh)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        us.upsample_16x16_from_neighborhood(got).numpy(),
        np.asarray(jus.upsample_16x16_from_neighborhood(jnp.asarray(want))))


@pytest.mark.parametrize("w,h", [(96, 64), (97, 63)])
def test_coeffs420_to_srgb_bit_exact(w, h):
    rng = np.random.default_rng(23)
    ybw, ybh = (w + 7) // 8, (h + 7) // 8
    cbw, cbh = (w + 15) // 16, (h + 15) // 16
    y = rng.integers(-300, 300, (ybw * ybh, 64)).astype(np.int32)
    u = rng.integers(-300, 300, (cbw * cbh, 64)).astype(np.int32)
    v = rng.integers(-300, 300, (cbw * cbh, 64)).astype(np.int32)
    want = np.asarray(jimg.coeffs420_to_srgb(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), ybw, ybh, cbw, cbh,
        w, h))
    got = img_ops.coeffs420_to_srgb(T(y), T(u), T(v), ybw, ybh, cbw, cbh,
                                    w, h)
    np.testing.assert_array_equal(got.numpy(), want)


def _images(rgb, w, h):
    """The JAX and port CoeffImages of the default JPEG of rgb."""
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    pjpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(pjpg)
    return jst.CoeffImage.from_jpeg(jpg), st.CoeffImage.from_jpeg(pjpg)


@pytest.mark.parametrize("silver", [False, True], ids=["normal",
                                                      "silver_screen"])
def test_downsample_bit_exact(silver):
    """CoeffImage.downsample (output_image.cc:535-571), both branches, on
    a 40x24 crop (the silver-screen branch's 20 refinement rounds dominate
    the cost)."""
    rgb, _w, _h = jread_png((FIXTURES / "bees96x64.png").read_bytes())
    w, h = 40, 24
    jimg_, pimg = _images(np.ascontiguousarray(rgb[:h, :w]), w, h)
    jimg_.downsample(use_silver_screen=silver)
    pimg.downsample(use_silver_screen=silver)
    for g, want in zip(pimg.comps, jimg_.comps):
        assert (g.factor_x, g.factor_y, g.bw, g.bh) == \
            (want.factor_x, want.factor_y, want.bw, want.bh)
        np.testing.assert_array_equal(g.coeffs, want.coeffs)


# -- the frozen 4:2:0 state and the whole-image 4:2:0 compare ---------------

@pytest.fixture(scope="module")
def state420():
    """bees_d-420.jpg (97x63: edge macroblocks with invalid children) as
    the encoder starts from it, with an unpadded JAX Comparator and the
    port's own Comparator."""
    data = (CORPUS / "bees_d-420.jpg").read_bytes()
    jjpg = jreader.read_jpeg(data)
    from guetzli_tpu.search.processor import decode_jpeg_to_rgb
    rgb = decode_jpeg_to_rgb(jjpg)
    w, h = jjpg.width, jjpg.height
    target = jconsts.butteraugli_score_for_quality(95)
    jcomp = JComparator(rgb, w, h, target, padded=False)
    jst.remove_original_quantization(jjpg)
    jimg_ = jst.CoeffImage.from_jpeg(jjpg)
    pjpg = reader.read_jpeg(data)
    st.remove_original_quantization(pjpg)
    pimg = st.CoeffImage.from_jpeg(pjpg)
    comp = Comparator(rgb, w, h, target, "cpu")
    return rgb, w, h, target, jcomp, jimg_, comp, pimg


def test_decode_jpeg_to_rgb_matches_jax(state420):
    from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb
    rgb = state420[0]
    data = (CORPUS / "bees_d-420.jpg").read_bytes()
    np.testing.assert_array_equal(decode_jpeg_to_rgb(reader.read_jpeg(data)),
                                  rgb)
    data = (CORPUS / "bees_d.jpg").read_bytes()
    from guetzli_tpu.search.processor import decode_jpeg_to_rgb as jdec
    np.testing.assert_array_equal(decode_jpeg_to_rgb(reader.read_jpeg(data)),
                                  jdec(jreader.read_jpeg(data)))


def test_frozen_420_state_bit_exact(state420):
    """frozen_chroma_blocks, frozen_y_16x16, the chroma neighborhoods and
    children_state of the port's own Comparator equal the JAX ones (the
    children of a carried-across block state, since the opsin tiles are
    float)."""
    rgb, w, h, target, jcomp, jimg_, comp, pimg = state420
    cbw, cbh = pimg.comps[2].bw, pimg.comps[2].bh
    assert (cbw, cbh) == (7, 4)
    np.testing.assert_array_equal(
        comp.frozen_chroma_blocks(pimg).numpy(),
        np.asarray(jcomp.frozen_chroma_blocks(jimg_)))
    np.testing.assert_array_equal(
        comp.frozen_y_16x16(pimg, cbw, cbh).numpy(),
        np.asarray(jcomp.frozen_y_16x16(jimg_, cbw, cbh)))
    jproc = JProcessor(JParams(), jcomp, JProcessStats())
    mode, jaux = jproc.masking_aux(jimg_, 6, jimg_.comps[2])
    assert mode == "420cl"
    nu, nv = comp.frozen_neighborhoods(pimg)
    np.testing.assert_array_equal(nu.numpy(), np.asarray(jaux[0]))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jaux[1]))
    port = interop.comparator_state_from_numpy(
        rgb, w, h, target, np.asarray(jcomp.xyb0),
        block_state=tuple(np.asarray(a) for a in jcomp.block_state(1, 1)))
    children = port.children_state(cbw, cbh)
    assert len(children) == len(jaux) - 3 == 5
    for g, want in zip(children, jaux[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert not bool(children[4].all())      # the 97th column's children


@pytest.mark.parametrize("direction", [1, -1])
def test_compare_420_and_weights(state420, direction):
    """The whole-image 4:2:0 compare + [4, NB] weights of the back end's
    chroma pass (factor 2) against JAX's _compare_weights_420."""
    rgb, w, h, target, jcomp, jimg_, comp, pimg = state420
    jimg_, pimg = jimg_.copy(), pimg.copy()
    jimg_.apply_global_quantization(np.full((3, 64), 4, np.int32))
    pimg.apply_global_quantization(np.full((3, 64), 4, np.int32))
    want_d, want_w4 = jcomp.compare_img_with_weights(jimg_, direction, 1.0,
                                                     2, 2)
    got_d, got_w4 = comp.fetch_compare(comp.dispatch_compare_with_weights(
        pimg, direction, 1.0, 2, 2))
    assert abs(got_d - want_d) < 2e-3 * max(1.0, want_d)
    np.testing.assert_allclose(comp.distmap.numpy(),
                               np.asarray(jcomp.distmap), rtol=2e-3,
                               atol=2e-3)
    assert got_w4.shape == want_w4.shape == (4, 7 * 4)
    np.testing.assert_array_equal(got_w4, want_w4)
