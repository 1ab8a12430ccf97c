"""The port's tooling against the JAX package: the float64 oracle
(ops/numpy_ref.py), the blocks-leading compare (ops/tiles.py), kernel C's
plain version (kernels/tile_compare.py), the opt-in zeroing mode "444p",
--checkcuda (checkcl.py), the butteraugli CLI and the CLI's new flags.

The same numpy inputs go to the JAX function and to its counterpart in
the port. Tolerances: the oracle copy and the integer stages are
bit-exact; the blocks-leading compare and kernel C's plain version are
held to JAX within 2e-3, the band XLA's CPU backend opens by contracting
multiply-adds into FMAs under jit (tests/test_torch_zeroing.py) and the
band tests/test_pallas_kernel.py holds JAX's own kernel C to.

JAX's whole --checkcl run costs about a minute on this CPU per image (its
stages compile one by one, and its two Pallas kernels run in interpret
mode), past this file's budget, so the comparisons that need it are slow
tests: they pin the stage names, the per-stage counts and the butteraugli
distance that the tier-1 tests below hold the port to.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_selection import selection_matrices
from tests.torch_threads import one_torch_thread  # noqa: F401

import chip_smoke
from guetzli_tpu.kernels import tile_compare as jtc
from guetzli_tpu.ops import numpy_ref as jnr
from guetzli_tpu.ops import tiles as jtiles

from guetzli_tpu_torch import butteraugli_cli, checkcl, cli, config, consts
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import numpy_ref as nr
from guetzli_tpu_torch.ops import tiles
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.search import zeroing
from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb

T = torch.as_tensor
CPU = torch.device("cpu")
CORPUS = FIXTURES.parent / "corpus"
BEES = FIXTURES / "bees96x64.png"
BEES_REF = FIXTURES / "bees96x64_ref_q95.jpg"
BEES420 = CORPUS / "bees_d-420.jpg"
# XLA's FMA band on the CPU (see the module docstring).
FMA_BAND = 2e-3

# The stage lines of JAX's run_checkcl on bees96x64 (test_checkcl_names_
# match_jax reads them from JAX), with its two kernel lines under the
# port's names.
STAGES = (["Blur sigma=%s" % s for s in ("0.4", "0.586", "1.1", "1.5",
                                         "4.53359", "8.85109", "9.65781",
                                         "14", "14.2645")]
          + ["OpsinDynamicsImage", "MaskHighIntensityChange",
             "EdgeDetectorMap", "BlockDiffMap(dc)", "BlockDiffMap(ac)",
             "EdgeDetectorLowFreq", "DiffPrecompute", "Average5x5",
             "MinSquareVal", "Mask", "Mask(dc)", "CombineChannels",
             "CalculateDiffmap", "ButteraugliScore",
             "CompareBlock[96 blocks]", "CompareBlockLanes[96 blocks]"])
KERNEL_NAMES = {"tile_compare(pallas)": "tile_compare",
                "tile_compare(pallas_lanes)": "tile_compare_lanes"}
# JAX's compute_distance of the butteraugli CLI's test pair (read from JAX
# by test_butteraugli_distance_matches_jax).
JAX_DISTANCE = 0.9713223


def _lines(text):
    """[(stage, count or the SKIPPED text)] of a checkcl report."""
    out = []
    for ln in text.splitlines():
        if not ln.startswith("checkcl "):
            continue
        stage, rest = ln[len("checkcl "):].split(": ", 1)
        out.append((stage, int(rest.split("/")[0])
                    if "mismatches" in rest else rest))
    return out


@pytest.fixture(scope="module")
def bees():
    return read_png(BEES.read_bytes())


@pytest.fixture(scope="module")
def bees420():
    jpg = reader.read_jpeg(BEES420.read_bytes())
    return decode_jpeg_to_rgb(jpg), jpg.width, jpg.height


# -- the float64 oracle --------------------------------------------------------

def test_numpy_ref_source_is_a_copy():
    """Below its docstring the port's oracle is the JAX package's, line for
    line, but for the consts import."""
    def body(mod):
        text = pathlib.Path(mod.__file__).read_text()
        return text[text.index('"""', 3) + 3:].replace(
            "from guetzli_tpu_torch import consts",
            "from guetzli_tpu import consts")
    assert body(nr) == body(jnr)


@pytest.fixture(scope="module")
def oracle_inputs(bees):
    """The inputs checkcl gives the oracle on bees96x64: the linear image,
    its quant-3 re-encode, and the stages' float64 intermediates."""
    rgb, w, h = bees
    lut = consts.SRGB_TO_LINEAR.astype(np.float64)
    jpg = checkcl._quant3_jpeg(rgb, w, h)
    lin0 = lut[rgb].transpose(2, 0, 1)
    lin1 = lut[decode_jpeg_to_rgb(jpg)].transpose(2, 0, 1)
    xyb0 = nr.opsin_dynamics_image(lin0)
    xyb1 = nr.opsin_dynamics_image(lin1)
    m0, m1 = nr.mask_high_intensity_change(xyb0, xyb1)
    dc, ac = nr.block_diff_map(m0, m1)
    mask, mask_dc = nr.mask(m0, m1)
    edge = nr.edge_detector_map(m0, m1)
    res = nr.combine_channels(mask, mask_dc, dc, ac, edge, h, w)
    tiles_lin = lin1[:, :8, :16].reshape(3, 8, 2, 8).transpose(2, 0, 1, 3)
    return dict(lin0=lin0, m0=m0, m1=m1, xyb0=xyb0, xyb1=xyb1, ac=ac,
                res=res, dm=nr.calculate_diffmap(res, h, w), h=h, w=w,
                x0t=nr.opsin_dynamics_blocks(tiles_lin[::-1]),
                tiles_lin=tiles_lin, scale=np.array([[1.0, 0.5, 2.0]] * 2))


ORACLE_CALLS = {
    "blur": lambda m, d: m.blur(d["lin0"][1], 4.5, 0.0),
    "opsin_dynamics_image": lambda m, d: m.opsin_dynamics_image(d["lin0"]),
    "mask_high_intensity_change": lambda m, d:
        m.mask_high_intensity_change(d["xyb0"], d["xyb1"]),
    "edge_detector_map": lambda m, d: m.edge_detector_map(d["m0"], d["m1"]),
    "block_diff_map": lambda m, d: m.block_diff_map(d["m0"], d["m1"]),
    "edge_detector_low_freq": lambda m, d:
        m.edge_detector_low_freq(d["m0"], d["m1"], d["ac"]),
    "diff_precompute": lambda m, d: m.diff_precompute(d["m0"], d["m1"]),
    "average5x5": lambda m, d: m.average5x5(d["xyb0"][0]),
    "min_square_val": lambda m, d: m.min_square_val(d["xyb0"][1]),
    "mask": lambda m, d: m.mask(d["m0"], d["m1"]),
    "combine_channels": lambda m, d: m.combine_channels(
        *m.mask(d["m0"], d["m1"]), *m.block_diff_map(d["m0"], d["m1"]),
        m.edge_detector_map(d["m0"], d["m1"]), d["h"], d["w"]),
    "calculate_diffmap": lambda m, d:
        m.calculate_diffmap(d["res"], d["h"], d["w"]),
    "score_from_diffmap": lambda m, d: m.score_from_diffmap(d["dm"]),
    "compare_blocks": lambda m, d:
        m.compare_blocks(d["x0t"], d["tiles_lin"], d["scale"]),
}


@pytest.mark.parametrize("fn", sorted(ORACLE_CALLS))
def test_numpy_ref_bit_exact_vs_jax(oracle_inputs, fn):
    """Every oracle function checkcl calls gives the JAX package's bits."""
    got = ORACLE_CALLS[fn](nr, oracle_inputs)
    want = ORACLE_CALLS[fn](jnr, oracle_inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- the blocks-leading compare and kernel C's plain version -----------------

@pytest.fixture(scope="module")
def blocks420(bees420):
    """bees_d-420's quant-3 blocks (97x63: edge blocks in both
    directions) with their clamped index vectors and block state."""
    rgb, w, h = bees420
    cand = checkcl._blocks(checkcl._quant3_jpeg(rgb, w, h))
    comp = Comparator(rgb, w, h, 1.0, CPU)
    comp.start_block_comparisons()
    x0, sc, ysel, xsel = comp.block_state(1, 1)
    return cand, x0.contiguous().numpy(), sc.numpy(), ysel.numpy(), \
        xsel.numpy()


def test_selection_matrices_bit_exact(blocks420):
    _cand, _x0, _sc, ysel, xsel = blocks420
    want = jtc._selection_matrices(ysel, xsel)
    got = kc.selection_matrices(T(ysel), T(xsel))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_tiles_to_linear_rgb_vs_jax(blocks420, monkeypatch):
    """Integer stages bit-exact (edge replication included); the linear
    values within an ulp (XLA's and PyTorch's float32 pow differ by one at
    6 of 256 bytes), and bit-exact with JAX's own 256 values."""
    cand, _x0, _sc, ysel, xsel = blocks420
    v = np.random.default_rng(3).integers(0, 256, (len(cand), 3, 8, 8))
    np.testing.assert_array_equal(
        tiles.edge_replicate(T(v.astype(np.int32)), T(ysel), T(xsel)),
        np.asarray(jtiles.edge_replicate(jnp.asarray(v, jnp.int32),
                                         jnp.asarray(ysel),
                                         jnp.asarray(xsel))))
    want = np.asarray(jtiles.tiles_to_linear_rgb(
        jnp.asarray(cand), jnp.asarray(xsel), jnp.asarray(ysel)))
    got = tiles.tiles_to_linear_rgb(T(cand), T(xsel), T(ysel)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    from guetzli_tpu.ops import image as jimg
    lut = np.asarray(jimg.srgb_to_linear(jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_to_linear",
                        lambda v: T(np.array(lut))[v.long()])
    got = tiles.tiles_to_linear_rgb(T(cand), T(xsel), T(ysel)).numpy()
    np.testing.assert_array_equal(got, want)


def test_compare_blocks_vs_jax(blocks420):
    """The blocks-leading compare against JAX's on the same inputs, within
    2e-3 on checkcl's own error measure, |got - want| / max(|want|, 1).
    Plain relative error is not that measure: the port's and XLA's float32
    per-tile opsin round differently (each 2.7e-3 from the float64 opsin
    at values near 52), and the block error, a function of small
    differences, amplifies that to 2.8e-3 relative on one block of 104
    whose error is small (0.17654 vs JAX's 0.17605; the float64 oracle
    gives 0.17620)."""
    cand, x0, sc, ysel, xsel = blocks420
    lin = jtiles.tiles_to_linear_rgb(jnp.asarray(cand), jnp.asarray(xsel),
                                     jnp.asarray(ysel))
    want = np.asarray(jtiles.compare_blocks(jnp.asarray(x0), lin,
                                            jnp.asarray(sc)))
    got = tiles.compare_blocks(T(x0), T(np.array(lin)), T(sc)).numpy()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= FMA_BAND, (err.argmax(), got[err.argmax()],
                                   want[err.argmax()])


@pytest.fixture(scope="module")
def jax_kernel_c():
    """tests/test_pallas_kernel.py's setup (bees96x64 at quant 3, JAX's
    block state) and JAX's kernel C on it, in interpret mode."""
    from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu.comparator import Comparator as JComparator
    from guetzli_tpu.io.png import read_png as jread_png
    rgb, w, h = jread_png(BEES.read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h,
                             quant=np.full((3, 64), 3, dtype=np.int32))
    coeffs = np.stack([c.coeffs.astype(np.int32) * 3
                       for c in jpg.components])
    comp = JComparator(rgb, w, h, 1.0)
    comp.start_block_comparisons()
    x0, sc, ysel, xsel = (np.array(a) for a in comp.block_state(1, 1))
    cand = np.ascontiguousarray(np.transpose(coeffs, (1, 0, 2)))
    sy, sx = jtc._selection_matrices(ysel, xsel)
    return (cand, x0, sc, sy, sx, ysel, xsel), _jax_c(cand, x0, sc, sy, sx)


def _jax_c(*args):
    """JAX's kernel C in interpret mode on the blocks of `args` (cand, x0,
    sc, sy, sx), zero-padded to its tile."""
    nb = args[0].shape[0]
    n = -(-nb // jtc.TILE) * jtc.TILE

    def pad(a):
        return jnp.asarray(np.concatenate(
            [a, np.zeros((n - nb,) + a.shape[1:], a.dtype)]))

    got = jtc.tile_compare_pallas(*[pad(a) for a in args], interpret=True)
    return np.asarray(got)[:nb]


def test_plain_c_vs_jax_interpret(jax_kernel_c):
    """Kernel C's plain version against JAX's kernel C, within the band
    tests/test_pallas_kernel.py holds JAX's to; and equal to the plain
    compare A bit for bit on the same blocks."""
    (cand, x0, sc, sy, sx, ysel, xsel), want = jax_kernel_c
    before = kc.launches
    got = kc.tile_compare(T(cand), T(x0), T(sc), T(sy), T(sx))
    assert kc.launches == before           # the plain version launches none
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    a = tl.compare_blocks_lanes444(
        T(cand), *tl.transpose_aux_444(T(x0), T(sc), T(ysel), T(xsel)))
    assert torch.equal(got, a)


def test_plain_c_vs_jax_interpret_general_selection(jax_kernel_c):
    """Kernel C's plain version against JAX's kernel C on the same blocks
    with 0/1 selection matrices that no edge clamp gives (all-zero rows,
    rows with two ones, permutations; tests/torch_selection.py), within
    the band of test_plain_c_vs_jax_interpret."""
    (cand, x0, sc, _sy, _sx, _ysel, _xsel), _want = jax_kernel_c
    sy, sx = selection_matrices(len(cand), "mixed", 11)
    want = _jax_c(cand, x0, sc, sy, sx)
    got = kc.tile_compare(T(cand), T(x0), T(sc), T(sy), T(sx))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_tile_compare_wrapper_checks():
    n = 3
    cand = torch.zeros((n, 3, 64), dtype=torch.int32)
    x0 = torch.zeros((n, 3, 64))
    sc = torch.ones((n, 3))
    sy, sx = kc.selection_matrices(torch.full((n, 8), 7), torch.zeros(
        (n, 8), dtype=torch.int64))
    with pytest.raises(TypeError):
        kc.tile_compare(cand.float(), x0, sc, sy, sx)
    with pytest.raises(ValueError):
        kc.tile_compare(cand, x0[:2], sc, sy, sx)
    with pytest.raises(ValueError):
        kc.tile_compare(cand, x0, sc.t().contiguous().t(), sy, sx)
    assert kc.tile_compare(cand, x0, sc, sy, sx).shape == (n,)


# -- mode "444p" ---------------------------------------------------------------

@pytest.fixture(scope="module")
def bees_q5(bees):
    """tests/test_torch_zeroing.py's bees setup (quant 5), with the port's
    own block state."""
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    rgb, w, h = bees
    jpg = encode_rgb_to_jpeg(rgb, w, h, quant=np.full((3, 64), 5, np.int32))
    coeffs = np.stack([c.coeffs.astype(np.int32) * 5
                       for c in jpg.components])
    comp = Comparator(rgb, w, h, 1.0, CPU)
    comp.start_block_comparisons()
    return (np.ascontiguousarray(coeffs.transpose(1, 0, 2)),
            comp.block_state(1, 1))


CASES_444P = {
    "bees": dict(limit=1.0),
    "limit0.8": dict(limit=0.8),
    "limit2.5": dict(limit=2.5),
    "early_exit": dict(limit=1.2, early_exit=True),
    "multi_tile_vector_limit": dict(multi=True),
}


@pytest.mark.parametrize("case", sorted(CASES_444P))
def test_444p_csr_equals_444(bees_q5, case):
    """The staged loop with kernel C's wrapper (mode 444p) gives mode
    444's CSR bit for bit, on the setups of test_torch_zeroing.py."""
    cand, (x0, sc, ysel, xsel) = bees_q5
    kw = CASES_444P[case]
    aux = (x0, sc, ysel, xsel)
    limit, real_index = np.float32(kw.get("limit", 0.0)), None
    if kw.get("multi"):
        nb, pad = cand.shape[0], 7

        def padb(a):
            a = np.asarray(a)
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                               a.dtype)])

        cand = np.concatenate([padb(cand)] * 2)
        aux = tuple(T(np.concatenate([padb(a)] * 2)) for a in aux)
        limit = np.concatenate([np.full(nb + pad, 0.9, np.float32),
                                np.full(nb + pad, 2.0, np.float32)])
        real_index = np.concatenate([np.arange(nb),
                                     (nb + pad) + np.arange(nb)])
    early = kw.get("early_exit", False)
    want = zeroing.compute_zeroing_csr(cand, cand, limit, aux, 7, CPU,
                                       real_index=real_index,
                                       early_exit=early)
    sy, sx = kc.selection_matrices(aux[2], aux[3])
    got = zeroing.compute_zeroing_csr(cand, cand, limit,
                                      (aux[0], aux[1], sy, sx), 7, CPU,
                                      mode="444p", real_index=real_index,
                                      early_exit=early)
    assert len(want[1]) > 100
    for name, w, g in zip(("offsets", "cand_idx", "cand_err"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pallas_1_gives_default_bytes(bees, monkeypatch):
    """GUETZLI_TPU_PALLAS=1, read at call time, switches a 4:4:4 encode to
    mode 444p and gives the default path's bytes; other values keep the
    default."""
    from guetzli_tpu_torch.search.processor import Params, process_rgb
    rgb, _w, _h = bees
    sub = np.ascontiguousarray(rgb[:40, :48])
    modes = []
    real = zeroing.compute_zeroing_csr

    def spy(*a, **k):
        modes.append(k["mode"])
        return real(*a, **k)

    monkeypatch.setattr(zeroing, "compute_zeroing_csr", spy)

    def encode():
        p = Params()
        p.butteraugli_target = consts.butteraugli_score_for_quality(95)
        return process_rgb(p, sub, 48, 40, None, CPU)

    monkeypatch.setenv("GUETZLI_TPU_PALLAS", "2")
    assert config.pallas() == 2
    default = encode()
    monkeypatch.setenv("GUETZLI_TPU_PALLAS", "1")
    assert encode() == default
    assert modes == ["444", "444p"]


# -- --checkcuda -----------------------------------------------------------------

def test_checkcl_bees_cpu(bees):
    """On the CPU the port's run_checkcl finds no mismatch on bees96x64,
    reports JAX's stages in JAX's order, and labels its kernel lines
    (plain): on CPU tensors the wrappers launch nothing."""
    rgb, w, h = bees
    err = io.StringIO()
    before = (kc.launches, dict(zl.launches))
    with contextlib.redirect_stderr(err):
        assert checkcl.run_checkcl(rgb, w, h, device="cpu") == 0
    assert (kc.launches, zl.launches) == before
    lines = _lines(err.getvalue())
    assert [s for s, _n in lines] == STAGES + [
        "tile_compare(plain)", "tile_compare_lanes(plain)", "blur(sharded)"]
    assert all(n == 0 for _s, n in lines[:-1])
    assert lines[-1][1] == "SKIPPED (1 device)"


def test_checkcl_bees420_counts(bees420):
    """bees_d-420 (104 blocks, not a size of the JAX package's padded
    buckets, on which its run_checkcl fails) runs to its end from the
    exact-geometry comparator. Its per-stage counts are the ones pinned
    for the card (chip_smoke.CHECKCUDA_420): JAX's, but for one block
    that sits across the tolerance (test_stage_counts_match_jax_420)."""
    rgb, w, h = bees420
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        total = checkcl.run_checkcl(rgb, w, h, device="cpu")
    counts = dict(_lines(err.getvalue()))
    assert counts.pop("blur(sharded)") == "SKIPPED (1 device)"
    want = {s.replace("[96 blocks]", "[104 blocks]"): 0 for s in STAGES}
    want.update(chip_smoke.CHECKCUDA_420)
    want.update({"tile_compare(plain)": 0, "tile_compare_lanes(plain)": 0})
    assert counts == want
    assert total == sum(want.values())


def test_sharded_blur_note():
    """One device: SKIPPED, as in the JAX package; more than one card: the
    check waits for the multi-GPU slice."""
    assert checkcl._sharded_blur_note(1) == "SKIPPED (1 device)"
    assert "multi-GPU slice" in checkcl._sharded_blur_note(4)


@pytest.mark.slow
def test_checkcl_names_match_jax(bees):
    """JAX's run_checkcl on bees96x64 (its 8 virtual devices run the
    sharded blur): 0 mismatches, and the stages of STAGES in that order."""
    from guetzli_tpu.checkcl import run_checkcl as jrun
    rgb, w, h = bees
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert jrun(rgb, w, h) == 0
    names = [KERNEL_NAMES.get(s, s) for s, _n in _lines(err.getvalue())]
    assert names == STAGES + ["tile_compare", "tile_compare_lanes",
                              "blur(sharded)"]


def _spy_reports(module, monkeypatch):
    """stage -> (got, want) float64 of every _report call of a checkcl
    module."""
    seen = {}
    real = module._report

    def spy(stage, got, want, tol=1e-3):
        seen[stage] = (checkcl._host64(got), checkcl._host64(want), tol)
        return real(stage, got, want, tol)

    monkeypatch.setattr(module, "_report", spy)
    return seen


@pytest.mark.slow
def test_stage_counts_match_jax_420(bees420, monkeypatch):
    """JAX's _stage_checks and the port's on the same bees_d-420 pixels
    count the same mismatches at every stage, but where an element sits
    across the tolerance: each element counted by one side only must lie
    within 30% of the tolerance on the other (the float32 inputs of the
    two sides differ by rounding, which the block error amplifies to
    ~5e-4 relative in the oracle's own value). The elements are printed.
    JAX counts 3/104 on both CompareBlock lines; the port's counts are
    those pinned in chip_smoke.CHECKCUDA_420."""
    import guetzli_tpu.checkcl as jcheckcl
    rgb, w, h = bees420
    jseen = _spy_reports(jcheckcl, monkeypatch)
    pseen = _spy_reports(checkcl, monkeypatch)
    with contextlib.redirect_stderr(io.StringIO()):
        jcheckcl._stage_checks(rgb, w, h)
        checkcl._stage_checks(rgb, w, h, CPU)
    assert list(jseen) == list(pseen)

    def errs(g, w):
        return np.abs(g - w) / np.maximum(np.abs(w), 1.0)

    crossing = []
    for stage in jseen:
        jg, jw, tol = jseen[stage]
        pg, pw, _tol = pseen[stage]
        je, pe = errs(jg, jw), errs(pg, pw)
        for i in np.flatnonzero((je > tol) != (pe > tol)):
            crossing.append((stage, int(i), float(je[i]), float(pe[i])))
            assert min(je[i], pe[i]) > 0.7 * tol, crossing[-1]
        if stage.startswith("CompareBlock"):
            assert int((je > tol).sum()) == 3
            assert int((pe > tol).sum()) == chip_smoke.CHECKCUDA_420[stage]
        else:
            assert not (je > tol).any() and not (pe > tol).any(), stage
    for c in crossing:
        print("across the tolerance: %s element %d, JAX %.4g, port %.4g" % c)
    assert len(crossing) <= 2


# -- the butteraugli CLI ------------------------------------------------------

def test_butteraugli_distance_png_vs_ref_jpeg(tmp_path, capsys):
    """tests/test_butteraugli_cli.py's first test on the port: the q95
    band, the heatmap PGM; and the distance JAX gives (JAX_DISTANCE)
    within 2e-3, the one chip_smoke.py pins for the card printed."""
    hm = tmp_path / "heat.pgm"
    assert butteraugli_cli.main(["--cpu", str(BEES), str(BEES_REF),
                                 str(hm)]) == 0
    out = capsys.readouterr().out.strip()
    d = float(out)
    assert 0.5 < d < 1.2, d
    assert out == "%.6f" % chip_smoke.BUTTERAUGLI_CPU
    assert abs(d - JAX_DISTANCE) <= 2e-3 * JAX_DISTANCE
    data = hm.read_bytes()
    assert data.startswith(b"P5\n96 64\n255\n")
    assert len(data) == len(b"P5\n96 64\n255\n") + 96 * 64
    pix = np.frombuffer(data.split(b"255\n", 1)[1], dtype=np.uint8)
    assert pix.max() == 255


def test_butteraugli_identical_images_zero_distance(capsys):
    assert butteraugli_cli.main(["--cpu", str(BEES), str(BEES)]) == 0
    assert float(capsys.readouterr().out.strip()) == 0.0


def test_butteraugli_size_mismatch_and_usage(capsys):
    assert butteraugli_cli.main(["--cpu", str(BEES),
                                 str(FIXTURES / "bees160x120.png")]) == 1
    assert "same size" in capsys.readouterr().err
    assert butteraugli_cli.main(["--cpu", "one.png"]) == 1
    assert "Usage" in capsys.readouterr().err


@pytest.mark.slow
def test_butteraugli_distance_matches_jax(tmp_path, capsys):
    """JAX's butteraugli CLI on the same pair: its distance is
    JAX_DISTANCE, and its heatmap has the port's size."""
    from guetzli_tpu import butteraugli_cli as jcli
    hm = tmp_path / "jax.pgm"
    assert jcli.main([str(BEES), str(BEES_REF), str(hm)]) == 0
    d = float(capsys.readouterr().out.strip())
    assert abs(d - JAX_DISTANCE) <= 1e-6
    assert len(hm.read_bytes()) == len(b"P5\n96 64\n255\n") + 96 * 64


# -- the command lines -------------------------------------------------------------

@pytest.fixture(scope="module")
def crop_png(bees, tmp_path_factory):
    import PIL.Image
    rgb, _w, _h = bees
    d = tmp_path_factory.mktemp("crops")
    PIL.Image.fromarray(np.ascontiguousarray(rgb[:40, :40])).save(
        d / "c40.png")
    PIL.Image.fromarray(np.ascontiguousarray(rgb[:16, :16])).save(
        d / "c16.png")
    return d


@pytest.mark.parametrize("flag", ["--checkcuda", "--checkcl"])
def test_cli_checkcuda(crop_png, tmp_path, capsys, flag):
    """The check runs first, on the input image, then the encode."""
    dst = tmp_path / "o.jpg"
    assert cli.main(["--cpu", flag, str(crop_png / "c40.png"),
                     str(dst)]) == 0
    err = capsys.readouterr().err
    assert "checkcl tile_compare(plain): 0/25 " in err
    assert "checkcl tile_compare_lanes(plain): 0/25 " in err
    assert dst.read_bytes()[:2] == b"\xff\xd8"


def test_checkcuda_kernel_failure_propagates(crop_png, tmp_path,
                                             monkeypatch):
    """A kernel that fails is not skipped: the exception leaves the CLI
    (the JAX package prints SKIPPED and goes on)."""
    def fail(*a, **k):
        raise RuntimeError("tile_compare launch failed: CUDA error 98")

    monkeypatch.setattr(kc, "tile_compare", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cli.main(["--cpu", "--checkcuda", str(crop_png / "c40.png"),
                  str(tmp_path / "o.jpg")])


def test_cli_profile_writes_trace(crop_png, tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--cpu", "--profile", str(prof),
                     str(crop_png / "c16.png"), str(tmp_path / "o.jpg")]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert cli.main(["--cpu", "--profile"]) == 1


def test_clis_without_card_exit_1(monkeypatch, crop_png, tmp_path, capsys):
    """Without --cpu and without a card both command lines exit 1 with a
    message, the kernel check included; --mesh stays refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    png = str(crop_png / "c40.png")
    assert cli.main([png, str(tmp_path / "o.jpg")]) == 1
    assert "device='cpu'" in capsys.readouterr().err
    assert cli.main(["--checkcuda", png, str(tmp_path / "o.jpg")]) == 1
    assert "--cpu" in capsys.readouterr().err
    assert butteraugli_cli.main([png, png]) == 1
    assert "--cpu" in capsys.readouterr().err
    assert cli.main(["--mesh", "2", png, str(tmp_path / "o.jpg")]) == 1
    assert "Usage" in capsys.readouterr().err


def test_python_m_package_encodes_bees(tmp_path):
    """python -m guetzli_tpu_torch --cpu encodes bees96x64 at q95 within
    2% of the reference encoder's 2364 bytes."""
    dst = tmp_path / "o.jpg"
    r = subprocess.run(
        [sys.executable, "-m", "guetzli_tpu_torch", "--cpu", str(BEES),
         str(dst)], cwd=FIXTURES.parent.parent, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    out = dst.read_bytes()
    assert abs(len(out) - 2364) <= 0.02 * 2364, len(out)
    assert reader.read_jpeg(out).width == 96
