"""The JAX package's zeroing routes, the NO_NATIVE opt-out and the debug
knob in the port.

  * The readers of guetzli_tpu_torch/config.py parse each variable as
    guetzli_tpu/config.current() does.
  * Routes, on bees96x64's 4:4:4 state at quant 5 (the setup of
    tests/test_zeroing_fused.py) and on bees_d-420.jpg's two 4:2:0 passes
    as select_frequency_masking builds them: GUETZLI_TPU_ZEROING_FUSED=0
    (the staged loop, A, A' or A'' per step), GUETZLI_TPU_STAGED_ZEROING=0
    (the full-batch loop and the host CSR) and GUETZLI_TPU_PALLAS=0 give
    the fused route's CSR arrays bit for bit. GUETZLI_TPU_LANES=0 makes
    the staged and full-batch loops evaluate blocks-leading
    (ops/tiles.py), another rounding of the block error, as in the JAX
    package (tests/test_tiles_lanes.py holds JAX's two forms to 2e-3):
    the two evaluations agree within that band, the staged and
    full-batch loops give one CSR, and on the fused route it changes
    nothing.
  * Against JAX under the same variables, run op by op (jax.disable_jit,
    the variables set by monkeypatch), on 16 4:4:4 blocks cut to 4
    candidates (op-by-op JAX costs ~0.6 s a greedy step): the CSR bit for
    bit, and for LANES=0 (XLA's dot and PyTorch's matmul round the DFT
    differently) the same offsets and indices with errors within 1e-5.
  * On a 48x40 bees crop at q95 (tests/test_e2e.py:207-240's setup):
    NO_NATIVE gives the default's bytes; ZEROING_DEBUG=1 writes its
    stage lines and the same bytes; ZEROING_FUSED=0 and STAGED_ZEROING=0
    take their routes (the fused loop, and the device CSR, refused) and
    give the same bytes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import config as jconfig
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.ops import tiles_lanes as jtl
from guetzli_tpu.search import zeroing as jz

from guetzli_tpu_torch import config, consts, native
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing as tz
from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                ProcessStats,
                                                decode_jpeg_to_rgb,
                                                process_rgb)

T = torch.as_tensor
CPU = torch.device("cpu")
CORPUS = FIXTURES.parent / "corpus"
KNOBS = ("ZEROING_FUSED", "STAGED_ZEROING", "LANES", "PALLAS", "NO_NATIVE",
         "ZEROING_DEBUG", "EXACT_LUT", "LANE_SAFE", "SEL_MATMUL")
# The routes that must give the fused route's CSR arrays bit for bit.
EXACT_ROUTES = {"staged": {"ZEROING_FUSED": "0"},
                "full_batch": {"STAGED_ZEROING": "0"},
                "pallas0": {"PALLAS": "0"}}
# The band of JAX's own two block-error forms (tests/test_tiles_lanes.py).
FORM_BAND = 2e-3


def _set(monkeypatch, env):
    for k in KNOBS:
        monkeypatch.delenv("GUETZLI_TPU_" + k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv("GUETZLI_TPU_" + k, v)


@pytest.mark.parametrize("value", [None, "", "0", "1", "2", "yes"])
def test_readers_parse_as_jax(value, monkeypatch):
    pairs = {"EXACT_LUT": ("exact_lut", config.exact_lut),
             "LANE_SAFE": ("lane_safe", config.lane_safe),
             "ZEROING_FUSED": ("zeroing_fused", config.zeroing_fused),
             "STAGED_ZEROING": ("staged_zeroing", config.staged_zeroing),
             "LANES": ("lanes", config.lanes),
             "NO_NATIVE": ("native", config.native),
             "ZEROING_DEBUG": ("zeroing_debug", config.zeroing_debug)}
    _set(monkeypatch, {} if value is None else dict.fromkeys(pairs, value))
    want = jconfig.current()
    for var, (field, reader_fn) in pairs.items():
        assert reader_fn() == getattr(want, field), var
    # SEL_MATMUL is read in JAX's diffmap as == "1".
    _set(monkeypatch, {} if value is None else {"SEL_MATMUL": value})
    assert config.sel_matmul() == (value == "1")


def _csr(blocks, aux, limit, mask, mode, real_index=None):
    """The route the variables choose, as select_frequency_masking runs
    it."""
    kw = dict(mode=mode, real_index=real_index)
    if config.staged_zeroing():
        return tz.compute_zeroing_csr(blocks, blocks, limit, aux, mask, CPU,
                                      **kw)
    out = tz.compute_zeroing_order(blocks, blocks, limit, aux, mask, CPU,
                                   **kw)
    return tz.csr_from_zeroing(*out, limit)


def _assert_csr_equal(want, got):
    for name, w, g in zip(("offsets", "cand_idx", "cand_err"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_csr_close(want, got, rtol):
    _assert_csr_equal(want[:2], got[:2])
    np.testing.assert_allclose(got[2], want[2], rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def jax_444():
    """bees96x64 at quant 5 and the JAX comparator's block state, as
    numpy (tests/test_zeroing_fused.py)."""
    rgb, w, h = jread_png((FIXTURES / "bees96x64.png").read_bytes())
    jpg = jencode(rgb, w, h, quant=np.full((3, 64), 5, dtype=np.int32))
    coeffs = np.stack([c.coeffs.astype(np.int32) * 5
                       for c in jpg.components])
    comp = JComparator(rgb, w, h, 1.0, padded=False)
    comp.start_block_comparisons()
    aux = tuple(np.asarray(a) for a in comp.block_state(1, 1))
    return np.ascontiguousarray(np.transpose(coeffs, (1, 0, 2))), aux


@pytest.fixture(scope="module")
def passes_420():
    """bees_d-420.jpg's two 4:2:0 passes: mode -> (blocks, aux, mask) as
    masking_inputs and masking_aux build them, quantized coarser than the
    file (as tests/test_torch_kernels_host.py does) so that the staged
    loops stay short."""
    jpg = reader.read_jpeg((CORPUS / "bees_d-420.jpg").read_bytes())
    rgb = decode_jpeg_to_rgb(jpg)
    comp = Comparator(rgb, jpg.width, jpg.height,
                      consts.butteraugli_score_for_quality(95), CPU)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    img.apply_global_quantization(
        np.repeat(np.array([10, 16, 16], np.int32)[:, None], 64, axis=1))
    proc = Processor(Params(), comp, None)
    out = {}
    for mask in (1, 6):
        grid = img.comps[mask.bit_length() - 1]
        blocks, _orig = proc.masking_inputs(jpg, img, mask)
        mode, aux = proc.masking_aux(img, mask, grid)
        out[mode] = (blocks, aux, mask)
    return out


def _port_444(jax_444):
    cand, aux = jax_444
    return cand, tuple(T(np.array(a)) for a in aux)


def _no_fused_loop(monkeypatch):
    """Make a call of the fused loop's wrapper (kernel B's) fail."""
    def refuse(*a, **k):
        raise AssertionError("the fused loop ran")
    monkeypatch.setattr(tz.zl, "zeroing_loop", refuse)


@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_444_routes_give_fused_csr(jax_444, route, monkeypatch):
    cand, aux = _port_444(jax_444)
    limit = np.float32(1.5)
    _set(monkeypatch, {})
    want = _csr(cand, aux, limit, 7, "444")
    _set(monkeypatch, EXACT_ROUTES[route])
    before = dict(zl.launches)
    _no_fused_loop(monkeypatch)
    _assert_csr_equal(want, _csr(cand, aux, limit, 7, "444"))
    assert zl.launches == before      # CPU tensors: plain versions only


@pytest.mark.parametrize("mode", ["420y", "420c"])
@pytest.mark.parametrize("route", ["full_batch", "staged"])
def test_420_routes_give_fused_csr(passes_420, mode, route, monkeypatch):
    """(PALLAS=0 leaves the 4:2:0 passes fused, as JAX's auto does on an
    accelerator: fused_wanted.)"""
    blocks, aux, mask = passes_420[mode]
    limit = np.float32(consts.butteraugli_score_for_quality(95))
    _set(monkeypatch, {})
    want = _csr(blocks, aux, limit, mask, mode)
    _set(monkeypatch, EXACT_ROUTES[route])
    _assert_csr_equal(want, _csr(blocks, aux, limit, mask, mode))


@pytest.mark.parametrize("mode", ["444", "420y", "420c"])
def test_lanes0_blocks_leading(jax_444, passes_420, mode, monkeypatch):
    """LANES=0: the staged and the full-batch loop (blocks-leading
    evaluation) give one CSR, within 2% of the fused route's candidates;
    the fused route's CSR does not change; the two evaluations of every
    block as it stands are two roundings within the forms' band."""
    if mode == "444":
        blocks, aux = _port_444(jax_444)
        limit, mask = np.float32(1.5), 7
    else:
        blocks, aux, mask = passes_420[mode]
        limit = np.float32(consts.butteraugli_score_for_quality(95))
    _set(monkeypatch, {})
    fused = _csr(blocks, aux, limit, mask, mode)
    _set(monkeypatch, {"LANES": "0"})
    _assert_csr_equal(fused, _csr(blocks, aux, limit, mask, mode))
    _set(monkeypatch, {"LANES": "0", "ZEROING_FUSED": "0"})
    staged = _csr(blocks, aux, limit, mask, mode)
    _set(monkeypatch, {"LANES": "0", "STAGED_ZEROING": "0"})
    _assert_csr_equal(staged, _csr(blocks, aux, limit, mask, mode))
    assert abs(len(staged[1]) - len(fused[1])) <= 0.02 * len(fused[1])
    lead_args = tz.loop_inputs(blocks, blocks, limit, aux, mask, CPU, mode,
                               lanes=False)[0]
    lane_args = tz.loop_inputs(blocks, blocks, limit, aux, mask, CPU,
                               mode)[0]
    cand = lead_args[0].reshape(3, 8, 8, -1)
    lead = tz._compare_blocks_leading(mode)(cand, *lead_args[4])
    lane = tl.COMPARE[mode](cand, *lane_args[4])
    np.testing.assert_allclose(lead.numpy(), lane.numpy(), rtol=FORM_BAND,
                               atol=1e-3)
    assert not torch.equal(lead, lane)


# -- against JAX under the same variables -----------------------------------

@pytest.fixture
def jax_srgb(monkeypatch):
    """Both compares read JAX's 256 sRGB->linear values (XLA's and
    PyTorch's pow differ by an ulp at 6 of them,
    test_torch_tiles_lanes.py): the lane-major one as a table, the
    blocks-leading one through image.srgb_to_linear."""
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: T(lut).to(device))
    monkeypatch.setattr(img_ops, "srgb_to_linear",
                        lambda rgb, trial_axis=None: T(lut)[rgb.long()])


def _few_candidates(cand, aux, k=4, n=16):
    """The first n blocks with their DC and first k nonzero AC
    coefficients (at most k greedy steps: op-by-op JAX runs one step of
    every block at once)."""
    out = np.zeros_like(cand[:n])
    out[:, :, 0] = cand[:n, :, 0]
    for b in range(n):
        flat = cand[b].reshape(-1)
        keep = [i for i in np.flatnonzero(flat) if i % 64][:k]
        out[b].reshape(-1)[keep] = flat[keep]
    return out, tuple(a[:n] for a in aux)


# (JAX's PALLAS=0 on the CPU is its staged "444l" computation, whose
# port equals the staged route's bit for bit above.)
JAX_ROUTES = {"staged": ({"ZEROING_FUSED": "0"}, "444l"),
              "full_batch": ({"STAGED_ZEROING": "0"}, "444l"),
              "lanes0": ({"LANES": "0", "ZEROING_FUSED": "0"}, "444")}


def _jax_csr(cand, aux, limit, mode):
    """The JAX package's zeroing as its processor runs it under the
    current variables (staged_zeroing: the CSR on the device, else the
    full-batch program and the host CSR), op by op."""
    aux_d = tuple(jnp.asarray(a) for a in aux)
    with jax.disable_jit():
        if jconfig.current().staged_zeroing:
            return jz.compute_zeroing_csr_staged(cand, cand, limit, aux_d,
                                                 mode, 7)
        oi, oe, nn = jz.compute_zeroing_order_with(
            jnp.asarray(cand), jnp.asarray(cand), limit, aux_d, mode, 7)
    oi, oe, nn = np.asarray(oi), np.asarray(oe), np.asarray(nn)
    slot = np.arange(oe.shape[1])[None, :]
    sel = (slot < nn[:, None]) & (oe > 0) & (oe <= limit)
    offsets = np.zeros(len(nn) + 1, np.int64)
    np.cumsum(sel.sum(1), out=offsets[1:])
    return offsets, oi[sel].astype(np.int32), oe[sel].astype(np.float32)


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_444_routes_vs_jax_op_by_op(jax_444, jax_srgb, route, monkeypatch):
    cand, aux = _few_candidates(*jax_444)
    limit = np.float32(1.5)
    env, jmode = JAX_ROUTES[route]
    _set(monkeypatch, env)
    want = _jax_csr(cand, aux, limit, jmode)
    got = _csr(cand, tuple(T(np.array(a)) for a in aux), limit, 7, "444")
    if route == "lanes0":
        _assert_csr_close(want, got, 1e-5)
    else:
        _assert_csr_equal(want, got)


# -- end to end: the opt-outs, the debug lines, the exact routes ------------

@pytest.fixture(scope="module")
def crop():
    rgb, _w, _h = read_png((FIXTURES / "bees96x64.png").read_bytes())
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    return np.ascontiguousarray(rgb[:40, :48]), params


@pytest.fixture(scope="module")
def crop_default(crop):
    sub, params = crop
    return process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")


OPT_OUTS = {"no_native": {"NO_NATIVE": "1"}}


@pytest.mark.parametrize("name", sorted(OPT_OUTS))
def test_opt_outs_give_default_bytes(crop, crop_default, name, monkeypatch):
    sub, params = crop
    _set(monkeypatch, OPT_OUTS[name])
    if name == "no_native":
        assert native.get_lib() is None
        with pytest.raises(RuntimeError, match="NO_NATIVE"):
            native.require_lib()
    got = process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")
    assert got == crop_default


@pytest.mark.parametrize("name", ["staged", "full_batch"])
def test_routes_end_to_end(crop, crop_default, name, monkeypatch):
    """The processor takes the route the variable names (the fused loop
    does not run; under STAGED_ZEROING=0 neither does the device CSR)
    and gives the default's bytes."""
    sub, params = crop
    _set(monkeypatch, EXACT_ROUTES[name])
    _no_fused_loop(monkeypatch)
    if name == "full_batch":
        def refuse(*a, **k):
            raise AssertionError("the device CSR ran")
        monkeypatch.setattr(tz, "compute_zeroing_csr", refuse)
    assert process_rgb(params, sub, 48, 40, ProcessStats(),
                       "cpu") == crop_default


def test_zeroing_debug_lines(crop, crop_default, monkeypatch, capsys):
    sub, params = crop
    _set(monkeypatch, {"ZEROING_DEBUG": "1"})
    got = process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")
    err = capsys.readouterr().err
    for line in ("zeroing-aux: whole-image mask", "zeroing-aux: block state",
                 "zeroing: nb=30 upload+scores",
                 "zeroing-fused: kernel zeroing_loop",
                 "zeroing-csr: counts pull", "zeroing-csr: host build",
                 "zeroing-csr: gather pull"):
        assert line in err, line
    assert got == crop_default
    _set(monkeypatch, {})
    assert tz.debug(CPU, 1.0, "zeroing: none") == 1.0
    assert capsys.readouterr().err == ""


def test_return_memory(monkeypatch):
    """The RSS return runs (gc and malloc_trim where libc has it), and a
    libc without malloc_trim is left alone."""
    proc_mod.return_memory()
    proc_mod.return_memory(collect=False)

    class NoTrim:
        def __getattr__(self, name):
            raise AttributeError(name)
    monkeypatch.setattr(proc_mod.ctypes, "CDLL", lambda name: NoTrim())
    proc_mod.return_memory()


def test_mesh_follows_the_knobs(tmp_path, monkeypatch):
    """Under --mesh the banded chain follows the knobs: bees_d-420 over two
    gloo ranks with GUETZLI_TPU_EXACT_LUT=1 (the banded sRGB read),
    LANE_SAFE=1 (the sharded blurs' upsample) and STAGED_ZEROING=0 (the
    full-batch loop on each band, the rails gathered, the host CSR) gives
    the bytes of one rank under the same variables."""
    from guetzli_tpu_torch import cli
    _set(monkeypatch, {"EXACT_LUT": "1", "LANE_SAFE": "1",
                       "STAGED_ZEROING": "0"})
    src = CORPUS / "bees_d-420.jpg"
    one, two = tmp_path / "one.jpg", tmp_path / "two.jpg"
    assert cli.main(["--cpu", "--mesh", "1", str(src), str(one)]) == 0
    assert cli.main(["--cpu", "--mesh", "2", str(src), str(two)]) == 0
    assert two.read_bytes() == one.read_bytes()


def test_memory_envelope_tiles():
    """memory_envelope's tileCxR:PATH argument: the PNG tiled C across and
    R down (photo_mosaic1 tiled 3x2 is the 7.87 MPix point)."""
    from guetzli_tpu_torch.memory_envelope import load_image
    rgb, w, h = read_png((FIXTURES / "bees96x64.png").read_bytes())
    got, gw, gh = load_image("tile3x2:%s" % (FIXTURES / "bees96x64.png"))
    assert (gw, gh) == (3 * w, 2 * h)
    np.testing.assert_array_equal(got, np.tile(rgb, (2, 3, 1)))
    same, sw, sh = load_image(str(FIXTURES / "bees96x64.png"))
    assert (sw, sh) == (w, h) and np.array_equal(same, rgb)
