"""The 4:2:0 greedy zeroing passes of guetzli_tpu_torch (the plain versions
of kernels B' and B'' and of the compares A' and A'') vs the JAX package's
compute_zeroing_csr_staged in modes "420yl" (comp_mask 1) and "420cl"
(comp_mask 6).

The state is bees97x63's forced 4:2:0 image (a 13x8 Y block grid and a
7x4 macroblock grid whose last column has invalid children), frozen by an
unpadded JAX Comparator and handed to the port. Both sides read JAX's
256 sRGB->linear values (see test_torch_tiles_lanes.py on the one-ulp pow
difference).

Bars, as for mode 444 (test_torch_zeroing.py):
  * against JAX run op by op (jax.disable_jit): the CSR bit for bit, on
    the blocks with few candidates (op-by-op JAX costs 2-3 s per greedy
    step here), and the compares within rtol 1e-5 (in fact equal; a slow
    test);
  * against jitted JAX (XLA contracts multiply-adds into FMAs, 2e-3
    relative): the compares of every block within 2e-3, and every block's
    rails equal, or parted at a near-tie within 2e-3, which the test
    prints (one Y block at this state).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.ops import tiles_lanes as jtl
from guetzli_tpu.search import state as jst
from guetzli_tpu.search import zeroing as jz
from guetzli_tpu.search.processor import Params as JParams
from guetzli_tpu.search.processor import Processor as JProcessor
from guetzli_tpu.search.processor import ProcessStats as JProcessStats

from guetzli_tpu_torch import interop
from guetzli_tpu_torch.kernels import tile_compare_lanes as tcl
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing as tz
from guetzli_tpu_torch.search.processor import Params, Processor

T = torch.as_tensor
CPU = torch.device("cpu")
RTOL = 1e-5
FMA_BAND = 2e-3
# mode -> (comp_mask, the JAX package's staged mode)
MODES = {"420y": (1, "420yl"), "420c": (6, "420cl")}


@pytest.fixture(autouse=True)
def jax_srgb(monkeypatch):
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: T(lut).to(device))
    monkeypatch.setenv("GUETZLI_TPU_ZEROING_FUSED", "0")


@pytest.fixture(scope="module")
def state():
    """mode -> (blocks [NB, 3, 64], aux as numpy): the forced-4:2:0 bees
    image's Y-pass and chroma-pass inputs, as masking_aux builds them,
    at quant 8 (Y) and 16 (chroma)."""
    rgb, w, h = jread_png((FIXTURES / "bees97x63.png").read_bytes())
    comp = JComparator(rgb, w, h, 1.0, padded=False)
    jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    img = jst.CoeffImage.from_jpeg(jpg)
    img.downsample()
    img.apply_global_quantization(
        np.repeat(np.array([8, 16, 16], np.int32)[:, None], 64, axis=1))
    proc = JProcessor(JParams(), comp, JProcessStats())
    out = {"jax": (rgb, w, h, comp, img)}
    for mode, (mask, jmode) in MODES.items():
        grid = img.comps[mask.bit_length() - 1]
        got_mode, aux = proc.masking_aux(img, mask, grid)
        assert got_mode == jmode
        blocks = np.zeros((grid.bw * grid.bh, 3, 64), np.int32)
        for c in range(3):
            if (mask >> c) & 1:
                blocks[:, c] = img.comps[c].coeffs
        out[mode] = (blocks, tuple(np.asarray(a) for a in aux))
    return out


def _port_aux(aux):
    return tuple(T(np.array(a)) for a in aux)


def _few_candidates(blocks, aux, k=8):
    n = ((blocks != 0).sum(axis=2) - (blocks[:, :, 0] != 0)).sum(axis=1)
    sel = np.flatnonzero((n > 0) & (n <= k))
    return blocks[sel], tuple(a[sel] for a in aux)


def _zeroed(blocks, seed):
    """Each block with one nonzero AC coefficient zeroed."""
    rng = np.random.default_rng(seed)
    out = blocks.copy()
    for b in range(out.shape[0]):
        flat = out[b].reshape(-1)
        nz = [k for k in np.flatnonzero(flat) if k % 64]
        if nz:
            flat[rng.choice(nz)] = 0
    return out


def _jax_compare(mode, cand, aux):
    if mode == "420y":
        return jtl.compare_blocks_lanes420y(
            jnp.asarray(cand)[:, 0], *jtl.transpose_aux_420y(*aux))
    return jtl.compare_blocks_lanes420c(
        jnp.asarray(cand)[:, 1], jnp.asarray(cand)[:, 2],
        *jtl.transpose_aux_420c(*aux))


def _port_compare(mode, cand, aux):
    """The mode's kernel A wrapper on CPU tensors (its plain version)."""
    ct = T(cand).reshape(-1, 3, 8, 8).permute(1, 2, 3, 0).contiguous()
    before = dict(tcl.launches)
    out = tcl.tile_compare_lanes(ct, *tl.LANE_AUX[mode](*_port_aux(aux)),
                                 mode=mode)
    assert tcl.launches == before      # the plain version launches nothing
    return out.numpy()


def _port_compare_blocks(mode, cand, aux):
    """The blocks-leading twins of the plain compares."""
    if mode == "420y":
        return tl.compare_blocks_lanes420y(
            T(cand[:, 0]), *tl.transpose_aux_420y(*_port_aux(aux)))
    return tl.compare_blocks_lanes420c(
        T(cand[:, 1]), T(cand[:, 2]),
        *tl.transpose_aux_420c(*_port_aux(aux)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_compare_vs_jax_jitted(state, mode):
    """Every block (the invalid children of the last macroblock column
    included) against jitted JAX: within the FMA band; the kernel layout
    and the blocks-leading form agree bit for bit."""
    blocks, aux = state[mode]
    cand = _zeroed(blocks, 3)
    want = np.asarray(jax.jit(partial(_jax_compare, mode))(cand, aux))
    got = _port_compare(mode, cand, aux)
    np.testing.assert_allclose(got, want, rtol=FMA_BAND, atol=0)
    np.testing.assert_array_equal(
        _port_compare_blocks(mode, cand, aux).numpy(), got)


@pytest.mark.slow
@pytest.mark.parametrize("mode", sorted(MODES))
def test_compare_vs_jax_op_by_op(state, mode):
    blocks, aux = state[mode]
    cand = _zeroed(blocks, 3)
    with jax.disable_jit():
        want = np.asarray(_jax_compare(mode, cand, aux))
    np.testing.assert_allclose(_port_compare(mode, cand, aux), want,
                               rtol=RTOL, atol=0)


def test_transposes_match_jax(state):
    """The folded layouts equal JAX's transposes; the kernel layout of the
    chroma pass equals the one guetzli_tpu/search/zeroing._fused_program
    builds for the Pallas kernel (sub-blocks as leading dims)."""
    _blocks, aux = state["420y"]
    for g, w in zip(tl.transpose_aux_420y(*_port_aux(aux)),
                    jtl.transpose_aux_420y(*aux)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _blocks, aux = state["420c"]
    for g, w in zip(tl.transpose_aux_420c(*_port_aux(aux)),
                    jtl.transpose_aux_420c(*aux)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nu, nv, y16, x0s, scs, ysub, xsub, val = aux
    n = nu.shape[0]
    want = (nu.transpose(1, 2, 0), nv.transpose(1, 2, 0),
            y16.transpose(1, 2, 0),
            x0s.reshape(n, 2, 2, 3, 8, 8).transpose(1, 2, 3, 4, 5, 0),
            scs.transpose(1, 2, 3, 0), ysub[..., 7].transpose(1, 2, 0),
            xsub[..., 7].transpose(1, 2, 0), val.transpose(1, 2, 0))
    got = tl.kernel_aux_420c(*_port_aux(aux))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    assert not val.all()


def test_interop_carries_420_state(state):
    """comparator_state_from_numpy hands the port the JAX comparator's
    frozen 4:2:0 state, and the port's masking_aux then gives the zeroing
    passes exactly that state."""
    rgb, w, h, jcomp, jimg = state["jax"]
    y_aux, c_aux = state["420y"][1], state["420c"][1]
    port = interop.comparator_state_from_numpy(
        rgb, w, h, 1.0, np.asarray(jcomp.xyb0),
        block_state=y_aux[1:],
        frozen_420={"chroma_bytes": y_aux[0], "neighborhoods": c_aux[:2],
                    "y16": c_aux[2], "children": c_aux[3:]})
    img = st.CoeffImage(w, h, [
        st.ComponentState(c.factor_x, c.factor_y, c.bw, c.bh,
                          c.coeffs.copy(), c.quant.copy())
        for c in jimg.comps])
    proc = Processor(Params(), port, None)
    for mode, (mask, _jmode) in MODES.items():
        grid = img.comps[mask.bit_length() - 1]
        got_mode, aux = proc.masking_aux(img, mask, grid)
        assert got_mode == mode
        want = state[mode][1]
        assert len(aux) == len(want)
        for g, w_ in zip(aux, want):
            np.testing.assert_array_equal(g.numpy(), w_)


def _jax_csr(mode, blocks, aux, limit, early_exit=False):
    mask, jmode = MODES[mode]
    return jz.compute_zeroing_csr_staged(
        blocks, blocks, limit, tuple(jnp.asarray(a) for a in aux), jmode,
        mask, early_exit=early_exit)


def _port_csr(mode, blocks, aux, limit, early_exit=False, fused=True):
    return tz.compute_zeroing_csr(
        blocks, blocks, limit, _port_aux(aux), MODES[mode][0], CPU,
        mode=mode, early_exit=early_exit, fused=fused)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_csr_bit_exact_vs_jax_op_by_op(state, mode):
    """The blocks with at most 6 candidates; early exit at 3.0 in the Y
    pass, limit 2.5 in the chroma pass."""
    blocks, aux = _few_candidates(*state[mode], k=6)
    assert len(blocks) >= 6
    limit = np.float32(3.0 if mode == "420y" else 2.5)
    early = mode == "420y"
    with jax.disable_jit():
        want = _jax_csr(mode, blocks, aux, limit, early)
    got = _port_csr(mode, blocks, aux, limit, early)
    for name, w, g in zip(("offsets", "cand_idx", "cand_err"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got[1]) > 0


def _block_error(mode, block, aux, b, zeroed):
    c = block.reshape(-1).copy()
    c[list(zeroed)] = 0
    return float(_port_compare(mode, c.reshape(1, 3, 64),
                               tuple(a[b:b + 1] for a in aux))[0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rails_vs_jax_jitted(state, mode):
    blocks, aux = state[mode]
    mask, jmode = MODES[mode]
    limit = np.float32(2.5)
    want_idx, want_rev, _num = jz.compute_zeroing_order_staged(
        blocks, blocks, limit, tuple(jnp.asarray(a) for a in aux), jmode,
        mask)
    idx, err, _perm, inv_perm, _lim = tz.greedy_rails(
        blocks, blocks, limit, _port_aux(aux), mask, CPU, mode=mode)
    got_idx = idx.numpy()[inv_perm]
    err = err.numpy()[inv_perm]
    got_rev = np.minimum.accumulate(err[:, ::-1], axis=1)[:, ::-1]
    parted = []
    for b in range(blocks.shape[0]):
        diff = np.flatnonzero(want_idx[b] != got_idx[b])
        if len(diff) == 0:
            fin = np.isfinite(want_rev[b])
            np.testing.assert_array_equal(np.isfinite(got_rev[b]), fin)
            np.testing.assert_allclose(got_rev[b][fin], want_rev[b][fin],
                                       rtol=FMA_BAND, err_msg="block %d" % b)
            continue
        t = diff[0]
        common = list(got_idx[b][:t])
        e_jax = _block_error(mode, blocks[b], aux, b,
                             common + [want_idx[b][t]])
        e_port = _block_error(mode, blocks[b], aux, b,
                              common + [got_idx[b][t]])
        parted.append((b, int(t), e_jax, e_port))
        assert abs(e_jax - e_port) <= FMA_BAND * max(e_jax, e_port), (
            "block %d parts from JAX at step %d beyond a near-tie: "
            "errors %.7g (JAX's choice) vs %.7g (port's)"
            % (b, t, e_jax, e_port))
    for b, t, ej, ep in parted:
        print("%s near-tie: block %d step %d errors %.7g (JAX) %.7g (port)"
              % (mode, b, t, ej, ep))
    assert len(parted) <= 0.1 * blocks.shape[0], parted


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_equals_staged_on_cpu(state, mode):
    """fused=True (kernel B'/B'' wrapper) and fused=False (the staged loop
    through A'/A'') give the same CSR; on CPU tensors both wrappers run
    their plain versions and launch nothing."""
    blocks, aux = _few_candidates(*state[mode], k=20)
    before = (dict(zl.launches), dict(tcl.launches))
    a = _port_csr(mode, blocks, aux, np.float32(1.5), fused=True)
    b = _port_csr(mode, blocks, aux, np.float32(1.5), fused=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (zl.launches, tcl.launches) == before


def test_wrappers_check_420_operands(state):
    _blocks, aux = state["420c"]
    lanes = tl.kernel_aux_420c(*_port_aux(aux))
    n = lanes[0].shape[-1]
    ct = torch.zeros((3, 8, 8, n), dtype=torch.int32)
    assert tcl.tile_compare_lanes(ct, *lanes, mode="420c").shape == (n,)
    with pytest.raises(TypeError):
        tcl.tile_compare_lanes(ct, *lanes[:-1], mode="420c")
    with pytest.raises(TypeError):
        tcl.tile_compare_lanes(ct, *lanes[:-1], lanes[-1].float(),
                               mode="420c")
    with pytest.raises(ValueError):
        tcl.tile_compare_lanes(ct, *lanes, mode="422")
    with pytest.raises(ValueError):
        zl.zeroing_loop(torch.zeros((192, n), dtype=torch.int32),
                        torch.zeros((192, n), dtype=torch.int32),
                        torch.zeros(n, dtype=torch.int32),
                        torch.zeros(n), lanes[:3] + (lanes[3][..., :1],)
                        + lanes[4:], mode="420c")
