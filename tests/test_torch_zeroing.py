"""The plain version of kernel B (the greedy zeroing loop of
guetzli_tpu_torch, kernels/zeroing_loop.zeroing_loop_plain) and the CSR
compaction vs the JAX package's compute_zeroing_csr_staged, mode "444l".

Both sides evaluate the same frozen block state (the JAX Comparator's
block state, handed to the port as tensors) and the same sRGB->linear
values (see test_torch_tiles_lanes.py on the one-ulp pow difference).

Two references:

  * JAX run op by op (jax.disable_jit): the same float32 operations in the
    same order. The port must match it bit for bit: offsets, indices and
    errors. Op-by-op JAX costs ~0.6 s per greedy step, so tier 1 runs it on
    the blocks with at most 8 candidates; the full setups are slow
    tests.
  * JAX as it runs by default (jitted): XLA's CPU backend contracts
    multiply-adds into FMAs, which moves its block errors by up to ~2e-3
    relative against its own op-by-op result. Against it the rails must
    agree except where the two greedy searches part at a near-tie: the test
    finds each such block, re-evaluates both choices at the parting step
    and requires them to lie within that 2e-3 band, and prints the block
    and the two errors. Blocks that never part must agree in every index,
    with errors within the same band.

The setups are those of tests/test_zeroing_fused.py: limits 0.8 and 2.5,
early exit at 1.2, and two images concatenated with bucket padding, a
per-block limit vector and real_index.
"""

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
from guetzli_tpu.search import zeroing as jz

from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.search import zeroing as tz

T = torch.as_tensor
CPU = torch.device("cpu")
# XLA's FMA contraction under jit: JAX's own jitted vs op-by-op errors.
FMA_BAND = 2e-3


@pytest.fixture(autouse=True)
def jax_srgb(monkeypatch):
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: T(lut).to(device))
    monkeypatch.setenv("GUETZLI_TPU_ZEROING_FUSED", "0")


@pytest.fixture(scope="module")
def setup():
    """The test_zeroing_fused.py setup: bees at quant 5, block state of
    an unpadded JAX Comparator, carried across."""
    with open(FIXTURES / "bees96x64.png", "rb") as f:
        rgb, w, h = jread_png(f.read())
    jpg = jencode(rgb, w, h, quant=np.full((3, 64), 5, dtype=np.int32))
    coeffs = np.stack([c.coeffs.astype(np.int32) * 5
                       for c in jpg.components])
    comp = JComparator(rgb, w, h, 1.0, padded=False)
    comp.start_block_comparisons()
    aux = tuple(np.asarray(a) for a in comp.block_state(1, 1))
    cand = np.ascontiguousarray(np.transpose(coeffs, (1, 0, 2)))
    return cand, aux


def _port_aux(aux):
    return tuple(T(np.array(a)) for a in aux)


def _multi(cand, aux):
    """Two copies with 7 padding blocks each, limits 0.9 / 2.0."""
    nb = cand.shape[0]
    pad = 7

    def padb(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    cat = np.concatenate([padb(cand)] * 2)
    cat_aux = tuple(np.concatenate([padb(a)] * 2) for a in aux)
    lim = np.concatenate([np.full(nb + pad, 0.9, np.float32),
                          np.full(nb + pad, 2.0, np.float32)])
    real_index = np.concatenate([np.arange(nb), (nb + pad) + np.arange(nb)])
    return cat, cat_aux, lim, real_index


CASES = {
    "limit0.8": dict(limit=0.8),
    "limit2.5": dict(limit=2.5),
    "early_exit": dict(limit=1.2, early_exit=True),
    "multi_tile_vector_limit": dict(multi=True),
}


def _inputs(setup, case):
    cand, aux = setup
    kw = CASES[case]
    if kw.get("multi"):
        cand, aux, limit, real_index = _multi(cand, aux)
    else:
        limit, real_index = np.float32(kw["limit"]), None
    return cand, aux, limit, real_index, kw.get("early_exit", False)


def _jax_csr(cand, aux, limit, real_index, early_exit):
    return jz.compute_zeroing_csr_staged(
        cand, cand, limit, tuple(jnp.asarray(a) for a in aux), "444l", 7,
        real_index=real_index, early_exit=early_exit)


def _port_csr(cand, aux, limit, real_index, early_exit, fused=True):
    return tz.compute_zeroing_csr(
        cand, cand, limit, _port_aux(aux), 7, CPU, real_index=real_index,
        early_exit=early_exit, fused=fused)


def _assert_csr_equal(want, got):
    for name, w, g in zip(("offsets", "cand_idx", "cand_err"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _few_candidates(cand, aux, k=8):
    """The blocks with at most k zeroing candidates."""
    n = ((cand != 0).sum(axis=2)
         - (cand[:, :, 0] != 0)).sum(axis=1)
    sel = np.flatnonzero(n <= k)
    return cand[sel], tuple(a[sel] for a in aux)


def test_csr_bit_exact_vs_jax_op_by_op(setup):
    """Two concatenated padded images, a limit vector, real_index and early
    exit, on the blocks with at most 8 candidates."""
    cand, aux = _few_candidates(*setup)
    assert len(cand) >= 5
    cand, aux, limit, real_index, _ = _inputs((cand, aux),
                                              "multi_tile_vector_limit")
    early = True
    with jax.disable_jit():
        want = _jax_csr(cand, aux, limit, real_index, early)
    _assert_csr_equal(want, _port_csr(cand, aux, limit, real_index, early))


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_bit_exact_vs_jax_op_by_op_full(setup, case):
    args = _inputs(setup, case)
    with jax.disable_jit():
        want = _jax_csr(*args)
    _assert_csr_equal(want, _port_csr(*args))


def _rails_port(cand, aux, limit, early):
    idx, err, _perm, inv_perm, _lim = tz.greedy_rails(
        cand, cand, limit, _port_aux(aux), 7, CPU, early_exit=early)
    idx = idx.numpy()[inv_perm]
    err = err.numpy()[inv_perm]
    rev = np.minimum.accumulate(err[:, ::-1], axis=1)[:, ::-1]
    return idx, rev


def _block_error(cand_b, aux, b, zeroed):
    """The port's error of block b with the slots `zeroed` set to 0."""
    c = cand_b.reshape(-1).copy()
    c[list(zeroed)] = 0
    x0, sc, ym, xm = tl.transpose_aux_444(*(t[b:b + 1]
                                            for t in _port_aux(aux)))
    return float(tl.compare_blocks_lanes444(T(c[None]), x0, sc, ym, xm)[0])


@pytest.mark.parametrize("case", ["limit2.5", "early_exit"])
def test_rails_vs_jax_jitted(setup, case):
    """The rails depend on the limit only through early exit, so one
    plain case and the early-exit case cover the setups."""
    cand, aux, limit, real_index, early = _inputs(setup, case)
    want_idx, want_rev, _num = jz.compute_zeroing_order_staged(
        cand, cand, limit, tuple(jnp.asarray(a) for a in aux), "444l", 7,
        early_exit=early)
    got_idx, got_rev = _rails_port(cand, aux, limit, early)
    rows = np.arange(cand.shape[0]) if real_index is None else real_index
    flipped = []
    for b in rows:
        diff = np.flatnonzero(want_idx[b] != got_idx[b])
        if len(diff) == 0:
            fin = np.isfinite(want_rev[b])
            np.testing.assert_array_equal(np.isfinite(got_rev[b]), fin)
            np.testing.assert_allclose(got_rev[b][fin], want_rev[b][fin],
                                       rtol=FMA_BAND, err_msg="block %d" % b)
            continue
        t = diff[0]
        common = got_idx[b][:t]
        e_jax = _block_error(cand[b], aux, b, list(common) + [want_idx[b][t]])
        e_port = _block_error(cand[b], aux, b,
                              list(common) + [got_idx[b][t]])
        flipped.append((int(b), int(t), e_jax, e_port))
        assert abs(e_jax - e_port) <= FMA_BAND * max(e_jax, e_port), (
            "block %d parts from JAX at step %d beyond a near-tie: "
            "errors %.7g (JAX's choice) vs %.7g (port's)"
            % (b, t, e_jax, e_port))
    for b, t, ej, ep in flipped:
        print("near-tie: block %d step %d errors %.7g (JAX) %.7g (port)"
              % (b, t, ej, ep))
    assert len(flipped) <= 0.1 * len(rows), flipped


def test_fused_equals_staged_on_cpu(setup):
    """fused=True (kernel B's wrapper) and fused=False (the staged loop
    through kernel A's wrapper) give the same CSR; on CPU tensors both
    wrappers run their plain versions and launch nothing."""
    cand, aux = _few_candidates(*setup, k=40)
    before = dict(zl.launches)
    a = _port_csr(cand, aux, np.float32(1.5), None, False, fused=True)
    b = _port_csr(cand, aux, np.float32(1.5), None, False, fused=False)
    _assert_csr_equal(a, b)
    assert zl.launches == before


def test_row_argsort_equivalence():
    """_argsort_rows_stable (torch at >= 16384 rows) equals numpy's stable
    row argsort, +inf ties and duplicates included."""
    rng = np.random.default_rng(11)
    scores = rng.standard_normal((20000, 192)).astype(np.float32)
    mask = rng.random(scores.shape) < 0.6
    scores[mask] = np.inf
    scores[~mask] = np.round(scores[~mask], 1)
    np.testing.assert_array_equal(tz._argsort_rows_stable(scores),
                                  np.argsort(scores, axis=1, kind="stable"))


def test_candidate_scores_match_jax():
    rng = np.random.default_rng(12)
    blocks = rng.integers(-20, 21, (30, 3, 64)).astype(np.int32)
    orig = rng.integers(-200, 201, (30, 3, 64)).astype(np.int32)
    for new_model in (True, False):
        for mask in (7, 1, 6):
            np.testing.assert_array_equal(
                tz.candidate_scores_host(blocks, orig, mask, new_model),
                jz.candidate_scores_host(blocks, orig, mask, new_model))
