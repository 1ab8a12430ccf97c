"""The port's device-resident back-end state with sparse coefficient
deltas (Comparator.backend_sync_full, dispatch_compare_sparse_coeffs,
dispatch_compare_sparse), the 4:4:4 back end's default route, on the
CPU, one torch thread:

  * a seeded wave of 500 flips, unchunked and through scatter-only
    chunks (tiny sizes, as tests/test_sparse_chunks.py sets them for the
    JAX package), equals a full compare of the same host state bit for
    bit: distance and [4, NB] weights; so does the per-block form;
  * default encodes equal encodes with the whole-plane back end (forced
    by a Comparator.supports_sparse that says no) byte for byte, with
    the native flip loop's triplets and with the triplets rebuilt after
    the Python flip loop; the lockstep corpus on 3 threads equals
    serial;
  * an out-of-memory error in a sparse fetch is replayed (the resident
    state re-synced from the host image) with the same bytes; a sticky
    CUDA error propagates.
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, consts, native, runtime
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                process_rgb)

PNGS = ("bees96x64.png", "bees97x63.png")
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"
STICKY = "CUDA error: an illegal memory access was encountered"


def _flipped(name, m=500, seed=3):
    """(rgb, w, h, image before, image after, blocks, c*64+k, values):
    m seeded coefficients of the encoder's first image set to 0."""
    rgb, w, h = read_png((FIXTURES / name).read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    before = img.copy()
    rng = np.random.RandomState(seed)
    nb = img.bw * img.bh
    key = np.unique(rng.randint(0, nb, m) * 192 + rng.randint(0, 3, m) * 64
                    + rng.randint(1, 64, m))
    bs, cks = key // 192, key % 192
    for c in range(3):
        sel = (cks >> 6) == c
        img.comps[c].coeffs[bs[sel], cks[sel] & 63] = 0
    return (rgb, w, h, before, img, bs, cks,
            np.zeros(len(key), np.int32))


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("name", PNGS)
def test_sparse_wave_equals_full_compare(name, chunk, monkeypatch):
    rgb, w, h, before, img, bs, cks, vals = _flipped(name)
    comp = cmp_mod.Comparator(rgb, w, h, 1.0, "cpu")
    assert comp.supports_sparse(img, 7) and not comp.supports_sparse(img, 1)
    comp.backend_sync_full(before)
    scatters = []
    real = cmp_mod.Comparator._scatter
    monkeypatch.setattr(cmp_mod.Comparator, "_scatter",
                        lambda self, i, v: scatters.append(len(i))
                        or real(self, i, v))
    if chunk:
        monkeypatch.setattr(cmp_mod.Comparator, "_SPARSE_COEFF_TOP", chunk)
        monkeypatch.setattr(cmp_mod.Comparator, "_SPARSE_COEFF_CHUNK",
                            chunk)
    got = comp.fetch_compare(comp.dispatch_compare_sparse_coeffs(
        img, bs, cks, vals, 1, 1.0, 1, 1))
    ref = cmp_mod.Comparator(rgb, w, h, 1.0, "cpu")
    want = ref.fetch_compare(ref.dispatch_compare_with_weights(img, 1, 1.0,
                                                               1, 1))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert sum(scatters) == len(bs)
    if chunk:
        assert max(scatters) <= chunk and len(scatters) == -(-len(bs)
                                                              // chunk)
    else:
        assert scatters == [len(bs)]
    np.testing.assert_array_equal(comp._dev_coeffs.numpy(), img.coeffs)
    # The per-block form from the same starting state.
    comp.backend_sync_full(before)
    got = comp.fetch_compare(comp.dispatch_compare_sparse(
        img, np.unique(bs), -1, 1.0, 1, 1))
    want = comp.fetch_compare(comp.dispatch_compare_with_weights(
        img, -1, 1.0, 1, 1))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def _encode(data, stats=None):
    return api.encode_bytes(data, 95, stats=stats, device="cpu")


def _dense(monkeypatch):
    """The whole-plane back end: no comparator takes the resident
    state."""
    monkeypatch.setattr(cmp_mod.Comparator, "supports_sparse",
                        lambda self, img, comp_mask: False)


@pytest.mark.parametrize("name", PNGS)
def test_sparse_encode_keeps_the_bytes(name, monkeypatch):
    data = (FIXTURES / name).read_bytes()
    calls = []
    real = cmp_mod.Comparator.dispatch_compare_sparse_coeffs
    monkeypatch.setattr(cmp_mod.Comparator, "dispatch_compare_sparse_coeffs",
                        lambda self, *a: calls.append(1) or real(self, *a))
    with pytest.MonkeyPatch.context() as m:
        _dense(m)
        plain = _encode(data)
    assert not calls
    stats = ProcessStats()
    assert _encode(data, stats) == plain
    assert len(calls) == stats.counters["backend_iters"] > 0


def test_sparse_with_the_python_flip_loop(monkeypatch):
    """Without the native library the triplets are rebuilt from the
    last_indexes deltas: the same bytes (a 48x40 crop keeps the Python
    paths cheap)."""
    rgb, _w, _h = read_png((FIXTURES / PNGS[0]).read_bytes())
    sub = np.ascontiguousarray(rgb[:40, :48])
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.MonkeyPatch.context() as m:
        _dense(m)
        want = process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")
    assert process_rgb(params, sub, 48, 40, ProcessStats(), "cpu") == want


def test_sparse_lockstep_corpus_equals_serial():
    corpus = [(n, (FIXTURES / n).read_bytes()) for n in PNGS]
    with pytest.MonkeyPatch.context() as m:
        _dense(m)
        serial = {n: _encode(d) for n, d in corpus}
    assert dict(lockstep.encode_corpus_lockstep(corpus, 95, threads=3,
                                                device="cpu")) == serial


def _fail(monkeypatch, exc, calls):
    real = cmp_mod.Comparator.fetch_compare
    n = [0]

    def wrapped(self, handle):
        n[0] += 1
        if n[0] in calls:
            assert handle[3][5], "a sparse handle"
            raise exc
        return real(self, handle)
    monkeypatch.setattr(cmp_mod.Comparator, "fetch_compare", wrapped)
    return n


def test_oom_in_a_sparse_fetch_is_replayed(monkeypatch):
    data = (FIXTURES / PNGS[0]).read_bytes()
    want = _encode(data)
    released, syncs = [], []
    monkeypatch.setattr(runtime, "release_memory",
                        lambda device, what: released.append(what))
    real_sync = cmp_mod.Comparator.backend_sync_full
    monkeypatch.setattr(cmp_mod.Comparator, "backend_sync_full",
                        lambda self, img: syncs.append(1)
                        or real_sync(self, img))
    n = _fail(monkeypatch, torch.cuda.OutOfMemoryError(OOM), {2, 5, 6})
    stats = ProcessStats()
    assert _encode(data, stats) == want
    assert stats.search_error is None
    # One sync per pass, one per replay.
    assert len(released) == 3 and len(syncs) == 1 + 3 and n[0] > 6


def test_sticky_error_in_a_sparse_fetch_propagates(monkeypatch):
    _fail(monkeypatch, RuntimeError(STICKY), {3})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _encode((FIXTURES / PNGS[0]).read_bytes())
