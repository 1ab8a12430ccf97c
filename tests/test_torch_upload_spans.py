"""The input_decode and compare_upload spans and the compare_upload_bytes
counter (spans.py, compare_graphs.uploading) on the CPU.

  * one compare's counter reads the bytes of the host arrays it copies
    to the device: a 4:2:0 back-end compare its Y, U and V planes, a
    wave its matrices, the quant base its planes, the resident state's
    full upload its planes and a sparse 4:4:4 compare its (index,
    value) pairs, 12 bytes a coefficient; the image's device state
    counts nothing. The same eagerly and through graphs (a stub that
    reruns the captured chain);
  * compare_upload nests in compare_dispatch;
  * every serial encode's timings hold both spans, and a lockstep
    batch's phase walls; the counter reaches ProcessStats.counters and
    the corpus driver's counters; under torch.profiler both are
    "phase.<name>" events, and the bytes do not change.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.conftest import FIXTURES
from tests.test_torch_compare_graphs import (CPU, StubGraph, _coeff_image,
                                             _image)
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, compare_graphs, comparator
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search.processor import ProcessStats

UPLOAD, BYTES = compare_graphs.UPLOAD, compare_graphs.UPLOAD_BYTES
SPANS = (UPLOAD, "input_decode")
JPEG = (FIXTURES.parent / "corpus" / "bees_d-420.jpg").read_bytes()
PNG = (FIXTURES / "bees96x64.png").read_bytes()


@pytest.fixture(autouse=True)
def _no_cached_graphs():
    compare_graphs._caches.clear()
    yield
    compare_graphs._caches.clear()


def _comp(monkeypatch, graphs):
    """A comparator of the 48x40 crop, eager or on stub graphs, with its
    spans on a dict of its own."""
    rgb, w, h = _image()
    if graphs:
        monkeypatch.setattr(compare_graphs.CompareGraphs, "graph_class",
                            StubGraph)
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    comp._graphs.enabled = graphs
    comp.timings = {}
    return comp, rgb, w, h


def _bytes_of(comp, fn):
    """(fn()'s result, the upload bytes it added)."""
    before = comp.counters.get(BYTES, 0)
    out = fn()
    return out, comp.counters.get(BYTES, 0) - before


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_420_back_end_compare_uploads_its_planes(monkeypatch, graphs):
    comp, rgb, w, h = _comp(monkeypatch, graphs)
    img = _coeff_image(rgb, w, h)
    img.downsample()
    y, u, v = (c.coeffs for c in img.comps)
    # Graphs: an eager compare at the new geometry, a capture, replays.
    for _ in range(3 if graphs else 1):
        _out, n = _bytes_of(comp, lambda: comp.fetch_compare(
            comp.dispatch_compare_with_weights(img, 1, 1.0, 1, 1)))
    assert n == y.nbytes + u.nbytes + v.nbytes
    if graphs:
        assert compare_graphs.REPLAYS in comp.counters
    assert 0 < comp.timings[UPLOAD] <= comp.timings["compare_dispatch"]


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_a_wave_uploads_its_base_once_and_its_matrices(monkeypatch,
                                                       graphs):
    comp, rgb, w, h = _comp(monkeypatch, graphs)
    img = _coeff_image(rgb, w, h)
    base, n = _bytes_of(comp, lambda: comp.quant_base_upload(img))
    assert n == img.coeffs.nbytes
    comp.compare_img(img)
    qs = [np.full(192, q, np.int32) for q in (2, 3, 4)]
    for _ in range(2 if graphs else 1):
        _s, n = _bytes_of(comp, lambda: comp.fetch_quant_scores(
            comp.dispatch_quant_batch(base, qs)))
    assert n == len(qs) * 192 * 4


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_sparse_444_compare_uploads_its_triplets(monkeypatch, graphs):
    comp, rgb, w, h = _comp(monkeypatch, graphs)
    img = _coeff_image(rgb, w, h)
    _none, n = _bytes_of(comp, lambda: comp.backend_sync_full(img))
    assert n == img.coeffs.nbytes == 3 * img.bw * img.bh * 64 * 4
    blocks = np.array([0, 1, 5, 7], np.int64)
    cks = np.array([1, 64 + 3, 128 + 9, 2], np.int64)
    vals = np.array([0, 1, -1, 0], np.int32)
    for _ in range(3 if graphs else 1):
        _out, n = _bytes_of(comp, lambda: comp.fetch_compare(
            comp.dispatch_compare_sparse_coeffs(img, blocks, cks, vals, 1,
                                                1.0, 1, 1)))
        assert n == 12 * len(blocks)
    # The per-block form: the rows' indexes and the blocks' 192 values.
    _out, n = _bytes_of(comp, lambda: comp.fetch_compare(
        comp.dispatch_compare_sparse(img, [2, 3], 1, 1.0, 1, 1)))
    assert n == 2 * 8 + 3 * 2 * 64 * 4


def _encodes():
    """Serial encodes of the JPEG and the PNG: [(bytes, stats)]."""
    out = []
    for data in (JPEG, PNG):
        stats = ProcessStats()
        out.append((api.encode_bytes(data, 95, stats=stats, device="cpu"),
                    stats))
    return out


@pytest.fixture(scope="module")
def untraced():
    walls, counters = {}, {}
    res = lockstep.encode_corpus_lockstep(
        [("jpeg", JPEG), ("png", PNG)], 95, phase_walls=walls,
        counters=counters, device="cpu")
    return _encodes(), dict(res), walls, counters


@pytest.fixture(scope="module")
def traced():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _encodes()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return res, names


def test_every_encode_holds_both_spans(untraced):
    serial, _res, _walls, _counters = untraced
    for _out, stats in serial:
        t = stats.timings
        assert all(t[k] >= 0.0 for k in SPANS)
        assert 0.0 < t["input_decode"] <= t["image_setup"]
        assert t[UPLOAD] <= t["compare_dispatch"]
        assert stats.counters[BYTES] > 0


def test_the_lockstep_walls_and_counters(untraced):
    serial, res, walls, counters = untraced
    assert all(walls[k] >= 0.0 for k in SPANS)
    assert 0.0 < walls["input_decode"] <= walls["image_setup"]
    assert 0.0 < walls[UPLOAD] <= walls["compare_dispatch"]
    assert counters[BYTES] > 0
    assert res["jpeg"] == serial[0][0] and res["png"] == serial[1][0]


def test_profiler_sees_both_and_no_byte_moves(untraced, traced):
    (res, names), serial = traced, untraced[0]
    for name in SPANS:
        assert "phase." + name in names, name
    assert [out for out, _st in res] == [out for out, _st in serial]
    assert [st.counters[BYTES] for _out, st in res] == \
        [st.counters[BYTES] for _out, st in serial]


def test_uploading_adds_bytes_and_takes_no_dicts():
    timings, counters = {}, {}
    with compare_graphs.uploading(timings, counters, 96):
        torch.zeros(4)
    with compare_graphs.uploading(timings, counters, 4):
        pass
    with compare_graphs.uploading(None, None, 7):
        pass
    assert counters == {BYTES: 100} and list(timings) == [UPLOAD]
    assert compare_graphs.host_bytes(
        (np.zeros(3, np.int64), torch.zeros(5), np.zeros((2, 2),
                                                         np.int32))) == 40
