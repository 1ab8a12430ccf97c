"""The compare graphs shared across comparators by geometry
(guetzli_tpu_torch/compare_graphs.py's per-device cache).

On the CPU with a stub in place of torch.cuda.CUDAGraph: its replay
runs the captured closure again on the static buffers, so a graph that
kept the capturing comparator's image in its closure instead of taking
it as an input gives that image's results to every comparator that
replays it. Two images of one geometry (4:4:4 and 4:2:0): the second
comparator replays the first's graphs from its first compare, and each
gets its own eager results bit for bit; 48x40 against 40x48: two keys,
two captures; the first compare eager only at a new geometry; the byte
cap's evictions; the cache emptied by a recovery and by
runtime.release_memory; threads replaying one entry.

On the card (`gpu` marker; --noconftest, as the card has no JAX): two
images of one geometry and a transposed one with real CUDA graphs, each
comparator's results equal to its own eager chain bit for bit.
"""

import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import compare_graphs, comparator, runtime
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search import state as st

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
C = compare_graphs


@pytest.fixture(autouse=True)
def _no_cached_graphs():
    """Each test starts with no graph cached and no geometry warm, and
    leaves none (xdist runs a file's tests in one process)."""
    C._caches.clear()
    yield
    C._caches.clear()


class StubGraph:
    """Capture runs the chain once; replay runs it again on the same
    static inputs and writes the same output tensors, as a CUDA graph
    does."""

    def __init__(self, device, pool):
        self.fn = self.outs = None

    @staticmethod
    def new_pool(device):
        return None

    def capture(self, fn):
        self.fn = fn
        self.outs = fn()
        return self.outs

    def replay(self):
        for out, new in zip(self.outs, self.fn()):
            out.copy_(new)


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(C.CompareGraphs, "graph_class", StubGraph)


def _rgb(w, h, x0=0, y0=0):
    rgb, fw, fh = read_png((REPO / "tests/fixtures/bees96x64.png")
                           .read_bytes())
    rgb = np.asarray(rgb, np.uint8).reshape(fh, fw, 3)
    return np.ascontiguousarray(rgb[y0:y0 + h, x0:x0 + w])


def _coeff_image(rgb, w, h, kind="444", quant=5):
    jpg = encode_rgb_to_jpeg(rgb, w, h, quant=np.full((3, 64), quant,
                                                      np.int32))
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    if kind == "420":
        img.downsample()
    return img


def _comp(rgb, w, h, device=CPU, graphs=True):
    comp = comparator.Comparator(rgb, w, h, 1.0, device, padded=False,
                                 mesh=False)
    comp._graphs.enabled = graphs
    return comp


def _dispatch_all(comp, img):
    """Every form: two plain compares, waves of 2, 2 and 3, two compares
    with weights and, for 4:4:4, two of the resident state: [(results
    ...)] per dispatch."""
    out = [comp.dispatch_compare(img) for _ in range(2)]
    base = comp.quant_base_upload(img)
    qs = [np.full(192, q, np.int32) for q in (2, 3, 4, 5, 6)]
    for chunk in (qs[:2], qs[2:4], qs[2:5]):
        out.append(comp.dispatch_quant_batch(base, chunk)[:1])
    for d, tm in ((1, 1.0), (-1, 0.97)):
        out.append(comp.dispatch_compare_with_weights(img, d, tm, 1, 1)[:3])
    if img.is_444():
        comp.backend_sync_full(img)
        for _ in range(2):
            out.append(comp.dispatch_compare_sparse(img, [0, 1], 1, 1.0, 1,
                                                    1)[:3])
    return out


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y.cpu())


def _total(counters):
    return sum(counters.get(k, 0) for k in C.COUNTERS)


def _modes(counters):
    """The dispatch and cache counters: all but the upload bytes."""
    return {k: v for k, v in counters.items() if k != C.UPLOAD_BYTES}


@pytest.mark.parametrize("kind", ["444", "420"])
def test_one_geometry_shares_and_each_keeps_its_results(stub_graphs, kind):
    """Two images of one size: the second comparator replays every graph
    the first captured, from its first compare, and both get the
    results of their own eager chains."""
    w, h = 48, 40
    rgbs = [_rgb(w, h), _rgb(w, h, 40, 20)]
    imgs = [_coeff_image(r, w, h, kind) for r in rgbs]
    want = [_dispatch_all(_comp(r, w, h, graphs=False), im)
            for r, im in zip(rgbs, imgs)]
    first, second = (_comp(r, w, h) for r in rgbs)
    _assert_equal(_dispatch_all(first, imgs[0]), want[0])
    n = _total(first.counters)
    assert first.counters[C.EAGER] == 1
    assert C.SHARED not in first.counters
    got = _dispatch_all(second, imgs[1])
    _assert_equal(got, want[1])
    assert _modes(second.counters) == {C.REPLAYS: n, C.SHARED: n}
    assert not all(torch.equal(a[0], b[0]) for a, b in zip(got, want[0]))
    assert second._graphs.keys() == first._graphs.keys()


@pytest.mark.parametrize("kind", ["444", "420"])
def test_transposed_sizes_are_two_keys(stub_graphs, kind):
    """48x40 and 40x48 have 4:4:4 planes of one shape ([3, 30, 64]); each
    is its own geometry: its own eager compare, its own capture."""
    comps, imgs = [], []
    for w, h in ((48, 40), (40, 48)):
        rgb = _rgb(w, h)
        imgs.append(_coeff_image(rgb, w, h, kind))
        comps.append(_comp(rgb, w, h))
        want = _comp(rgb, w, h, graphs=False).compare_img(imgs[-1])
        assert [comps[-1].compare_img(imgs[-1]) for _ in range(3)] == \
            [want] * 3
    for comp in comps:
        assert _modes(comp.counters) == {C.EAGER: 1, C.CAPTURES: 1,
                                         C.REPLAYS: 1}
        assert len(comp._graphs.keys()) == 1
    assert len(C._cache(CPU).entries) == 2
    if kind == "444":
        assert imgs[0].coeffs.shape == imgs[1].coeffs.shape


def test_first_compare_eager_only_at_a_new_geometry(stub_graphs):
    w, h = 48, 40
    a = _comp(_rgb(w, h), w, h)
    img = _coeff_image(_rgb(w, h), w, h)
    a.compare_img(img)
    a.compare_img(img)
    b_rgb = _rgb(w, h, 8, 8)
    b_img = _coeff_image(b_rgb, w, h)
    b = _comp(b_rgb, w, h)
    assert b.compare_img(b_img) == \
        _comp(b_rgb, w, h, graphs=False).compare_img(b_img)
    assert _modes(b.counters) == {C.REPLAYS: 1, C.SHARED: 1}
    # A key no comparator captured at a warm geometry: captured at once.
    b.fetch_quant_scores(b.dispatch_quant_batch(
        b.quant_base_upload(b_img), [np.full(192, 3, np.int32)]))
    assert b.counters[C.CAPTURES] == 1 and C.EAGER not in b.counters
    c = _comp(_rgb(40, 40), 40, 40)
    c.compare_img(_coeff_image(_rgb(40, 40), 40, 40))
    assert _modes(c.counters) == {C.EAGER: 1}


def test_byte_cap_evicts_the_least_recently_used(stub_graphs, monkeypatch):
    sizes = ((48, 40), (40, 48), (40, 40))
    comps, imgs = [], []
    for w, h in sizes:
        comps.append(_comp(_rgb(w, h), w, h))
        imgs.append(_coeff_image(_rgb(w, h), w, h))
    for comp, img in zip(comps[:2], imgs[:2]):
        comp.compare_img(img)
        comp.compare_img(img)
    cache = C._cache(CPU)
    first, second = (e.bytes for e in cache.entries.values())
    assert first > 0 and second > 0
    monkeypatch.setattr(C, "MAX_BYTES", first + second)
    comps[0].compare_img(imgs[0])          # 48x40 now the most recent
    comps[2].compare_img(imgs[2])
    comps[2].compare_img(imgs[2])          # captures; evicts 40x48
    assert comps[2].counters[C.EVICTIONS] == 1
    assert comps[0]._graphs.keys() and comps[2]._graphs.keys()
    assert not comps[1]._graphs.keys()
    assert cache.bytes == sum(e.bytes for e in cache.entries.values()) \
        <= C.MAX_BYTES
    want = _comp(_rgb(40, 48), 40, 48, graphs=False).compare_img(imgs[1])
    assert comps[1].compare_img(imgs[1]) == want
    assert comps[1].counters[C.CAPTURES] == 2     # warm: no eager run
    assert comps[1].counters[C.EVICTIONS] == 1


@pytest.mark.parametrize("release", ["recover_device_state",
                                     "release_memory"])
def test_recovery_empties_the_cache(stub_graphs, release):
    comps, imgs = [], []
    for w, h in ((48, 40), (40, 48)):
        comps.append(_comp(_rgb(w, h), w, h))
        imgs.append(_coeff_image(_rgb(w, h), w, h))
        comps[-1].compare_img(imgs[-1])
        want = comps[-1].compare_img(imgs[-1])
    assert len(C._cache(CPU).entries) == 2
    if release == "recover_device_state":
        comps[0].recover_device_state()
    else:
        runtime.release_memory(CPU, "a test")
    cache = C._cache(CPU)
    assert not cache.entries and cache.bytes == 0
    assert comps[1].compare_img(imgs[1]) == want
    assert comps[1].counters[C.CAPTURES] == 2


def test_threads_replaying_one_entry_keep_their_results(stub_graphs):
    """Four comparators of one size on four threads, each replaying the
    one shared graph 6 times: every result is its own image's."""
    w, h = 48, 40
    rgbs = [_rgb(w, h, 8 * i, 4 * i) for i in range(4)]
    imgs = [_coeff_image(r, w, h) for r in rgbs]
    want = [_comp(r, w, h, graphs=False).compare_img(im)
            for r, im in zip(rgbs, imgs)]
    assert len(set(want)) == 4
    comps = [_comp(r, w, h) for r in rgbs]
    for _ in range(2):
        comps[0].compare_img(imgs[0])
    got = [[] for _ in comps]

    def work(i):
        for _ in range(6):
            got[i].append(comps[i].compare_img(imgs[i]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for i, comp in enumerate(comps):
        assert got[i] == [want[i]] * 6
    assert len(C._cache(CPU).entries) == 1
    assert sum(c.counters.get(C.SHARED, 0) for c in comps) == 18


# -- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_shared_graphs_on_card():
    """Real CUDA graphs: two images of one size and a transposed one,
    4:4:4 and 4:2:0; each comparator's results are its own eager
    chain's, the second of one size replaying the first's graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    dev = torch.device("cuda")
    rgb, fw, fh = read_png((REPO / "tests/corpus/photo_hopper.png")
                           .read_bytes())
    rgb = np.asarray(rgb, np.uint8).reshape(fh, fw, 3)
    for kind in ("444", "420"):
        C._caches.clear()     # each kind starts at new geometries
        for w, h, x0, y0 in ((160, 120, 0, 0), (160, 120, 200, 300),
                             (120, 160, 40, 100)):
            crop = np.ascontiguousarray(rgb[y0:y0 + h, x0:x0 + w])
            img = _coeff_image(crop, w, h, kind)
            want = _dispatch_all(_comp(crop, w, h, dev, graphs=False), img)
            comp = _comp(crop, w, h, dev)
            _assert_equal(_dispatch_all(comp, img), want)
            shared = (w, h, x0) == (160, 120, 200)
            assert (C.EAGER in comp.counters) != shared
            assert comp.counters.get(C.SHARED, 0) == (
                _total(comp.counters) if shared else 0)
