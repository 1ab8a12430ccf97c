"""The comparator's compare graphs (guetzli_tpu_torch/compare_graphs.py)
and the device constants they rely on (ops/devconst.py).

On the CPU, with a stub in place of torch.cuda.CUDAGraph (it runs the
chain again on the static buffers at each replay): the capture rule
(the first compare at a new geometry eager, then a capture on each
key's first use and replays after it), the keys of the four forms, the
counters, the cache dropped by a recovery, handles in flight that keep
their own results, and no graph at all on the CPU by default; and every
cached device constant equal to the array its per-call upload made.
(tests/test_torch_shared_graphs.py: the cache shared across
comparators.)

On the card (`gpu` marker; run with --noconftest, as the card has no
JAX): a 4:4:4 PNG crop, a 4:2:0 JPEG and a lockstep batch of four
thumbnails encoded with graphs and eagerly, every compare's outputs,
final_distance and the bytes equal bit for bit; api.encode_corpus with
two threads; two waves of one size in flight; a recovery.
"""

import gc
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from guetzli_tpu_torch import compare_graphs, comparator, runtime
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.ops import blur, devconst, diffmap
from guetzli_tpu_torch.search import state as st

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_cached_graphs():
    """Each test starts with no graph cached and no geometry warm, and
    leaves none (xdist runs a file's tests in one process)."""
    compare_graphs._caches.clear()
    yield
    compare_graphs._caches.clear()


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


def _image(w=48, h=40):
    rgb, fw, fh = read_png((REPO / "tests/fixtures/bees96x64.png")
                           .read_bytes())
    rgb = np.asarray(rgb, np.uint8).reshape(fh, fw, 3)[:h, :w].copy()
    return rgb, w, h


def _coeff_image(rgb, w, h, quant=5):
    jpg = encode_rgb_to_jpeg(rgb, w, h, quant=np.full((3, 64), quant,
                                                      np.int32))
    st.remove_original_quantization(jpg)
    return st.CoeffImage.from_jpeg(jpg)


def _graphed(monkeypatch, graph_class=StubGraph):
    """Comparators made from now on capture (with a stub) on the CPU."""
    monkeypatch.setattr(compare_graphs.CompareGraphs, "graph_class",
                        graph_class)
    init = comparator.Comparator.__init__

    def graphed_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._graphs.enabled = True
    monkeypatch.setattr(comparator.Comparator, "__init__", graphed_init)


def _forms(comp):
    return {k[1] for k in comp._graphs.keys()}


def _total(counters):
    return sum(counters.get(k, 0) for k in compare_graphs.COUNTERS)


def _modes(counters):
    """The dispatch and cache counters: all but the upload bytes."""
    return {k: v for k, v in counters.items()
            if k != compare_graphs.UPLOAD_BYTES}


def _dispatch_all(comp, img, img2):
    """Every form once or more, in the order the test of the capture rule
    reads: [(results...)] per dispatch."""
    out = []
    for im in (img, img, img2):                              # plain x3
        out.append(comp.dispatch_compare(im))
    base = comp.quant_base_upload(img)
    qs = [np.full(192, q, np.int32) for q in (2, 3, 4, 5, 6)]
    for chunk in (qs[:2], qs[2:4], qs[2:5]):                 # waves 2, 2, 3
        out.append(comp.dispatch_quant_batch(base, chunk)[:1])
    for d, tm in ((1, 1.0), (1, 1.0), (-1, 0.97)):           # weights
        out.append(comp.dispatch_compare_with_weights(img, d, tm, 1, 1)[:3])
    comp.backend_sync_full(img)
    for _ in range(2):                                       # resident
        out.append(comp.dispatch_compare_sparse(img, [0, 1], 1, 1.0, 1,
                                                1)[:3])
    return out


def test_no_graph_on_the_cpu():
    rgb, w, h = _image()
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    img = _coeff_image(rgb, w, h)
    _dispatch_all(comp, img, _coeff_image(rgb, w, h, 7))
    assert not comp._graphs.enabled and not comp._graphs.keys()
    assert _modes(comp.counters) == {compare_graphs.EAGER: 11}


def test_capture_rule_keys_and_counts(monkeypatch):
    rgb, w, h = _image()
    img, img2 = _coeff_image(rgb, w, h), _coeff_image(rgb, w, h, 7)
    eager = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                  mesh=False)
    want = _dispatch_all(eager, img, img2)
    _graphed(monkeypatch)
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    got = _dispatch_all(comp, img, img2)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # plain: eager, capture, replay (same shapes); waves: capture B=2,
    # replay, capture B=3; compare + weights: the plain graph's replay
    # and a capture of the weights, replays, a capture of the weights of
    # another direction and target; resident: the plain graph (the state
    # copied into its input) and the first weights' graph, replays.
    assert _modes(comp.counters) == {compare_graphs.EAGER: 1,
                                     compare_graphs.CAPTURES: 5,
                                     compare_graphs.REPLAYS: 5}
    assert _forms(comp) == {"plain", "quant", "weights"}
    assert len(comp._graphs.keys()) == 5
    assert _total(comp.counters) == 11


def test_recovery_drops_the_graphs(monkeypatch):
    _graphed(monkeypatch)
    rgb, w, h = _image()
    img = _coeff_image(rgb, w, h)
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    first = [comp.compare_img(img) for _ in range(3)]
    assert len(comp._graphs.keys()) == 1
    comp.recover_device_state()
    assert not comp._graphs.keys()
    assert comp.compare_img(img) == first[0]
    assert comp.counters[compare_graphs.CAPTURES] == 2
    # A comparator of the same geometry replays comp's graph from its
    # first compare; after the release its next compare captures (the
    # geometry stays warm).
    other = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                  mesh=False)
    other.compare_img(img)
    other.compare_img(img)
    assert other._graphs.keys()
    runtime.release_memory(CPU, "a test")
    assert not other._graphs.keys() and not comp._graphs.keys()
    assert other.compare_img(img) == first[0]
    assert _modes(other.counters) == {compare_graphs.REPLAYS: 2,
                                      compare_graphs.SHARED: 2,
                                      compare_graphs.CAPTURES: 1}


def test_one_pool_serves_every_comparator(monkeypatch):
    """The comparators' graphs share the device's pool, which stays open
    between images until a recovery closes it."""
    handles = []

    class PooledStub(StubGraph):
        @staticmethod
        def new_pool(device):
            handles.append(object())
            return handles[-1]
    _graphed(monkeypatch, PooledStub)
    compare_graphs.drop_all(CPU)
    pool = compare_graphs._pool(CPU)
    rgb, w, h = _image()
    img = _coeff_image(rgb, w, h)
    for _ in range(2):
        comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                     mesh=False)
        for _ in range(3):
            comp.compare_img(img)
        del comp
        gc.collect()
    assert pool.handle is handles[0] and len(handles) == 1
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    for _ in range(2):
        comp.compare_img(img)
    comp.recover_device_state()
    assert pool.handle is handles[0]
    runtime.release_memory(CPU, "a test")
    assert pool.handle is None and pool.bytes == 0
    comp.compare_img(img)
    assert pool.handle is handles[1]


def test_handles_in_flight_keep_their_results(monkeypatch):
    rgb, w, h = _image()
    img = _coeff_image(rgb, w, h)
    qs = [[np.full(192, q, np.int32) for q in qq]
          for qq in ((2, 9), (3, 8), (4, 7))]
    eager = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                  mesh=False)
    base = eager.quant_base_upload(img)
    want = [eager.fetch_quant_scores(eager.dispatch_quant_batch(base, q))
            for q in qs]
    _graphed(monkeypatch)
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    comp.compare_img(img)
    base = comp.quant_base_upload(img)
    handles = [comp.dispatch_quant_batch(base, q) for q in qs]
    got = [comp.fetch_quant_scores(hd) for hd in handles]
    assert comp.counters[compare_graphs.REPLAYS] == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len({tuple(g) for g in got}) == 3


def test_an_encode_gives_the_eager_bytes(monkeypatch):
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_rgb)
    rgb, w, h = _image(40, 40)
    want = process_rgb(Params(), rgb, w, h, ProcessStats(), CPU)
    _graphed(monkeypatch)
    stats = ProcessStats()
    assert process_rgb(Params(), rgb, w, h, stats, CPU) == want
    n = _total(stats.counters)
    assert stats.counters[compare_graphs.EAGER] == 1
    assert stats.counters[compare_graphs.REPLAYS] > n // 2


# -- the device constants ------------------------------------------------

def _res_positions(size, step, margin):
    n = (size - margin - 1) // step + 1 if size > margin else 0
    return np.arange(n, dtype=np.int64) * step


def _old_uploads(h, w, step=3):
    """The arrays the chain uploaded on every call before the cache
    (diffmap.py's former inline code), by cache key."""
    from guetzli_tpu_torch import consts
    out = {}
    xs, ys = np.arange(w), np.arange(h)
    h_ok = (xs >= 3) & (xs + 3 < w)
    v_ok = (ys >= 3) & (ys + 3 < h)
    px = np.minimum(_res_positions(w, step, 8 - step), w - 8)
    py = np.minimum(_res_positions(h, step, 8 - step), h - 8)
    em = []
    cnt = np.zeros((len(py), len(px)), dtype=np.float32)
    for oy, ox in ((0, 0), (7, 0), (0, 7), (7, 7)):
        gy, gx = py + oy, px + ox
        hv = np.repeat(h_ok[gx][None, :], len(py), axis=0)
        vv = np.repeat(v_ok[gy][:, None], len(px), axis=1)
        em += [gy[:, None], gx[None, :], hv, vv]
        cnt = cnt + hv + vv
    em.append(np.float32(consts.EDGE_DETECTOR_WEIGHT) * np.float32(8.0)
              / cnt)
    out["edge_detector_map"] = em
    bx = np.minimum(_res_positions(w, step, 8 - step - 1), w - 8)
    by = np.minimum(_res_positions(h, step, 8 - step - 1), h - 8)
    out["block_diff_map"] = [(by[:, None] + np.arange(8)[None, :]).ravel(),
                             (bx[:, None] + np.arange(8)[None, :]).ravel()]
    ly, lx = _res_positions(h, step, 8), _res_positions(w, step, 8)
    out["edge_detector_low_freq"] = [
        ly[:, None], (ly + 8)[:, None], (ly + 6)[:, None], lx[None, :],
        (lx + 8)[None, :], (lx + 6)[None, :],
        np.maximum(lx - 6, 0)[None, :], (lx < 8)[None, None, :]]
    out["combine_channels"] = [_res_positions(h, step, 8 - step) + 3,
                               _res_positions(w, step, 8 - step) + 3]
    return out


@pytest.mark.parametrize("lane_safe", ["0", "1"])
@pytest.mark.parametrize("size", [(40, 36), (97, 63)])
def test_device_constants_equal_the_uploads(monkeypatch, size, lane_safe):
    monkeypatch.setenv("GUETZLI_TPU_LANE_SAFE", lane_safe)
    devconst.clear()
    w, h = size
    rgb = np.random.default_rng(w).integers(0, 256, (h, w, 3), np.uint8)
    comp = comparator.Comparator(rgb, w, h, 1.0, CPU, padded=False,
                                 mesh=False)
    comp.compare_img(_coeff_image(rgb, w, h))
    old = _old_uploads(h, w)
    cached = {k[0][0]: v for k, (v, _n) in devconst._cache.items()
              if k[0][0] in old and k[0][1:3] == (h, w)}
    for name, arrays in old.items():
        got = cached[name]
        assert len(got) == len(arrays), name
        for t, a in zip(got, arrays):
            assert t.dtype == torch.as_tensor(a).dtype, name
            np.testing.assert_array_equal(t.numpy(), a)
    borders = [k for k in devconst._cache if k[0][0] == "blur_border"]
    assert len(borders) >= 8
    for k in borders:
        np.testing.assert_array_equal(devconst._cache[k][0].numpy(),
                                      blur._border_weights(*k[0][1:]))
    mats = [k for k in devconst._cache if k[0][0] == "upsample_matrix"]
    assert bool(mats) == (lane_safe == "1")
    for k in mats:
        dw, ww, step = k[0][1:]
        np.testing.assert_array_equal(devconst._cache[k][0].numpy(),
                                      blur._upsample_matrix(dw, ww, step))
    for k, (v, _n) in devconst._cache.items():
        if k[0][0] == "scalar":
            assert v.dim() == 0 and v.dtype == k[2]
            assert torch.equal(v, torch.tensor(k[0][1], dtype=k[2]))
    assert diffmap._edge_map_consts(h, w, 3, CPU) is \
        cached["edge_detector_map"]


def test_device_constants_race_to_one_tensor():
    """Threads that miss one key at once all get the first one made."""
    devconst.clear()
    got, made = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(50):
                got.append((i, devconst.get(
                    ("race", i), CPU,
                    lambda: made.append(1) or np.arange(64))))
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    first = {}
    for i, t in got:
        assert first.setdefault(i, t) is t
    assert len(got) == 16 * 50 and len(first) == 50
    assert devconst._bytes[0] == 50 * 64 * 8


def test_device_constants_stay_within_their_bytes(monkeypatch):
    devconst.clear()
    monkeypatch.setattr(devconst, "MAX_BYTES", 4096)
    keep = [devconst.get(("big", i), CPU, lambda: np.zeros(128))
            for i in range(20)]
    assert devconst._bytes[0] <= 4096 and len(devconst._cache) == 4
    assert all(t.numel() == 128 for t in keep)


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    return torch.device("cuda")


# The comparator's methods that run one compare dispatch each.
_DISPATCHES = ("dispatch_compare", "dispatch_quant_batch",
               "_compare_weights", "_compare_resident")


class _Record:
    """Every graph's or eager chain's outputs (CompareGraphs.run), in
    order, copied to the host at the end, and the compare dispatches;
    `eager` runs every compare eagerly."""

    def __init__(self, monkeypatch, eager):
        self.outs = []
        self.dispatches = 0
        real = compare_graphs.CompareGraphs.run
        rec = self

        def run(graphs, key, fn, inputs, timings, counters):
            if eager:
                graphs.enabled = False
            out, mode = real(graphs, key, fn, inputs, timings, counters)
            rec.outs.append(out)
            return out, mode
        monkeypatch.setattr(compare_graphs.CompareGraphs, "run", run)
        for name in _DISPATCHES:
            monkeypatch.setattr(comparator.Comparator, name,
                                self._counted(getattr(comparator.Comparator,
                                                      name)))

    def _counted(self, method):
        def counted(*args, **kwargs):
            self.dispatches += 1
            return method(*args, **kwargs)
        return counted

    def host(self):
        return [[t.cpu() for t in out] for out in self.outs]


def _both(monkeypatch, encode):
    """encode() with graphs and eagerly: (results, records, dispatches)
    of each."""
    res = {}
    for eager in (False, True):
        with monkeypatch.context() as m:
            rec = _Record(m, eager)
            out = encode()
            torch.cuda.synchronize()
            res[eager] = (out, rec.host(), rec.dispatches)
    return res[False], res[True]


def _assert_same(a, b):
    (out_a, rec_a, n_a), (out_b, rec_b, n_b) = a, b
    assert n_a == n_b
    assert out_a == out_b
    assert len(rec_a) == len(rec_b)
    for x, y in zip(rec_a, rec_b):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


@pytest.mark.gpu
def test_graphs_on_card(monkeypatch):
    """Graphs against eager mode, bit for bit, on the card: a 4:4:4 crop,
    a 4:2:0 JPEG, a lockstep batch of four thumbnails and api.
    encode_corpus with two threads; waves in flight; a recovery."""
    dev = _card()
    from guetzli_tpu_torch import api
    from guetzli_tpu_torch.parallel import lockstep
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_rgb)
    rgb, fw, fh = read_png((REPO / "tests/corpus/photo_hopper.png")
                           .read_bytes())
    crop = np.asarray(rgb, np.uint8).reshape(fh, fw, 3)[100:292, 64:320]
    crop = np.ascontiguousarray(crop)
    stats = {}

    def encode444():
        stats.setdefault("444", []).append(ProcessStats())
        return process_rgb(Params(), crop, 256, 192, stats["444"][-1], dev)
    a, b = _both(monkeypatch, encode444)
    _assert_same(a, b)
    graphed, eager = stats["444"]
    assert graphed.final_distance == eager.final_distance
    c = graphed.counters
    assert c[compare_graphs.REPLAYS] > c[compare_graphs.CAPTURES] > 0
    assert c[compare_graphs.EAGER] == 1
    assert _total(c) == a[2]
    assert eager.counters.get(compare_graphs.REPLAYS, 0) == 0

    jpeg = (REPO / "tests/corpus/photo_hopper-420.jpg").read_bytes()
    runs = []

    def encode420():
        runs.append(ProcessStats())
        return api.encode_bytes(jpeg, 95, stats=runs[-1], device=dev)
    a, b = _both(monkeypatch, encode420)
    _assert_same(a, b)
    assert runs[0].final_distance == runs[1].final_distance
    assert _total(runs[0].counters) == a[2]
    assert runs[0].counters[compare_graphs.REPLAYS] > 0
    assert runs[0].counters[compare_graphs.EAGER] == 1

    thumbs = [(n, (REPO / n).read_bytes()) for n in (
        "tests/fixtures/bees96x64.png", "tests/fixtures/synth128x96.png",
        "tests/fixtures/bees160x120.png", "tests/corpus/bees_d-420.jpg")]
    counters = []

    def batch():
        counters.append({})
        return lockstep.encode_corpus_lockstep(thumbs, 95, device=dev,
                                               counters=counters[-1])
    a, b = _both(monkeypatch, batch)
    _assert_same(a, b)
    assert _total(counters[0]) == a[2]
    assert counters[0][compare_graphs.REPLAYS] > 0
    assert counters[0][compare_graphs.EAGER] == len(thumbs)

    corpus = thumbs[:2] + [("hopper", jpeg)]
    a, b = _both(monkeypatch, lambda: [
        r[:2] for r in api.encode_corpus(corpus, 95, threads=2,
                                         device=dev)])
    _assert_same(a, b)

    # Three waves of one size queued before any is fetched, then a
    # recovery: the next compare captures again and gives the same score.
    # The encodes above cached this geometry's graphs: dropped, its first
    # compare captures (the geometry is warm).
    img = _coeff_image(crop, 256, 192)
    compare_graphs.drop(dev)
    comp = comparator.Comparator(crop, 256, 192, 1.0, dev)
    first = comp.compare_img(img)
    base = comp.quant_base_upload(img)
    qs = [[np.full(192, q, np.int32) for q in qq]
          for qq in ((2, 9, 3, 5), (3, 8, 2, 6), (4, 7, 1, 9))]
    handles = [comp.dispatch_quant_batch(base, q) for q in qs]
    got = [comp.fetch_quant_scores(hd) for hd in handles]
    assert comp.counters[compare_graphs.REPLAYS] == 2
    for q, g in zip(qs, got):
        alone = comp.fetch_quant_scores(comp.dispatch_quant_batch(base, q))
        np.testing.assert_array_equal(g, alone)
    assert comp.compare_img(img) == first
    captures = comp.counters[compare_graphs.CAPTURES]
    comp.recover_device_state()
    assert not comp._graphs.keys()
    assert comp.compare_img(img) == first
    assert comp.counters[compare_graphs.CAPTURES] == captures + 1
