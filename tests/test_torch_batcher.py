"""The port's CompareBatcher, the zeroing passes on the bucket block grid
and the padded route end to end, on the CPU, one torch thread:

  * three images of bucket 128x64 (bees_d, grad2, stripes0, 97x63) and one
    of bucket 96x96 (grad0), at 4:4:4 and at 4:2:0, enqueued from two
    threads in either order: each row equals its single padded compare
    bit for bit (score, diffmap, weights), one stacked compare a bucket;
  * an out-of-memory error in a flush replays the same stack; one that
    persists raises for every row, and each row's replay runs alone;
  * with a batcher set, an exact comparator's compares and the sparse
    dispatches run when read, with the immediate dispatches' results;
  * the greedy zeroing on the bucket grid in modes 444, 420y and 420c:
    the CSR after real_index equals the exact grid's at the same state
    bit for bit, the padded rows have no candidates;
  * encodes with the padded geometry forced on (GUETZLI_TPU_PAD=1):
    bees_d.png and bees_d-420.jpg at q95 within 2% of golden, distance at
    or below target; the lockstep corpus of four images (one 4:2:0 JPEG)
    through the batcher, on the default route (quant waves, sparse deltas
    in the 4:4:4 pass), gives each image its serial padded bytes;
  * the knob: off when unset, forced either way by GUETZLI_TPU_PAD;
    --checkcuda keeps the exact geometry under GUETZLI_TPU_PAD=1.
"""

import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, checkcl, config, consts, runtime
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel.lockstep import encode_corpus_lockstep
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing
from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                ProcessStats,
                                                decode_jpeg_to_rgb)

CORPUS = FIXTURES.parent / "corpus"
TARGET = consts.butteraugli_score_for_quality(95)
NAMES = ("bees_d", "grad2", "stripes0", "grad0")
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"


def _start(path, padded=True):
    """(comparator, starting coefficient image, jpg) of a corpus file."""
    data = (CORPUS / path).read_bytes()
    if path.endswith(".jpg"):
        jpg = reader.read_jpeg(data)
        rgb = decode_jpeg_to_rgb(jpg)
    else:
        rgb, w, h = read_png(data)
        jpg = encode_rgb_to_jpeg(rgb, w, h)
    comp = cmp_mod.Comparator(rgb, jpg.width, jpg.height, TARGET, "cpu",
                              padded=padded)
    st.remove_original_quantization(jpg)
    return comp, st.CoeffImage.from_jpeg(jpg), jpg


@pytest.fixture(scope="module")
def images():
    """Per suffix: the four images' comparators, images and their single
    padded compares (distance, weights, distmap) with the args of
    ARGS[suffix]."""
    out = {}
    for suffix in (".png", "-420.jpg"):
        comps, imgs, singles = [], [], []
        for n in NAMES:
            c, img, _jpg = _start(n + suffix)
            comps.append(c)
            imgs.append(img)
            singles.append(c.fetch_compare(c.dispatch_compare_with_weights(
                img, *ARGS[suffix])) + (c.distmap,))
        out[suffix] = comps, imgs, singles
    return out


ARGS = {".png": (1, 1.0, 1, 1), "-420.jpg": (-1, 0.97, 2, 2)}


def _same(got, want):
    return (got[0] == want[0] and np.array_equal(got[1], want[1])
            and torch.equal(got[2], want[2]))


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("suffix", [".png", "-420.jpg"])
def test_batched_rows_equal_single_compares(images, suffix, first):
    comps, imgs, singles = images[suffix]
    b = cmp_mod.CompareBatcher()
    for c in comps:
        c.batcher = b
    handles = [None] * len(comps)
    halves = ([0, 2], [1, 3])
    go = [threading.Event(), threading.Event()]

    def enqueue(k):
        go[k].wait()
        for i in halves[k]:
            handles[i] = comps[i].dispatch_compare_with_weights(
                imgs[i], *ARGS[suffix])
        if k == first:
            go[1 - k].set()

    threads = [threading.Thread(target=enqueue, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    go[first].set()
    for t in threads:
        t.join()
    try:
        assert all(isinstance(h, cmp_mod.DeferredCompare) for h in handles)
        got = cmp_mod.fetch_compare_many(comps, handles)
    finally:
        for c in comps:
            c.batcher = None
    assert (b.flushes, b.rows) == (2, 4)       # buckets 128x64 and 96x96
    for c, g, want in zip(comps, got, singles):
        assert _same(g + (c.distmap,), want)


def test_batcher_mixes_kinds_and_plain_compares(images):
    """4:4:4 and 4:2:0 requests and plain compares in one queue: each
    group its own stack, every result its single compare's."""
    b = cmp_mod.CompareBatcher()
    comps, imgs, singles = images[".png"]
    comps4, imgs4, singles4 = images["-420.jpg"]
    for c in comps + comps4:
        c.batcher = b
    try:
        plain = [c.dispatch_compare(m) for c, m in zip(comps[:3], imgs[:3])]
        hs = [c.dispatch_compare_with_weights(m, *ARGS["-420.jpg"])
              for c, m in zip(comps4, imgs4)]
        got4 = [c.fetch_compare(h) + (c.distmap,)
                for c, h in zip(comps4, hs)]
        dists = [c.fetch_compare_plain(h) for c, h in zip(comps[:3], plain)]
    finally:
        for c in comps + comps4:
            c.batcher = None
    assert (b.flushes, b.rows) == (3, 7)
    assert dists == [s[0] for s in singles[:3]]
    for g, want in zip(got4, singles4):
        assert _same(g, want)


def test_flush_replays_an_out_of_memory_error(images, monkeypatch):
    comps, imgs, singles = images[".png"]
    real = cmp_mod._run_stack
    fails = {"n": 1}

    def flaky(key, items):
        if fails["n"]:
            fails["n"] -= 1
            raise torch.cuda.OutOfMemoryError(OOM)
        return real(key, items)

    monkeypatch.setattr(cmp_mod, "_run_stack", flaky)
    b = cmp_mod.CompareBatcher()
    for c in comps:
        c.batcher = b
    try:
        hs = [c.dispatch_compare_with_weights(m, *ARGS[".png"])
              for c, m in zip(comps, imgs)]
        with contextlib.redirect_stderr(io.StringIO()) as err:
            got = [c.fetch_compare(h) + (c.distmap,)
                   for c, h in zip(comps, hs)]
        assert "out of memory during a batched compare" in err.getvalue()
        assert all(_same(g, s) for g, s in zip(got, singles))
        # A persistent error: every row of the stack raises; its owner's
        # replay runs it alone, with the same result.
        fails["n"] = runtime.ATTEMPTS
        hs = [c.dispatch_compare_with_weights(m, *ARGS[".png"])
              for c, m in zip(comps[:3], imgs[:3])]
        with contextlib.redirect_stderr(io.StringIO()):
            for c, h, s in zip(comps, hs, singles):
                with pytest.raises(torch.cuda.OutOfMemoryError):
                    c.fetch_compare(h)
                assert _same(c.fetch_compare(c.replay(h)) + (c.distmap,), s)
    finally:
        for c in comps:
            c.batcher = None


@pytest.mark.parametrize("padded", [False, True])
def test_a_batcher_defers_the_back_ends_device_work(padded):
    """With a batcher set (the corpus), an exact comparator's compare and
    the sparse dispatches of a resident state run when read, not when
    dispatched, with the results of the immediate dispatches."""
    comp, img, _jpg = _start("bees_d.png", padded=padded)
    img.apply_global_quantization(np.full((3, 64), 3, np.int32))
    want = comp.fetch_compare(comp.dispatch_compare_with_weights(
        img, -1, 1.0, 1, 1))
    comp.backend_sync_full(img)
    want_sparse = comp.fetch_compare(comp.dispatch_compare_sparse_coeffs(
        img, np.array([0, 5]), np.array([3, 70]),
        np.array([0, 0], np.int32), 1, 1.0, 1, 1))
    comp.backend_sync_full(img)
    comp.batcher = cmp_mod.CompareBatcher()
    n = comp.compares
    h = comp.dispatch_compare_with_weights(img, -1, 1.0, 1, 1)
    hs = comp.dispatch_compare_sparse_coeffs(
        img, np.array([0, 5]), np.array([3, 70]),
        np.array([0, 0], np.int32), 1, 1.0, 1, 1)
    assert isinstance(h, cmp_mod.DeferredCompare)
    assert isinstance(hs, cmp_mod.DeferredCompare)
    assert comp.compares == n + padded        # only the enqueue counted
    got = comp.fetch_compare(h)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    got = comp.fetch_compare(hs)
    assert got[0] == want_sparse[0] and np.array_equal(got[1],
                                                       want_sparse[1])
    assert comp.batcher.rows == padded


@pytest.mark.parametrize("path,mask", [("bees_d.png", 7),
                                       ("bees_d-420.jpg", 1),
                                       ("bees_d-420.jpg", 6)])
def test_zeroing_on_the_bucket_grid(path, mask):
    comp, img, jpg = _start(path)
    proc = Processor(Params(), comp, ProcessStats())
    grid = img.comps[mask.bit_length() - 1]
    blocks, orig, real = proc.padded_masking_inputs(
        *proc.masking_inputs(jpg, img, mask), grid)
    mode, aux = proc.masking_aux(img, mask, grid)
    assert mode == {7: "444", 1: "420y", 6: "420c"}[mask]
    assert len(real) == grid.bw * grid.bh < len(blocks)
    assert all(a.shape[0] == len(blocks) for a in aux)
    limit = np.float32(TARGET)
    padded = zeroing.compute_zeroing_csr(blocks, orig, limit, aux, mask,
                                         "cpu", mode=mode, real_index=real)
    rows = torch.as_tensor(real)
    exact = zeroing.compute_zeroing_csr(blocks[real], orig[real], limit,
                                        tuple(a[rows] for a in aux), mask,
                                        "cpu", mode=mode)
    for a, b in zip(padded, exact):
        np.testing.assert_array_equal(a, b)
    assert len(padded[1]) > 0 and np.isfinite(padded[2]).all()
    pad_rows = np.setdiff1d(np.arange(len(blocks)), real)
    assert not blocks[pad_rows].any()


@pytest.mark.parametrize("name,golden", [("bees_d.png", 1963),
                                         ("bees_d-420.jpg", 1681)])
def test_padded_encode_golden(name, golden, monkeypatch):
    monkeypatch.setenv("GUETZLI_TPU_PAD", "1")
    stats = ProcessStats()
    out = api.encode_bytes((CORPUS / name).read_bytes(), 95, stats=stats,
                           device="cpu")
    assert abs(len(out) - golden) <= 0.02 * golden
    assert stats.search_error is None
    assert stats.final_distance <= TARGET


@pytest.fixture(scope="module")
def serial_padded():
    """The corpus's serial encodes with the padded geometry on."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GUETZLI_TPU_PAD", "1")
    try:
        return {p: api.encode_bytes((CORPUS / p).read_bytes(), 95,
                                    device="cpu") for p in CORPUS_FILES}
    finally:
        mp.undo()


CORPUS_FILES = ("bees_d.png", "grad2.png", "stripes0.png", "bees_d-420.jpg")


def test_corpus_through_the_batcher(serial_padded, monkeypatch):
    monkeypatch.setenv("GUETZLI_TPU_PAD", "1")
    counters = {}
    res = encode_corpus_lockstep(
        [(p, (CORPUS / p).read_bytes()) for p in CORPUS_FILES], 95,
        threads=2, device="cpu", counters=counters)
    for p, out in res:
        assert out == serial_padded[p], p
    assert 0 < counters["batched"] <= counters["compares"]
    assert counters["flushes"] < counters["batched"]


def test_pad_knob(monkeypatch):
    monkeypatch.delenv("GUETZLI_TPU_PAD", raising=False)
    assert config.pad() is None
    comp, _img, _jpg = _start("bees_d.png", padded=None)
    assert comp.geom is None and comp.xyb0.shape == (3, 63, 97)
    monkeypatch.setenv("GUETZLI_TPU_PAD", "1")
    assert config.pad() is True
    comp, _img, _jpg = _start("bees_d.png", padded=None)
    assert (comp.geom.wp, comp.geom.hp) == (128, 64)
    assert comp.xyb0.shape == (3, 64, 128)
    monkeypatch.setenv("GUETZLI_TPU_PAD", "0")
    assert config.pad() is False
    comp, _img, _jpg = _start("bees_d.png", padded=None)
    assert comp.geom is None


def test_checkcuda_keeps_exact_geometry(monkeypatch):
    """--checkcuda's candidates have the exact block count; under
    GUETZLI_TPU_PAD=1 its comparator stays exact and the run ends with no
    mismatch (the JAX package's padded run_checkcl fails there)."""
    monkeypatch.setenv("GUETZLI_TPU_PAD", "1")
    rgb, w, h = read_png((FIXTURES / "bees96x64.png").read_bytes())
    with contextlib.redirect_stderr(io.StringIO()):
        assert checkcl.run_checkcl(rgb, w, h, device="cpu") == 0
