"""The port's host spans (guetzli_tpu_torch/spans.py) on the CPU.

  * a serial encode fills ProcessStats.timings' compare_dispatch,
    compare_wait and image_setup, and a lockstep batch of two images the
    same keys of its phase walls; the spans change no byte;
  * a deferred compare's launch is charged where it runs, at its
    resolve in fetch_compare_many, and nested dispatch sites count once;
  * under torch.profiler the phases are "phase.<name>" events of the
    trace; with no profiler running record_function is never entered.
"""

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, spans
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search.processor import ProcessStats

CORPUS = FIXTURES.parent / "corpus"
JPEG = (CORPUS / "bees_d-420.jpg").read_bytes()
PNG = (FIXTURES / "bees96x64.png").read_bytes()
COMPARE_KEYS = ("compare_dispatch", "compare_wait", "image_setup")


def _forbidden(*_a, **_k):
    raise AssertionError("record_function entered with no profiler")


def _encodes():
    """A serial encode of the JPEG and a lockstep batch of both images:
    (serial bytes, its timings, lockstep outputs, phase walls)."""
    stats = ProcessStats()
    out = api.encode_bytes(JPEG, 95, stats=stats, device="cpu")
    walls = {}
    res = lockstep.encode_corpus_lockstep([("jpeg", JPEG), ("png", PNG)],
                                          95, phase_walls=walls,
                                          device="cpu")
    return out, stats.timings, dict(res), walls


@pytest.fixture(scope="module")
def untraced():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(spans, "record_function", _forbidden)
        return _encodes()


@pytest.fixture(scope="module")
def traced():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _encodes()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return res, names


def test_serial_encode_fills_the_compare_spans(untraced):
    out, timings, _res, _walls = untraced
    for key in COMPARE_KEYS:
        assert timings[key] > 0, key
    # Spans nest in the phases that hold them.
    assert timings["compare_dispatch"] + timings["compare_wait"] < sum(
        timings[k] for k in ("image_setup", "select_quant_matrix",
                             "select_frequency_masking"))


def test_lockstep_batch_fills_the_phase_walls(untraced):
    out, _timings, res, walls = untraced
    for key in COMPARE_KEYS + ("quant", "zeroing", "backend"):
        assert walls[key] > 0, key
    assert res["jpeg"] == out


def test_spans_change_no_byte(untraced, traced):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(spans, "timed",
                  lambda walls, name: contextlib.nullcontext())
        stats = ProcessStats()
        bare = api.encode_bytes(JPEG, 95, stats=stats, device="cpu")
    # Only the spans every encode declares at its start, at 0.0.
    assert stats.timings == dict.fromkeys(proc_mod.ENCODE_SPANS, 0.0)
    assert untraced[0] == bare and traced[0][0] == bare
    assert traced[0][2] == untraced[2]


def test_the_profiler_trace_holds_the_phases(traced):
    _res, names = traced
    for name in ("back_end", "image_setup", "compare_dispatch",
                 "compare_wait", "lockstep_round", "backend", "quant"):
        assert "phase." + name in names, name


def _deferred_compare(walls):
    rgb, w, h = read_png(PNG)
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    comp = cmp_mod.Comparator(rgb, w, h, 1.0, "cpu", padded=False,
                              mesh=False)
    comp.batcher = cmp_mod.CompareBatcher()
    comp.timings = walls
    return comp, comp.dispatch_compare_with_weights(img, 1, 1.0, 1, 1)


def test_a_deferred_launch_is_charged_at_its_resolve(monkeypatch):
    walls = {}
    comp, handle = _deferred_compare(walls)
    assert isinstance(handle, cmp_mod.DeferredCompare)
    assert walls == {}
    slow = 0.3
    real = cmp_mod.Comparator._compare_weights

    def slowed(self, img, args):
        time.sleep(slow)
        return real(self, img, args)
    monkeypatch.setattr(cmp_mod.Comparator, "_compare_weights", slowed)
    t0 = time.time()
    (d, w4), = cmp_mod.fetch_compare_many([comp], [handle])
    wall = time.time() - t0
    charged = walls["compare_dispatch"]
    assert charged >= slow
    # The run, the compare it calls and the fetch's own span nest: each
    # second counts once.
    assert charged + walls["compare_wait"] <= wall + 1e-3
    assert d == comp.distance and w4.shape[0] == 4


def test_span_accumulates_and_takes_no_dict():
    walls = {}
    with spans.timed(walls, "a"):
        time.sleep(0.01)
    with spans.timed(walls, "a"):
        pass
    with spans.timed(None, "a"):
        time.sleep(0.01)
    assert list(walls) == ["a"] and 0.01 <= walls["a"] < 0.5


def test_nested_dispatch_spans_open_once_per_thread(monkeypatch):
    """A dispatch site inside another's span opens no second span on its
    thread; a dispatch on another thread (a corpus pool's) opens its
    own."""
    opened = []
    real = spans.timed
    monkeypatch.setattr(spans, "timed", lambda walls, name: opened.append(
        (threading.current_thread().name, name)) or real(walls, name))
    walls = {}

    def other():
        with cmp_mod.dispatch_span(walls), cmp_mod.dispatch_span(walls):
            pass
    with cmp_mod.dispatch_span(walls):
        with cmp_mod.dispatch_span(walls):
            pass
        with ThreadPoolExecutor(1) as ex:
            ex.submit(other).result()
    assert [n for _t, n in opened] == ["compare_dispatch"] * 2
    assert len({t for t, _n in opened}) == 2
    with cmp_mod.wait_span(walls):
        pass
    assert sorted(walls) == ["compare_dispatch", "compare_wait"]


def test_profiler_flag_is_off_outside_a_session():
    assert not torch.autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
