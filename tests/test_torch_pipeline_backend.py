"""The port's pipelined back end (GUETZLI_TPU_PIPELINE=N: the prefetch
thread's start/join protocol, Comparator.fetch_compare_pure) on the CPU,
one torch thread:

  * lag 1 equals lag 0 byte for byte: its join comes before the next
    order is built, so every iteration uses the weights lag 0 uses;
  * lag 2 is deterministic across runs, and its size lies within
    max(2%, 64 B) of lag 0 and of the JAX package's lag-2 output on the
    same image (tests/test_pipeline_backend.py holds JAX to the same
    band against its own lag 0);
  * fetch_compare_pure changes nothing on the comparator;
  * an out-of-memory error in a prefetch is replayed at its join with
    the same bytes, a sticky one propagates;
  * with no variable set, the CPU runs lag 0, no tree and no
    speculation (config.auto), and the serial driver.
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import consts as jconsts
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.search import processor as jproc

from guetzli_tpu_torch import api, config, runtime
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search.processor import ProcessStats

PNGS = ("bees96x64.png", "bees97x63.png")
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"
STICKY = "CUDA error: an illegal memory access was encountered"


def _encode(name, lag, monkeypatch, stats=None):
    if lag is None:
        monkeypatch.delenv("GUETZLI_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("GUETZLI_TPU_PIPELINE", str(lag))
    stats = stats or ProcessStats()
    out = api.encode_bytes((FIXTURES / name).read_bytes(), 95, stats=stats,
                           device="cpu")
    assert stats.search_error is None
    return out


def _pipelined_calls(monkeypatch):
    calls = []
    real = proc_mod.Processor._drive_back_end_pipelined
    monkeypatch.setattr(proc_mod.Processor, "_drive_back_end_pipelined",
                        lambda self, gen, lag: calls.append(lag)
                        or real(self, gen, lag))
    return calls


@pytest.mark.parametrize("name", PNGS)
def test_lag1_equals_lag0(name, monkeypatch):
    calls = _pipelined_calls(monkeypatch)
    exact = _encode(name, 0, monkeypatch)
    assert not calls
    assert _encode(name, 1, monkeypatch) == exact
    assert calls == [1]


def _jax_lag2(name, monkeypatch):
    monkeypatch.setenv("GUETZLI_TPU_PIPELINE", "2")
    rgb, w, h = jread_png((FIXTURES / name).read_bytes())
    params = jproc.Params()
    params.butteraugli_target = jconsts.butteraugli_score_for_quality(95)
    return jproc.process_rgb(params, rgb, w, h, jproc.ProcessStats())


def test_lag2_deterministic_and_in_band(monkeypatch):
    name = PNGS[0]
    exact = _encode(name, 0, monkeypatch)
    piped = _encode(name, 2, monkeypatch)
    assert _encode(name, 2, monkeypatch) == piped
    for other in (exact, _jax_lag2(name, monkeypatch)):
        assert abs(len(piped) - len(other)) <= max(0.02 * len(other), 64), \
            (len(piped), len(other))


def test_fetch_compare_pure_has_no_side_effects():
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    rgb, w, h = read_png((FIXTURES / PNGS[0]).read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    comp = cmp_mod.Comparator(rgb, w, h, 1.0, "cpu")
    handle = comp.dispatch_compare_with_weights(img, 1, 1.0, 1, 1)
    d, w4, dmap = comp.fetch_compare_pure(handle)
    assert comp.distance == 0.0 and comp.distmap is None
    assert (d, dmap) == (float(handle[0]), handle[1])
    np.testing.assert_array_equal(w4, handle[2].numpy())
    assert comp.fetch_compare(handle)[0] == d and comp.distmap is dmap


def _fail_pure(monkeypatch, exc, calls):
    real = cmp_mod.Comparator.fetch_compare_pure
    n = [0]

    def wrapped(self, handle):
        n[0] += 1
        if n[0] in calls:
            raise exc
        return real(self, handle)
    monkeypatch.setattr(cmp_mod.Comparator, "fetch_compare_pure", wrapped)
    return n


def test_oom_in_a_prefetch_is_replayed(monkeypatch):
    name = PNGS[0]
    want = _encode(name, 0, monkeypatch)
    released = []
    monkeypatch.setattr(runtime, "release_memory",
                        lambda device, what: released.append(what))
    monkeypatch.setenv("GUETZLI_TPU_SPARSE", "1")
    n = _fail_pure(monkeypatch, torch.cuda.OutOfMemoryError(OOM), {2, 7})
    assert _encode(name, 1, monkeypatch) == want
    assert released == ["a pipelined fetch"] * 2 and n[0] > 7


def test_sticky_error_in_a_prefetch_propagates(monkeypatch):
    _fail_pure(monkeypatch, RuntimeError(STICKY), {3})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _encode(PNGS[0], 1, monkeypatch)


def test_cpu_auto_is_the_serial_route(monkeypatch):
    for knob in ("PIPELINE", "TREE_QUANT", "SPECULATE", "SPARSE"):
        monkeypatch.delenv("GUETZLI_TPU_" + knob, raising=False)
    cpu = torch.device("cpu")
    assert config.auto("pipeline_lag", cpu) == 0
    assert config.auto("tree_quant", cpu) is False
    assert config.auto("speculate", cpu) is False
    assert config.auto("sparse", cpu) is False
    assert config.auto("pipeline_lag", torch.device("cuda")) \
        == config.CUDA_AUTO["pipeline_lag"]
    monkeypatch.setenv("GUETZLI_TPU_PIPELINE", "-3")
    assert config.auto("pipeline_lag", torch.device("cuda")) == 0
    monkeypatch.setenv("GUETZLI_TPU_PIPELINE", "2")
    assert config.auto("pipeline_lag", cpu) == 2
    calls = _pipelined_calls(monkeypatch)
    stats = ProcessStats()
    _encode(PNGS[0], None, monkeypatch, stats)
    assert not calls and "quant_waves" not in stats.counters
