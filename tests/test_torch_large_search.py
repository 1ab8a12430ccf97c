"""The search driver's paths that only multi-megapixel images reach on
the card, forced on the CPU at a small image (bees96x64.png at q95, one
torch thread):

  * quant waves capped at 1, 2 and 3 trials (Comparator.wave_sizes, the
    memory cap of quant_batch_sizes) score every matrix as the uncapped
    (4, 8) waves do and give the same search and output bytes;
    wave_sizes at the card's numbers;
  * the counters quant_waves and quant_wave_trials count the waves
    dispatched and their trials, serially and summed by the corpus
    driver;
  * with processor.RETURN_MEMORY_BLOCKS and RETURN_MEMORY_PASS_BYTES
    lowered, an encode takes both host memory returns, under the
    return_memory span and counted as return_memory_calls, and writes
    the bytes of an encode that takes neither;
  * an out-of-memory error in the first compare, in a quant wave's fetch
    or in a sparse back-end fetch shows in the recover span and
    oom_recoveries, with the same bytes; a healthy encode's timings hold
    both spans at 0.0.
"""

import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import quant_tree
from guetzli_tpu_torch.search.processor import ProcessStats

PNG = (FIXTURES / "bees96x64.png").read_bytes()
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"
TRIAL = cmp_mod.Comparator._QUANT_TRIAL_BYTES_PER_PIXEL


def _tree_encode(monkeypatch):
    """An encode, whose quant search runs in waves: (bytes, stats, the
    waves' lengths as dispatched, every scored matrix's score)."""
    waves, scores = [], {}
    real_dq = cmp_mod.Comparator.dispatch_quant_batch
    real_absorb = quant_tree.TreeQuantSearch.absorb

    def dq(self, base, qs):
        waves.append(len(qs))
        return real_dq(self, base, qs)

    def absorb(self, pending, scores_per_wave):
        for (_h, chunk), got in zip(pending, scores_per_wave):
            for q, s in zip(chunk, got):
                scores[q.tobytes()] = float(s)
        return real_absorb(self, pending, scores_per_wave)
    monkeypatch.setattr(cmp_mod.Comparator, "dispatch_quant_batch", dq)
    monkeypatch.setattr(quant_tree.TreeQuantSearch, "absorb", absorb)
    stats = ProcessStats()
    out = api.encode_bytes(PNG, 95, stats=stats, device="cpu")
    return out, stats, waves, scores


@pytest.fixture(scope="module")
def uncapped():
    with pytest.MonkeyPatch.context() as m:
        return _tree_encode(m)


@pytest.fixture(scope="module")
def plain():
    """The CPU's default encode: (bytes, stats)."""
    stats = ProcessStats()
    return api.encode_bytes(PNG, 95, stats=stats, device="cpu"), stats


@pytest.mark.parametrize("free_gb,mpix,want", [
    (44.4, 6.29, (2,)),       # 6.29 MPix beside a held 39.5 GB graph pool
    (63.0, 6.29, (3,)),       # 6.29 MPix after a 3.15 MPix image
    (44.4, 3.15, (4,)),
    (79.0, 3.15, (4, 8)),     # 3.15 MPix on a fresh card
    (4.0, 6.29, (1,)),        # at least one trial
])
def test_wave_sizes_at_the_cards_numbers(free_gb, mpix, want):
    assert cmp_mod.Comparator.wave_sizes(
        free_gb * 1e9, mpix * 1e6 * TRIAL) == want


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_capped_waves_keep_scores_and_bytes(cap, uncapped, monkeypatch):
    sizes = cmp_mod.Comparator.wave_sizes(2 * cap * 1000 + 1, 1000)
    assert sizes == (cap,)
    monkeypatch.setattr(cmp_mod.Comparator, "quant_batch_sizes",
                        lambda self: sizes)
    out, stats, waves, scores = _tree_encode(monkeypatch)
    want_out, want_stats, want_waves, want_scores = uncapped
    assert max(want_waves) > cap and max(waves) == cap
    assert scores == want_scores
    assert out == want_out
    assert stats.final_distance == want_stats.final_distance
    assert stats.counters["quant_trials"] == \
        want_stats.counters["quant_trials"]


def test_wave_counters_count_the_waves_dispatched(uncapped):
    _out, stats, waves, _scores = uncapped
    assert len(waves) >= 2
    assert stats.counters["quant_waves"] == len(waves)
    assert stats.counters["quant_wave_trials"] == sum(waves)


def test_corpus_driver_sums_the_search_counters(monkeypatch):
    waves = []
    real_dq = cmp_mod.Comparator.dispatch_quant_batch
    monkeypatch.setattr(cmp_mod.Comparator, "dispatch_quant_batch",
                        lambda self, base, qs: waves.append(len(qs))
                        or real_dq(self, base, qs))
    monkeypatch.setattr(proc_mod, "RETURN_MEMORY_BLOCKS", 0)
    counters = {}
    lockstep.encode_corpus_lockstep(
        [("a", PNG), ("b", (FIXTURES / "bees97x63.png").read_bytes())],
        95, device="cpu", counters=counters)
    assert counters["quant_waves"] == len(waves) >= 4
    assert counters["quant_wave_trials"] == sum(waves)
    assert counters["return_memory_calls"] >= 2
    assert counters["oom_recoveries"] == 0


def test_healthy_encode_holds_both_spans_at_zero(plain):
    _out, stats = plain
    for name in ("return_memory", "recover"):
        assert stats.timings[name] == 0.0
    for name in ("return_memory_calls", "oom_recoveries"):
        assert name not in stats.counters


def test_lowered_thresholds_take_both_returns(plain, monkeypatch):
    monkeypatch.setattr(proc_mod, "RETURN_MEMORY_BLOCKS", 1)
    monkeypatch.setattr(proc_mod, "RETURN_MEMORY_PASS_BYTES", 192)
    calls = []
    real = proc_mod.return_memory
    monkeypatch.setattr(proc_mod, "return_memory",
                        lambda collect=True: calls.append(collect)
                        or real(collect))
    stats = ProcessStats()
    assert api.encode_bytes(PNG, 95, stats=stats, device="cpu") == plain[0]
    # The pass's return (a collection) once, then the back end's.
    assert calls[0] is True and calls.count(True) == 1
    assert calls.count(False) >= 1
    assert stats.counters["return_memory_calls"] == len(calls)
    assert stats.timings["return_memory"] > 0.0
    assert stats.timings["recover"] == 0.0


def _fail(monkeypatch, name, calls):
    """Comparator.<name> raises an out-of-memory error on the calls
    numbered in `calls` (from 1)."""
    real = getattr(cmp_mod.Comparator, name)
    n = [0]

    def wrapped(*a, **k):
        n[0] += 1
        if n[0] in calls:
            raise torch.cuda.OutOfMemoryError(OOM)
        return real(*a, **k)
    monkeypatch.setattr(cmp_mod.Comparator, name, wrapped)


# The call of each fetch that fails: the first compare's (its only plain
# fetch), and the second of the quant waves and of the 4:4:4 back end.
FAILING_CALL = {"serial": 1, "waves": 2, "sparse": 2}


@pytest.mark.parametrize("route,fetch", [
    ("serial", "fetch_compare_plain"),
    ("waves", "fetch_quant_scores"),
    ("sparse", "fetch_compare"),
])
def test_oom_shows_in_the_recover_span(route, fetch, plain, monkeypatch):
    _fail(monkeypatch, fetch, {FAILING_CALL[route]})
    stats = ProcessStats()
    assert api.encode_bytes(PNG, 95, stats=stats, device="cpu") == plain[0]
    assert stats.counters["oom_recoveries"] == 1
    assert stats.timings["recover"] > 0.0
