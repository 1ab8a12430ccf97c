"""The native flip loop (native.cc gt_backend_flips) against the eager
Python flip loop (Processor._run_flips_python) on the CPU, one torch
thread.

The native loop rebuilds the entropy codes and estimates the size only
where its stop test or its caller reads them; the Python loop does both at
every step. The inputs are the real back-end states of a bees96x64 q95
encode: its first up and first down iteration, replayed with the minimum
number of flips set below, at and above each rebuild boundary (0, 9, 10,
11), at the order's length and above it (the loop runs out), at the
encode's own minimum, on orders cut to fewer than 10 candidates and on
orders of 10 and 20. Each case holds every output field by field: the
estimate, the flip count, the value threshold, the changed blocks,
last_indexes, the histograms, the depths, the header size, the
coefficients and the flip triplets.

The counters flips and flip_code_rebuilds reach the serial
ProcessStats.counters and the corpus driver's sums, and a large minimum
leaves most rebuilds out.
"""

import copy
import types

import numpy as np
import pytest

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, native
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search.processor import ProcessStats

PNG = (FIXTURES / "bees96x64.png").read_bytes()
# Positional arguments of _run_flips_native after self.
ARGS = ("img", "jpg", "bw", "offsets", "cand_idx", "cand_err",
        "last_indexes", "order_blocks", "order_vals", "direction",
        "min_coeffs_to_change", "min_size_delta", "prev_size",
        "jpg_header_size", "dc_size", "ac_histograms", "ac_depths",
        "ac_histogram_size", "nb")


@pytest.fixture(scope="module")
def encoded():
    """A serial encode with its flip loop calls recorded: (bytes, stats,
    {direction: the first call's arguments}, [flips of each call])."""
    if native.get_lib() is None:
        pytest.fail("the native library did not build")
    first, flips = {}, []
    real = proc_mod.Processor._run_flips_native

    def record(self, *args):
        state = dict(zip(ARGS, args))
        first.setdefault(state["direction"], copy.deepcopy(state))
        got = real(self, *args)
        flips.append(got[1])
        return got
    with pytest.MonkeyPatch.context() as m:
        m.setattr(proc_mod.Processor, "_run_flips_native", record)
        stats = ProcessStats()
        out = api.encode_bytes(PNG, 95, stats=stats, device="cpu")
    assert set(first) == {1, -1}
    return out, stats, first, flips


def _replay(state, min_coeffs, order_n):
    """Both loops on copies of `state`, the order cut to `order_n`:
    (native's fields, Python's fields, the native run's stats)."""
    runs = []
    for loop in ("native", "python"):
        s = copy.deepcopy(state)
        s["order_blocks"] = s["order_blocks"][:order_n]
        s["order_vals"] = s["order_vals"][:order_n]
        s["min_coeffs_to_change"] = min_coeffs
        li_before = s["last_indexes"].copy()
        fake = types.SimpleNamespace(stats=ProcessStats())
        args = [s[k] for k in ARGS]
        if loop == "native":
            got = proc_mod.Processor._run_flips_native(fake, *args)
            est, n, thresh, blocks, depths, hsize, triplets = got
        else:
            got = proc_mod.Processor._run_flips_python(fake, *args[:-1])
            est, n, thresh, blocks, depths, hsize = got
            changed = np.nonzero(s["last_indexes"] != li_before)[0]
            clamped = np.clip(s["offsets"][:s["nb"]], 0,
                              max(len(s["cand_err"]) - 1, 0))
            triplets = proc_mod._flip_triplets(
                s["img"], changed, li_before, s["last_indexes"], clamped,
                s["cand_idx"])
        fields = dict(
            est=est, flips=n, val_threshold=thresh, changed_blocks=blocks,
            depths=np.asarray(depths, np.uint8),
            ac_histogram_size=hsize,
            last_indexes=s["last_indexes"],
            histograms=np.stack(s["ac_histograms"]),
            coeffs=[np.asarray(c.coeffs) for c in s["img"].comps],
            triplets=triplets)
        runs.append((fields, fake.stats))
    return runs[0][0], runs[1][0], runs[0][1]


def _sorted_triplets(triplets):
    bs, slots, vals = (np.asarray(t, np.int64) for t in triplets)
    ix = np.lexsort((slots, bs))
    return np.stack([bs[ix], slots[ix], vals[ix]])


# (min_coeffs_to_change, order length); "n" is the order's length and
# "own" the encode's own minimum for the iteration. Orders of 10 and 20
# run out just before the next rebuild would be due.
CASES = [(0, None), (9, None), (10, None), (11, None), ("n", None),
         ("n+7", None), ("own", None), (0, 7), (6, 7), ("n", 7),
         ("n+7", 7), (0, 1), ("n", 10), ("n", 20), (15, 20)]


@pytest.mark.parametrize("min_spec,order_n", CASES,
                         ids=["min%s-order%s" % c for c in CASES])
@pytest.mark.parametrize("direction", [1, -1], ids=["up", "down"])
def test_native_loop_equals_python_loop(encoded, direction, min_spec,
                                        order_n):
    state = encoded[2][direction]
    n = len(state["order_blocks"]) if order_n is None else order_n
    assert n <= len(state["order_blocks"])
    min_coeffs = {"n": n, "n+7": n + 7,
                  "own": state["min_coeffs_to_change"]}.get(min_spec,
                                                            min_spec)
    got, want, _stats = _replay(state, min_coeffs, n)
    for key in ("est", "flips", "val_threshold", "changed_blocks",
                "ac_histogram_size"):
        assert got[key] == want[key], key
    for key in ("depths", "last_indexes", "histograms"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for c in range(3):
        np.testing.assert_array_equal(got["coeffs"][c], want["coeffs"][c])
    m = got["flips"]
    if min_coeffs >= n:
        assert m == n   # the stop test never passes: the order runs out
    np.testing.assert_array_equal(got["triplets"][0],
                                  state["order_blocks"][:m])
    np.testing.assert_array_equal(_sorted_triplets(got["triplets"]),
                                  _sorted_triplets(want["triplets"]))


def test_large_minimum_skips_most_rebuilds(encoded):
    state = encoded[2][1]
    n = len(state["order_blocks"])
    assert n >= 100
    got, _want, stats = _replay(state, n - 1, n)
    assert stats.counters["flips"] == got["flips"] >= n - 1
    assert 1 <= stats.counters["flip_code_rebuilds"] < got["flips"] / 10


def test_serial_encode_counts_flips_and_rebuilds(encoded):
    _out, stats, _first, flips = encoded
    assert stats.counters["flips"] == sum(flips) > 0
    assert 0 < stats.counters["flip_code_rebuilds"] < sum(flips) / 10


def test_corpus_driver_sums_the_flip_counters(encoded):
    out, stats, _first, _flips = encoded
    counters = {}
    got = lockstep.encode_corpus_lockstep([("a", PNG), ("b", PNG)], 95,
                                          device="cpu", counters=counters)
    assert [o for _name, o in got] == [out, out]
    for key in ("flips", "flip_code_rebuilds"):
        assert counters[key] == 2 * stats.counters[key], key
