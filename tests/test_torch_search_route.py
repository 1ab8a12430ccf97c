"""The search's one route per comparator (search/processor.py) on the CPU,
one torch thread, at q95:

  * the variables that once chose the route (GUETZLI_TPU_TREE_QUANT,
    _SPARSE, _SPECULATE, _PIPELINE, _NO_INCR_SAVE, _NO_HISTO_REUSE) change
    nothing: bees96x64's bytes, quant waves and iteration count under
    each equal the default encode's, serially and, for TREE_QUANT=0,
    through the lockstep corpus driver;
  * the CPU's default encode is the card's route: the quant search runs
    in waves, the 4:4:4 back end dispatches sparse deltas of its
    resident coefficients and the 4:2:0 passes whole planes, and the
    bytes equal those of the serial quant loop with the whole-plane back
    end (both forced by a comparator that supports neither), on two
    fixture PNGs, a corpus PNG and a 4:2:0 JPEG;
  * under a mesh (two gloo ranks) the search takes the serial quant
    loop and whole-plane compares, and writes one device's bytes.
"""

import pathlib

import pytest

from tests import torch_ranks
from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, consts
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search.processor import ProcessStats

CORPUS = FIXTURES.parent / "corpus"
BEES = FIXTURES / "bees96x64.png"
RETIRED = [("TREE_QUANT", "0"), ("SPARSE", "0"), ("SPECULATE", "1"),
           ("PIPELINE", "1"), ("PIPELINE", "2"), ("NO_INCR_SAVE", "1"),
           ("NO_HISTO_REUSE", "1")]
ROUTE_INPUTS = {"bees96x64": BEES, "bees97x63": FIXTURES / "bees97x63.png",
                "bees_d": CORPUS / "bees_d.png",
                "bees_d-420": CORPUS / "bees_d-420.jpg"}
DISPATCHES = ("dispatch_compare_sparse_coeffs",
              "dispatch_compare_with_weights")


def _encode(path, stats=None):
    return api.encode_bytes(path.read_bytes(), 95, stats=stats,
                            device="cpu")


def _summary(out, stats):
    c = stats.counters
    return out, c.get("quant_waves", 0), c["iters"]


@pytest.fixture(scope="module")
def baseline():
    """bees96x64's default encode: (bytes, quant_waves, iters)."""
    stats = ProcessStats()
    return _summary(_encode(BEES, stats), stats)


def _unset_retired(monkeypatch):
    for var, _value in RETIRED:
        monkeypatch.delenv("GUETZLI_TPU_" + var, raising=False)


@pytest.mark.parametrize("var,value", RETIRED,
                         ids=["%s=%s" % r for r in RETIRED])
def test_retired_variables_change_nothing(var, value, baseline,
                                          monkeypatch):
    _unset_retired(monkeypatch)
    monkeypatch.setenv("GUETZLI_TPU_" + var, value)
    stats = ProcessStats()
    assert _summary(_encode(BEES, stats), stats) == baseline
    assert baseline[1] > 0


def _count_dispatches(monkeypatch):
    """{Comparator method: calls} of the back end's two dispatches."""
    calls = dict.fromkeys(DISPATCHES, 0)
    for name in DISPATCHES:
        real = getattr(cmp_mod.Comparator, name)

        def spy(self, *a, _name=name, _real=real):
            calls[_name] += 1
            return _real(self, *a)
        monkeypatch.setattr(cmp_mod.Comparator, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(ROUTE_INPUTS))
def test_cpu_default_is_the_card_route(name, monkeypatch):
    path = ROUTE_INPUTS[name]
    _unset_retired(monkeypatch)
    calls = _count_dispatches(monkeypatch)
    stats = ProcessStats()
    out = _encode(path, stats)
    assert stats.search_error is None
    assert stats.counters["quant_waves"] > 0
    iters = stats.counters["backend_iters"]
    sparse, dense = calls.values()
    if name.endswith("-420"):
        assert (sparse, dense) == (0, iters)
    else:
        assert (sparse, dense) == (iters, 0)
    # The same image through the serial quant loop and whole planes.
    monkeypatch.setattr(cmp_mod.Comparator, "supports_quant_batch",
                        lambda self: False)
    monkeypatch.setattr(cmp_mod.Comparator, "supports_sparse",
                        lambda self, img, comp_mask: False)
    calls.update(dict.fromkeys(DISPATCHES, 0))
    serial = ProcessStats()
    assert _encode(path, serial) == out
    assert "quant_waves" not in serial.counters
    assert calls["dispatch_compare_sparse_coeffs"] == 0
    assert serial.counters["iters"] == stats.counters["iters"]


def test_lockstep_ignores_tree_quant_0(monkeypatch):
    corpus = [(p.name, p.read_bytes())
              for p in (BEES, ROUTE_INPUTS["bees_d"])]
    runs = []
    for env in ({}, {"GUETZLI_TPU_TREE_QUANT": "0"}):
        _unset_retired(monkeypatch)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        counters = {}
        out = lockstep.encode_corpus_lockstep(corpus, 95, device="cpu",
                                              counters=counters)
        runs.append((out, counters["quant_waves"]))
    assert runs[0] == runs[1] and runs[0][1] > 0


def _mesh_ranks(group, out):
    """bees96x64 encoded over the group, with its quant loops and
    back-end dispatches counted."""
    calls = dict.fromkeys(DISPATCHES + ("select_quant_matrix_serial",), 0)
    for cls, names in ((cmp_mod.Comparator, DISPATCHES),
                       (proc_mod.Processor, ("select_quant_matrix_serial",))):
        for name in names:
            real = getattr(cls, name)

            def spy(self, *a, _name=name, _real=real):
                calls[_name] += 1
                return _real(self, *a)
            setattr(cls, name, spy)
    rgb, w, h = read_png(BEES.read_bytes())
    params = proc_mod.Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    stats = ProcessStats()
    got = proc_mod.process_rgb(params, rgb, w, h, stats, "cpu", mesh=group)
    res = dict(calls, quant_waves=stats.counters.get("quant_waves", 0),
               backend_iters=stats.counters["backend_iters"],
               search_error=stats.search_error)
    d = pathlib.Path(out)
    (d / ("rank%d.txt" % group.rank)).write_text(repr(res))
    if group.rank == 0:
        (d / "out.jpg").write_bytes(got)


def test_mesh_takes_the_serial_loop_and_whole_planes(tmp_path, baseline):
    torch_ranks.run(2, _mesh_ranks, str(tmp_path))
    for r in range(2):
        res = eval((tmp_path / ("rank%d.txt" % r)).read_text())
        assert res["search_error"] is None
        assert res["quant_waves"] == 0
        assert res["select_quant_matrix_serial"] == 1
        assert res["dispatch_compare_sparse_coeffs"] == 0
        assert res["dispatch_compare_with_weights"] \
            == res["backend_iters"] > 0
    assert (tmp_path / "out.jpg").read_bytes() == baseline[0]
