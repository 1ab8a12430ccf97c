"""The compare graphs' metrics compare.capture_share and
compare.graph_replay_share: their arithmetic on synthetic records
(profiled images and batches left out, nothing read from a program
without the span or the counters), and both read from CPU runs of a
tiny serial and a tiny lockstep cell, the program's graphs replaced by
a stub that runs the chain again at each replay (the CPU has no CUDA
graphs)."""

import sys
import time

import pytest

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell  # noqa: E402

KEYS = ("compare_graph_captures", "compare_graph_replays", "compare_eager")


def _img(wall, profiled=False, **timings):
    return {"wall": wall, "out": b"x", "profiled": profiled,
            "timings": timings}


def _batch(wall, counters=None, profiled=False, **walls):
    b = {"wall": wall, "profiled": profiled, "phase_walls": walls}
    if counters is not None:
        b["counters"] = dict(zip(KEYS, counters))
    return b


def _rec(images=(), batches=()):
    return {"images": list(images), "batches": list(batches)}


def metric(name):
    return cell.load_metric(name).read


def test_capture_share_leaves_out_profiled_images_and_batches():
    ims = [_img(2.0, compare_capture=0.5), _img(3.0, compare_capture=0.25),
           _img(9.0, profiled=True, compare_capture=9.0)]
    assert metric("compare.capture_share")(_rec(ims)) == pytest.approx(15.0)
    bs = [_batch(10.0, profiled=True, compare_capture=9.0),
          _batch(8.0, compare_capture=2.0), _batch(12.0, compare_capture=1.0)]
    assert metric("compare.capture_share")(_rec(ims, bs)) == \
        pytest.approx(15.0)


def test_replay_share_counts_the_unprofiled_batches():
    bs = [_batch(1.0, (10, 0, 10), profiled=True),
          _batch(1.0, (2, 6, 2)), _batch(1.0, (1, 8, 1))]
    assert metric("compare.graph_replay_share")(_rec((), bs)) == \
        pytest.approx(70.0)
    assert metric("compare.graph_replay_share")(
        _rec((), [_batch(1.0, (0, 0, 4))])) == 0.0


def test_a_program_without_graphs_reads_nothing():
    ims = [_img(2.0, compare_dispatch=1.0)]
    bs = [_batch(5.0, backend=4.0), _batch(5.0, profiled=True,
                                           compare_capture=1.0)]
    bs[0]["counters"] = {"compares": 12}
    for name in ("compare.capture_share", "compare.graph_replay_share"):
        assert metric(name)(_rec(ims, bs)) is None
        assert metric(name)(_rec()) is None
    assert metric("compare.capture_share")(_rec(ims)) is None


class _StubGraph:
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
def graphs_on_the_cpu(monkeypatch):
    from guetzli_tpu_torch import compare_graphs, comparator
    monkeypatch.setattr(compare_graphs.CompareGraphs, "graph_class",
                        _StubGraph)
    init = comparator.Comparator.__init__

    def graphed_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._graphs.enabled = True
    monkeypatch.setattr(comparator.Comparator, "__init__", graphed_init)


@pytest.mark.parametrize("workload", ["serial444", "lock444"])
def test_both_read_from_a_cpu_run(tmp_path, workload, graphs_on_the_cpu):
    bench, root, bench_dir = minibench.make(tmp_path)
    names = [m["name"] for m in cell.metrics_for(bench, workload, True)]
    assert "compare.capture_share" in names
    res, rec = cell.run_cell(bench, workload, 4_100_000_019, 0.01, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert res["correct"]
    v = cell.load_metric("compare.capture_share", bench_dir).read(rec)
    assert v is not None and 0 < v < 100
    share = cell.load_metric("compare.graph_replay_share", bench_dir).read(
        rec)
    if workload == "lock444":
        assert share is not None and 0 < share < 100
    else:
        assert share is None
