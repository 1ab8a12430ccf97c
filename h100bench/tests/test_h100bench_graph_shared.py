"""compare.graph_shared_share: its arithmetic on synthetic records
(profiled batches left out, nothing read from a program without the
counter), and the metric read from a CPU run of the tiny lockstep cell,
whose batches hold two thumbnails of one size, the program's graphs
replaced by a stub that runs the chain again at each replay."""

import sys
import time

import pytest

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell  # noqa: E402
from h100bench.tests.test_h100bench_compare_graphs import (  # noqa: E402,F401
    graphs_on_the_cpu)

KEYS = ("compare_graph_captures", "compare_graph_replays", "compare_eager",
        "compare_graph_shared")


def _batch(counters, profiled=False):
    return {"wall": 1.0, "profiled": profiled, "phase_walls": {},
            "counters": dict(zip(KEYS, counters))}


def _read(batches):
    return cell.load_metric("compare.graph_shared_share").read(
        {"images": [], "batches": batches})


def test_shared_share_counts_the_unprofiled_batches():
    bs = [_batch((10, 0, 10, 0), profiled=True),
          _batch((2, 6, 2, 4)), _batch((1, 8, 1, 8))]
    assert _read(bs) == pytest.approx(60.0)
    assert _read([_batch((0, 0, 4, 0))]) == 0.0


def test_a_program_without_the_counter_reads_nothing():
    parent = [{"wall": 1.0, "profiled": False, "phase_walls": {},
               "counters": dict(zip(KEYS[:3], (2, 6, 2)))}]
    assert _read(parent) is None
    assert _read([]) is None
    assert _read([_batch((1, 1, 1, 1), profiled=True)]) is None


@pytest.fixture
def no_cached_graphs():
    """The graph cache is the process's: a run starts and ends without
    graphs another test captured."""
    from guetzli_tpu_torch import compare_graphs
    compare_graphs._caches.clear()
    yield
    compare_graphs._caches.clear()


def test_read_from_a_cpu_run(tmp_path, no_cached_graphs, graphs_on_the_cpu):
    bench, root, bench_dir = minibench.make(tmp_path)
    names = [m["name"] for m in cell.metrics_for(bench, "lock444", True)]
    assert "compare.graph_shared_share" in names
    res, rec = cell.run_cell(bench, "lock444", 4_100_000_037, 0.01, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert res["correct"]
    share = cell.load_metric("compare.graph_shared_share", bench_dir).read(
        rec)
    assert share is not None and 0 < share < 100
