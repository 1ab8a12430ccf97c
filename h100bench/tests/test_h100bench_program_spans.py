"""The program-span shares compare.dispatch_share and compare.wait_share:
their arithmetic on synthetic records (serial and batch, profiled
images and batches left out, nothing read from a program without the
spans), and both read from an untraced CPU run of a tiny serial and a
tiny lockstep cell."""

import sys
import time

import pytest

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell  # noqa: E402

METRICS = ("compare.dispatch_share", "compare.wait_share")


def _img(wall, profiled=False, **timings):
    return {"wall": wall, "out": b"x", "profiled": profiled,
            "timings": timings}


def _batch(wall, profiled=False, **walls):
    return {"wall": wall, "profiled": profiled, "phase_walls": walls}


def _rec(images=(), batches=()):
    return {"images": list(images), "batches": list(batches)}


def metric(name):
    return cell.load_metric(name).read


def test_serial_shares_leave_out_profiled_images():
    ims = [_img(2.0, compare_dispatch=0.5, compare_wait=0.1),
           _img(3.0, compare_dispatch=0.25, compare_wait=0.4),
           _img(9.0, profiled=True, compare_dispatch=9.0, compare_wait=9.0)]
    assert metric("compare.dispatch_share")(_rec(ims)) == \
        pytest.approx(15.0)
    assert metric("compare.wait_share")(_rec(ims)) == pytest.approx(10.0)


def test_batch_shares_leave_out_profiled_batches():
    bs = [_batch(10.0, profiled=True, compare_dispatch=9.0,
                 compare_wait=1.0),
          _batch(8.0, compare_dispatch=2.0, compare_wait=0.5),
          _batch(12.0, compare_dispatch=3.0, compare_wait=1.5)]
    ims = [_img(20.0, compare_dispatch=20.0)]
    assert metric("compare.dispatch_share")(_rec(ims, bs)) == \
        pytest.approx(25.0)
    assert metric("compare.wait_share")(_rec(ims, bs)) == \
        pytest.approx(10.0)


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_the_spans_reads_nothing(name):
    ims = [_img(2.0, back_end=1.0), _img(1.0, profiled=True,
                                         compare_dispatch=0.5,
                                         compare_wait=0.5)]
    assert metric(name)(_rec(ims)) is None
    bs = [_batch(5.0, backend=4.0), _batch(5.0, profiled=True,
                                           compare_dispatch=1.0,
                                           compare_wait=1.0)]
    assert metric(name)(_rec(ims, bs)) is None
    assert metric(name)(_rec()) is None


@pytest.mark.parametrize("workload", ["serial444", "lock444"])
def test_both_shares_read_from_a_cpu_run(tmp_path, workload):
    bench, root, bench_dir = minibench.make(tmp_path)
    names = [m["name"] for m in cell.metrics_for(bench, workload, True)]
    assert set(METRICS) <= set(names)
    res, rec = cell.run_cell(bench, workload, 4_100_000_017, 0.01, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert res["correct"]
    for name in METRICS:
        v = cell.load_metric(name, bench_dir).read(rec)
        assert v is not None and 0 <= v <= 100, (name, v)
    assert cell.load_metric("compare.dispatch_share", bench_dir).read(
        rec) > 0
