"""Each metric's arithmetic on a synthetic record, the union of device
intervals, and the roofline count against chip_smoke's for the same
inputs."""

import numpy as np
import pytest

from h100bench.lib import cell, ops_count, trace


def _img(slot, start, wall, pixels, nbytes, profiled=False, **timings):
    return {"slot": slot, "name": "i%d" % slot, "pixels": pixels,
            "start": start, "end": start + wall, "wall": wall,
            "out": b"x" * nbytes, "error": None, "distance": 1.0,
            "search_error": None, "timings": timings, "profiled": profiled,
            "compares": 10}


def _rec(images, batches=(), tr=None, deck=None):
    return {"setup_s": 12.5, "window_start": 100.0, "images": list(images),
            "batches": list(batches), "trace": tr,
            "deck": len({im["slot"] for im in images}) if deck is None
            else deck}


def metric(name):
    return cell.load_metric(name).read


def test_end_to_end():
    ims = [_img(0, 100.0, 2.0, 1_000_000, 250_000),
           _img(1, 102.0, 1.0, 500_000, 100_000),
           _img(2, 103.0, 3.0, 500_000, 150_000)]
    rec = _rec(ims)
    assert metric("mpix_per_s")(rec) == pytest.approx(2.0 / 6.0)
    assert metric("bits_per_px")(rec) == pytest.approx(8 * 500_000 / 2e6)
    assert metric("setup_s")(rec) == 12.5
    ims[1]["out"] = None
    assert metric("mpix_per_s")(_rec(ims)) == pytest.approx(1.5 / 6.0)


def test_bits_per_px_reads_each_deck_entry_once():
    ims = [_img(0, 100.0, 2.0, 1_000_000, 250_000),
           _img(1, 102.0, 1.0, 500_000, 100_000),
           _img(0, 103.0, 2.0, 1_000_000, 999_999),
           _img(1, 105.0, 1.0, 500_000, 1)]
    want = 8 * 350_000 / 1.5e6
    assert metric("bits_per_px")(_rec(ims, deck=2)) == pytest.approx(want)
    assert metric("bits_per_px")(_rec(ims[:2], deck=2)) == \
        pytest.approx(want)
    # A window that never completed an entry of the deck reads nothing.
    assert metric("bits_per_px")(_rec(ims, deck=3)) is None
    ims[0]["out"] = None
    assert metric("bits_per_px")(_rec(ims, deck=2)) == \
        pytest.approx(8 * 1_099_999 / 1.5e6)


def test_host_shares_leave_out_profiled_images():
    ims = [_img(0, 0, 2.0, 1, 1, back_end=1.0, select_quant_matrix=0.5,
                backend_flips=0.25),
           _img(1, 2, 2.0, 1, 1, back_end=1.5, select_quant_matrix=0.1,
                backend_flips=0.3),
           _img(2, 4, 9.0, 1, 1, profiled=True, back_end=9.0)]
    rec = _rec(ims)
    assert metric("search.back_end_share")(rec) == pytest.approx(62.5)
    assert metric("search.quant_share")(rec) == pytest.approx(15.0)
    assert metric("native.flips_share")(rec) == pytest.approx(13.75)
    batches = [{"wall": 10.0, "profiled": True,
                "phase_walls": {"backend": 9.0}, "compares": 5},
               {"wall": 8.0, "profiled": False,
                "phase_walls": {"backend": 6.0}, "compares": 7}]
    assert metric("lockstep.backend_share")(_rec(ims, batches)) == \
        pytest.approx(75.0)
    assert metric("compare.per_mpix")(_rec(ims[:2], batches)) == \
        pytest.approx(12 / 2e-6)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union(iv) == 35
    assert trace.union(iv, 8, 45) == 7 + 10 + 5
    assert trace.gaps(iv, 0, 60) == [(15, 20), (30, 40), (50, 60)]


def test_reduce_and_span_attribution():
    t = 1_000_000
    recs = [
        (trace.MARK, "span", 0, 10, 1),
        ("h100bench.zeroing#0", "span", 100 * t, 200 * t, 1),
        ("aten::copy_", "op", 500 * t, 800 * t, 1),
        ("cudaLaunchKernel", "runtime", 150 * t, 151 * t, 1),
        ("cudaLaunchKernel", "runtime", 195 * t, 196 * t, 1),
        ("cudaMemcpyAsync", "runtime", 160 * t, 161 * t, 1),
        ("queued_before", "device", 90 * t, 110 * t, 0),
        ("zeroing_loop_lanes", "device", 152 * t, 190 * t, 0),
        ("Memcpy HtoD (Pageable -> Device)", "device", 162 * t, 165 * t,
         0),
        ("compare", "device", 252 * t, 262 * t, 0),
        (trace.MARK, "span", 1000 * t, 1000 * t + 10, 1)]
    red = trace.reduce(recs)
    assert red["window_s"] == pytest.approx(1.0, rel=1e-6)
    assert red["busy_s"] == pytest.approx((20 + 38 + 10) / 1000)
    assert red["kernels"] == 3
    assert red["device_ops"][0][0] == "zeroing_loop_lanes"
    labels = dict(red["idle_gaps"])
    assert any(k.startswith("outside spans | aten::copy_") for k in labels)
    assert trace.span_device_ns(recs, {"h100bench.zeroing#0"}) == {
        "h100bench.zeroing#0": 38 * t}
    red["zeroing"] = [{"name": "h100bench.zeroing#0", "mode": "444",
                       "evals": 5_526_102, "bytes": 20_634 * 3000,
                       "blocks": 20_634, "device_s": 0.038}]
    red["compares"] = 1
    rec = _rec([], tr=red)
    share = metric("roofline.zeroing_444")(rec)
    assert share == pytest.approx(100 * ops_count.bound_s(
        "444", 5_526_102, 20_634 * 3000)[0] / 0.038)
    assert metric("roofline.zeroing_420")(rec) is None
    assert metric("device.idle_share")(rec) == pytest.approx(
        100 * (1 - 0.068))
    assert metric("compare.launches_per_compare")(rec) == 3


def test_ops_count_matches_chip_smoke():
    import chip_smoke
    for mode in ("444", "420y", "420c", "444p"):
        assert ops_count.compare_block_ops(mode) == \
            chip_smoke.compare_block_ops(mode)
        assert ops_count.greedy_bytes(mode) == chip_smoke.greedy_bytes(mode)
        ms, by = chip_smoke.bound_ms(mode, 123_456, 7_890_000)
        s, by2 = ops_count.bound_s(mode, 123_456, 7_890_000)
        assert (s * 1e3, by2) == (pytest.approx(ms), by)


@pytest.mark.parametrize("mask,mode", [(7, "444"), (1, "420y"),
                                       (6, "420c")])
def test_evaluations_from_the_zeroing_inputs(mask, mode):
    """zeroing_work's count equals chip_smoke's 3 n - 3 over the n of the
    program's own loop_inputs (its finite candidate scores) for the same
    call's inputs."""
    from guetzli_tpu_torch.search import zeroing
    rng = np.random.default_rng(mask)
    blocks = rng.integers(-3, 4, (50, 3, 64)).astype(np.int32)
    blocks[rng.random(blocks.shape) < 0.6] = 0
    blocks[7] = 0
    blocks[8, :, 1:] = 0
    blocks[8, 0, 5] = 2
    scores = zeroing.candidate_scores_host(blocks, blocks * 2, mask)
    nrem = np.isfinite(scores).sum(axis=1)
    want = int(np.where(nrem >= 2, 3 * nrem - 3, nrem).sum())
    evals, nbytes, nb = ops_count.zeroing_work(blocks, mask, mode)
    assert (evals, nb) == (want, 50)
    assert nbytes == 50 * ops_count.greedy_bytes(mode)
