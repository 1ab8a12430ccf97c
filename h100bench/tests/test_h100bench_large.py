"""The png444_q95_large cell's own files: its source is photo_mosaic1
mirror-tiled 2x2, pixel for pixel; each group of its deck holds both
image sizes; and its two per-layer metrics, search.return_memory_share
and search.recover_share, read nothing from a program without their
spans, 0 where the spans stayed at 0.0, and the span's share of the
unprofiled images' walls otherwise, also from a CPU run of a tiny
serial cell."""

import json
import sys
import time

import numpy as np
import pytest
from PIL import Image

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell, traffic  # noqa: E402

CELL = "png444_q95_large.photo_serial"
METRICS = {"search.return_memory_share": "return_memory",
           "search.recover_share": "recover"}


def _img(wall, profiled=False, **timings):
    return {"wall": wall, "out": b"x", "profiled": profiled,
            "timings": timings}


def _rec(images):
    return {"images": list(images), "batches": []}


def test_source_is_the_mirror_tile():
    src = minibench.BENCH / "sources"
    a = np.asarray(Image.open(src / "photo_mosaic1.png").convert("RGB"))
    c = np.concatenate([a, a[:, ::-1]], 1)
    c = np.concatenate([c, c[::-1]], 0)
    with Image.open(src / "photo_mosaic1_mirror2x2.png") as im:
        got = np.asarray(im.convert("RGB"))
    assert got.shape == (1816, 2888, 3)
    assert np.array_equal(got, c)


def test_each_group_holds_both_sizes():
    bench = json.loads((minibench.ROOT / "BENCHMARK.json").read_text())
    _wl, config, t = cell.find_cell(bench, CELL)
    sizes = {(e.get("out_w", e["w"]), e.get("out_h", e["h"]))
             for e in t["deck"]}
    assert sizes == {(2048, 1536), (3072, 2048)}
    items = traffic.generate(t, config, 2**31 + 12345)
    g = t["group"]
    for k in range(0, len(items), g):
        assert {(x["width"], x["height"]) for x in items[k:k + g]} == sizes


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_shares(name):
    read = cell.load_metric(name).read
    key = METRICS[name]
    assert read(_rec([_img(2.0, back_end=1.0)])) is None
    assert read(_rec([_img(2.0, profiled=True, **{key: 1.0}),
                      _img(3.0, back_end=1.0)])) is None
    assert read(_rec([_img(2.0, **{key: 0.0}),
                      _img(3.0, **{key: 0.0})])) == 0.0
    assert read(_rec([_img(2.0, **{key: 0.5}),
                      _img(9.0, profiled=True, **{key: 9.0}),
                      _img(3.0, **{key: 0.25})])) == pytest.approx(15.0)


def test_a_cpu_run_reads_zero(tmp_path):
    bench, root, bench_dir = minibench.make(tmp_path)
    _res, rec = cell.run_cell(bench, "serial444", 4_100_000_019, 0.01,
                              False, time.perf_counter(), device="cpu",
                              root=root, bench_dir=bench_dir, warm=False)
    for name in METRICS:
        assert cell.load_metric(name, bench_dir).read(rec) == 0.0


def test_whole_deck_entry_completes_every_entry(tmp_path):
    # A window shorter than one image still encodes each deck entry once,
    # so bits_per_px reads.
    bench, root, bench_dir = minibench.make(tmp_path)
    path = bench_dir / "traffic" / "png444_q95.tiny.json"
    t = json.loads(path.read_text())
    path.write_text(json.dumps(dict(t, entry="encode_bytes_whole_deck")))
    res, rec = cell.run_cell(bench, "serial444", 3_900_000_007, 0.0, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert sorted(im["slot"] for im in rec["images"]) == [0, 1]
    assert all(im["out"] is not None for im in rec["images"])
    assert res["correct"] and "bits_per_px" in res["metrics"]


def test_large_cell_uses_the_whole_deck_entry():
    bench = json.loads((minibench.ROOT / "BENCHMARK.json").read_text())
    _wl, _config, t = cell.find_cell(bench, CELL)
    assert t["entry"] == "encode_bytes_whole_deck"
    assert cell.load_entry(t["entry"]).window
