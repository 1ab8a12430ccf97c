"""The jpeg420_q95_large.photo_serial and jpeg420_q95.thumbs_lockstep
cells' own files: their decks are their 4:4:4 twins' crop for crop and
each large group holds both image sizes; the configuration states its
cut; the two per-layer metrics, codec.input_decode_share and
compare.upload_share, read nothing from a program without their spans
and the spans' share of the unprofiled walls otherwise; and a tiny
4:2:0 JPEG cell of two sizes (one upscaled 1.5x) through the whole-deck
entry and a tiny 4:2:0 lockstep cell, both run on the CPU, are judged
correct by the reference and read both metrics."""

import json
import sys
import time

import pytest

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell, traffic  # noqa: E402

BENCH = json.loads((minibench.ROOT / "BENCHMARK.json").read_text())
LARGE = "jpeg420_q95_large.photo_serial"
THUMBS = "jpeg420_q95.thumbs_lockstep"
TWINS = {LARGE: "png444_q95_large.photo_serial",
         THUMBS: "png444_q95.thumbs_lockstep"}
METRICS = {"codec.input_decode_share": "input_decode",
           "compare.upload_share": "compare_upload"}


def _img(wall, profiled=False, **timings):
    return {"wall": wall, "out": b"x", "profiled": profiled,
            "timings": timings}


def _batch(wall, profiled=False, **walls):
    return {"wall": wall, "profiled": profiled, "phase_walls": walls}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_decks_are_the_twins(name):
    _wl, config, t = cell.find_cell(BENCH, name)
    _wl, _c, twin = cell.find_cell(BENCH, TWINS[name])
    for key in ("entry", "deck", "group", "jitter", "flip", "check"):
        assert t[key] == twin[key], key
    assert config["input"] == {"kind": "jpeg", "subsampling": "420",
                               "quality": 90}
    assert config["output"] == {"subsampling": "420"}


def test_each_large_group_holds_both_sizes_as_jpegs():
    _wl, config, t = cell.find_cell(BENCH, LARGE)
    assert t["entry"] == "encode_bytes_whole_deck" and t["group"] == 2
    sizes = {(e.get("out_w", e["w"]), e.get("out_h", e["h"]))
             for e in t["deck"]}
    assert sizes == {(2048, 1536), (3072, 2048)}
    small = dict(t, deck=[dict(e, w=e["w"] // 16, h=e["h"] // 16,
                               **({"out_w": e["out_w"] // 16,
                                   "out_h": e["out_h"] // 16}
                                  if "out_w" in e else {}))
                          for e in t["deck"]])
    items = traffic.generate(small, config, 2**31 + 24)
    for k in range(0, len(items), t["group"]):
        assert len({(x["width"], x["height"])
                    for x in items[k:k + t["group"]]}) == 2
    assert all(x["data"][:2] == b"\xff\xd8" for x in items)


def test_configuration_states_its_cut():
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "jpeg420_q95_large")
    cfg = json.loads((minibench.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == ["image_mpix"]
    assert cfg["image_mpix"]["source"] == 12.19
    assert cfg["image_mpix"]["run"] == [3.15, 6.29]
    assert cfg["reference"].startswith("h100bench/reference/")
    assert len(cfg["assumed"]) == 4


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_shares(name):
    read = cell.load_metric(name).read
    key = METRICS[name]
    rec = {"images": [_img(2.0, back_end=1.0)], "batches": []}
    assert read(rec) is None
    rec = {"images": [_img(2.0, **{key: 0.5}),
                      _img(9.0, profiled=True, **{key: 9.0}),
                      _img(3.0, **{key: 0.25})], "batches": []}
    assert read(rec) == pytest.approx(15.0)
    rec = {"images": [_img(20.0, **{key: 20.0})],
           "batches": [_batch(10.0, profiled=True, **{key: 9.0}),
                       _batch(8.0, **{key: 2.0}),
                       _batch(12.0, **{key: 1.0})]}
    assert read(rec) == pytest.approx(15.0)
    rec["batches"] = [_batch(8.0, backend=2.0)]
    assert read(rec) is None


def _tiny(tmp_path):
    """minibench with a tiny large cell (two sizes, one upscaled 1.5x,
    through the whole-deck entry) and a tiny 4:2:0 lockstep cell."""
    bench, root, bench_dir = minibench.make(tmp_path)
    deck = [{"source": "photo_mosaic1_mirror2x2", "x": 1500, "y": 900,
             "w": 48, "h": 40},
            {"source": "photo_mosaic1_mirror2x2", "x": 400, "y": 200,
             "w": 40, "h": 32, "out_w": 60, "out_h": 48}]
    large = json.loads((minibench.BENCH / "traffic" / ("%s.json" % LARGE))
                       .read_text())
    large = dict(large, deck=deck, check=2)
    thumbs = json.loads((minibench.BENCH / "traffic"
                         / ("%s.json" % THUMBS)).read_text())
    thumbs = dict(thumbs, batch=2, group=2, check=2,
                  deck=[dict(e, out_w=40, out_h=32)
                        for e in minibench.TINY])
    for name, t in (("jpeg420_q95_large.tiny", large),
                    ("jpeg420_q95.tinylock", thumbs)):
        (bench_dir / "traffic" / (name + ".json")).write_text(
            json.dumps(t))
    bench["workloads"] = bench["workloads"] + [
        {"name": "large420", "config": "jpeg420_q95_large",
         "traffic": "tiny", "chips": 1, "why": "test"},
        {"name": "lock420", "config": "jpeg420_q95", "traffic": "tinylock",
         "chips": 1, "why": "test"}]
    return bench, root, bench_dir


@pytest.mark.parametrize("workload,seed", [("large420", 2_400_000_011),
                                           ("lock420", 2_400_000_017)])
def test_tiny_cells_run_correct_and_read_both(tmp_path, workload, seed):
    bench, root, bench_dir = _tiny(tmp_path)
    res, rec = cell.run_cell(bench, workload, seed, 0.0, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and "bits_per_px" in res["metrics"]
    assert rec["check"]["judged"] == 2
    if workload == "large420":
        assert sorted(im["pixels"] for im in rec["images"]) == \
            [48 * 40, 60 * 48]
    for name in METRICS:
        v = cell.load_metric(name, bench_dir).read(rec)
        assert v is not None and 0.0 < v < 100.0, (name, v)
