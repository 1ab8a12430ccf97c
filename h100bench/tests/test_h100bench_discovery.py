"""Discovery by file name, and BENCHMARK.json against the rules of its
format: a cell, a traffic mix or a metric is added as files and
entries, with no edit to a file that exists."""

import json
import re
import time

import pytest

from h100bench.lib import cell
from h100bench.tests import minibench

BENCH = json.loads((minibench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in metrics])
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    n = 24
    assert 2 + 14 * n * (BENCH["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e = [m["name"] for m in cell.metrics_for(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics_for(BENCH, w["name"], True)
        wl, config, traffic = cell.find_cell(BENCH, w["name"])
        assert cell.load_entry(traffic["entry"]).window


def test_metric_files_agree_with_benchmark_json():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = cell.load_metric(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if m["name"] not in e2e:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
            assert m["moves"] in e2e


def test_configs_hold_no_other_keys_cut():
    for c in BENCH["configs"]:
        cfg = json.loads((minibench.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("h100bench/configs/")


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A test-only configuration (a copy under a new name), traffic mix
    and per-layer metric, added as files and entries alone, run."""
    src = ("UNIT = '1'\nLAYER = 'entry'\nMOVES = 'mpix_per_s'\n\n\n"
           "def read(rec):\n    return float(len(rec['images']))\n")
    bench, root, bench_dir = minibench.make(tmp_path,
                                            ("test.images", src))
    cfg = json.loads((bench_dir / "configs" / "png444_q95.json")
                     .read_text())
    cfg["name"] = "testcfg"
    (bench_dir / "configs" / "testcfg.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "testcfg.testmix.json").write_text(
        (bench_dir / "traffic" / "png444_q95.tiny.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="testcfg",
                                 file="bench/configs/testcfg.json"))
    bench["workloads"].append({"name": "testcfg.testmix",
                               "config": "testcfg", "traffic": "testmix",
                               "chips": 1, "why": "test"})
    wl, config, traffic = cell.find_cell(bench, "testcfg.testmix", root,
                                         bench_dir)
    assert config["name"] == "testcfg" and traffic["entry"]
    names = [m["name"] for m in cell.metrics_for(bench, "testcfg.testmix",
                                                 True)]
    assert "test.images" in names
    res, rec = cell.run_cell(bench, "testcfg.testmix", 5, 0.01, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench_dir=bench_dir, warm=False)
    assert res["correct"]
    assert cell.load_metric("test.images", bench_dir).read(rec) == \
        len(rec["images"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cell.find_cell(BENCH, "no.such.cell")
