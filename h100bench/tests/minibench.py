"""A benchmark directory of tiny cells for the CPU tests.

It holds BENCHMARK.json, configs/ (copies of the real ones), traffic/
(tiny decks of the real sources) and the real entries/ and metrics/
(copied), so the harness's own discovery finds everything by name, as
it does in the real h100bench/.
"""

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = [{"source": "photo_hopper", "x": 100, "y": 100, "w": 48, "h": 40},
        {"source": "photo_mosaic1", "x": 300, "y": 200, "w": 56, "h": 48}]


def make(tmp, extra_metric=None):
    """Write the tiny benchmark under `tmp`; returns (bench, root,
    bench_dir) for cell.run_cell. Cells: "serial444" (PNG, encode_bytes),
    "serial420" (4:2:0 JPEG, encode_bytes) and "lock444" (PNG
    thumbnails, batches of 2 through the lockstep driver)."""
    tmp = pathlib.Path(tmp)
    bench_dir = tmp / "bench"
    for sub in ("configs", "traffic"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "entries", bench_dir / "entries")
    shutil.copytree(BENCH / "metrics", bench_dir / "metrics")
    for f in (BENCH / "configs").glob("*.json"):
        shutil.copy(f, bench_dir / "configs" / f.name)
    serial = {"entry": "encode_bytes", "deck": TINY, "group": 2,
              "jitter": 8, "flip": 0.5, "check": 2, "trace_images": 1,
              "limits": {"dist_gap": 1e-3, "dist_over_target": 2e-3}}
    lock = dict(serial, entry="encode_corpus_lockstep", batch=2,
                deck=[dict(e, out_w=40, out_h=32) for e in TINY])
    for name, t in (("png444_q95.tiny", serial),
                    ("jpeg420_q95.tiny", serial),
                    ("png444_q95.tinylock", lock)):
        (bench_dir / "traffic" / (name + ".json")).write_text(json.dumps(t))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = dict(real)
    bench["configs"] = [dict(c, file="bench/configs/%s.json" % c["name"])
                        for c in real["configs"]]
    bench["workloads"] = [
        {"name": "serial444", "config": "png444_q95", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "serial420", "config": "jpeg420_q95", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "lock444", "config": "png444_q95", "traffic": "tinylock",
         "chips": 1, "why": "test"}]
    bench["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                           for m in real["end_to_end"]]
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in real["per_layer"]]
    if extra_metric is not None:
        name, source = extra_metric
        (bench_dir / "metrics" / (name + ".py")).write_text(source)
        bench["per_layer"].append(
            {"name": name, "unit": "1", "better": "higher",
             "source": "program_counter", "layer": "entry",
             "moves": "mpix_per_s"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, tmp, bench_dir
