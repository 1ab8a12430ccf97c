"""One run of one cell: discovery by name, set-up, the window, the check,
the metrics and the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own, found by the name BENCHMARK.json gives:
  configs/<config>.json          (its path is the configuration's `file`)
  traffic/<config>.<traffic>.json
  entries/<entry>.py             (the traffic file's "entry")
  metrics/<metric>.py            (a reader: read(record) -> number or None)
"""

import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time
import types

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "guetzli_tpu")


def err(*parts):
    sys.stderr.write(" ".join(str(p) for p in parts) + "\n")
    sys.stderr.flush()


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench, workload, root=ROOT, bench_dir=BENCH_DIR):
    """(workload entry, configuration, traffic) of a cell, by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(root / cfg["file"])
    traffic = load_json(bench_dir / "traffic" / (
        "%s.%s.json" % (wl["config"], wl["traffic"])))
    return wl, config, traffic


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name, bench_dir=BENCH_DIR):
    return load_module(bench_dir / "entries" / ("%s.py" % name),
                       "h100bench_entry_" + name)


def load_metric(name, bench_dir=BENCH_DIR):
    return load_module(bench_dir / "metrics" / ("%s.py" % name),
                       "h100bench_metric_" + name.replace(".", "_"))


def metrics_for(bench, workload, traced):
    """The metric entries a run of `workload` reports: end-to-end
    untraced, per-layer traced; those with a "workloads" key only in the
    cells it lists."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def prepare_env():
    """The card's defaults for the program, and every build and kernel
    cache at a fixed path inside the checkout."""
    for k in list(os.environ):
        if k.startswith("GUETZLI_TPU_"):
            del os.environ[k]
    cache = ROOT / ".h100bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def card_power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_cell(bench, workload, seed, seconds, traced, t_start, device=None,
             root=ROOT, bench_dir=BENCH_DIR, warm=True, control=None):
    """Set-up, window and check of one cell on the current machine: the
    result dict (without `device`) and the run's record. Raises nothing
    for an image's failure (it is counted). `device`: the program's
    (None: the card; "cpu" for the CPU tests). `root` holds the
    configurations' files, `bench_dir` the traffic, entries and
    metrics. `warm` False skips the warm-up (a process's later runs);
    `control` is handed to check.judge."""
    import torch

    from h100bench.lib import check, instrument, ops_count, trace
    from h100bench.lib import traffic as traffic_mod
    _wl, config, traffic = find_cell(bench, workload, root, bench_dir)
    import guetzli_tpu_torch  # noqa: F401  (fails outside a checkout)
    from guetzli_tpu_torch.kernels import build
    items = traffic_mod.generate(traffic, config, seed)
    entry = load_entry(traffic["entry"], bench_dir)
    inst = instrument.Instruments(traced).install()
    ctx = types.SimpleNamespace(items=items, config=config,
                                traffic=traffic, quality=config["quality"],
                                inst=inst, traced=traced, sub_compares=0,
                                device=device, sync=_sync)
    try:
        if warm:
            entry.warm(ctx)
        inst.take_compares()
        inst.zeroing.clear()
        for name, b in sorted(build.build_log.items()):
            err("build: %s %.2f s (nvcc, this run)" % (name, b["seconds"]))
        setup_s = time.perf_counter() - t_start
        images, batches, w0 = entry.window(ctx, seconds)
        inst.stop_profile()
    finally:
        inst.uninstall()
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    records = inst.records
    inst.records = None
    del inst.comparators[:]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    red = None
    if records:
        red = trace.reduce(records)
        names = {z["name"] for z in inst.zeroing}
        dev = trace.span_device_ns(records, names)
        red["zeroing"] = [dict(z, device_s=dev[z["name"]] / 1e9)
                          for z in inst.zeroing if z["name"] in dev]
        red["compares"] = ctx.sub_compares
        for z in red["zeroing"]:
            err("trace: %s mode %s, %d blocks, %d evaluations, device "
                "%.6f s, least %.6f s" % (
                    z["name"], z["mode"], z["blocks"], z["evals"],
                    z["device_s"], ops_count.bound_s(
                        z["mode"], z["evals"], z["bytes"])[0]))
        del records
    rec = {"setup_s": setup_s, "window_start": w0, "images": images,
           "batches": batches, "trace": red, "deck": len(items)}
    # Each image's (or batch's) wall beside the host CPU time the process
    # spent in it: which of the two moves when a run is slow.
    for k, b in enumerate(batches or images):
        err("timed %d %s wall %.4f s cpu %.4f s" % (
            k, b.get("name", "batch of %d" % b.get("images", 0)),
            b["wall"], b.get("cpu", float("nan"))))
    done = [im for im in images if im["out"] is not None]
    err("window: %d images started, %d completed%s, %.3f s"
        % (len(images), len(done),
           " in %d batches" % len(batches) if batches else "",
           max(im["end"] for im in images) - w0))
    if red is not None:
        err("trace: sub-window %.3f s, device busy %.3f s, %d kernels, "
            "%d compares, %d zeroing calls"
            % (red["window_s"], red["busy_s"], red["kernels"],
               red["compares"], len(red["zeroing"])))
    result = {"correct": False, "attempted": len(images), "failed": None,
              "metrics": {}}
    for m in metrics_for(bench, workload, traced):
        v = load_metric(m["name"], bench_dir).read(rec)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["memory_peak_bytes"] = peak
    if red is not None:
        result["busy_s"] = red["busy_s"]
        result["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    t0 = time.perf_counter()
    correct, numbers, info = check.judge(images, items, config, traffic,
                                         seed, control)
    err("check: %d outputs judged by the reference in %.1f s; widest gap "
        "%r, mean gap %r; reference distance over target, worst: %s"
        % (info["judged"], time.perf_counter() - t0, info["dist_gap"],
           info["dist_gap_mean"], info["dist_over_target"]))
    for d in info["detail"]:
        err("  judged", *d)
    result["correct"] = correct
    result["failed"] = numbers["failed"]["value"]
    result["checks"] = numbers
    rec["check"] = info
    return result, rec


def main(args, t_start):
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        err("h100bench: no BENCHMARK.json at", ROOT)
        return 2
    bench = load_json(bench_path)
    try:
        wl, _config, _traffic = find_cell(bench, args.workload)
    except (KeyError, StopIteration, OSError) as e:
        err("h100bench:", e)
        return 2
    prepare_env()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        err("h100bench: the cell needs %d CUDA device(s); this machine has "
            "%d" % (wl["chips"], torch.cuda.device_count()
                    if torch.cuda.is_available() else 0))
        return 3
    kind = torch.cuda.get_device_name(0)
    err("card: %s (nvidia-smi: %s)" % (kind, card_power_limit()))
    try:
        result, _rec = run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), t_start)
    except ImportError as e:
        err("h100bench: the program is not importable here:", e)
        return 2
    bad = forbidden_modules()
    if bad:
        err("h100bench: the process holds forbidden modules:",
            ", ".join(bad))
        return 4
    if args.trace and "busy_s" not in result:
        err("h100bench: the traced run recorded no device activity")
        return 5
    device = {"platform": "gpu", "kind": kind, "count": wl["chips"],
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    checks = result.pop("checks")
    out = dict(result, device=device, checks=checks)
    for name, c in checks.items():
        err("check %s = %r (limit %r)" % (name, c["value"], c["limit"]))
    print(json.dumps(out))
    return 0
