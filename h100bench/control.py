"""Readings that set the limits of a cell's check, on many seeds in one
process: the program's own, its lower-precision control's, and those of
a fault planted in the program.

  python3 h100bench/control.py --workload <cell> --seeds 1,2,3
      [--seconds 12] [--control] [--fault over_target|tf32]

Each seed runs the cell as h100bench/run.py does (its inputs, its
warm-up on the first seed, a window of --seconds at the cell's own
load, the same check) and prints one JSON line with `correct`, every
number the check reads (dist_over_target, dist_gap and dist_gap_mean,
whether or not the cell compares them) and the window's bits_per_px.
With --control the line also holds `control_correct`, `control_gap`
and `control_gap_mean`: the check's judgement with the control in the
program's place on the same outputs, the reference computed with its
contractions in TF32 (h100bench/reference/tf32.py), the precision next
below the configuration's float32. --fault plants a fault in the
program for the whole process:

  over_target  the search's butteraugli target raised by 1% (a search
               that accepts outputs over the quality's target and
               reports their distances honestly);
  tf32         the program's matrix products and convolutions in TF32
               (device.resolve's switches held on): a change of float
               rounding, to read how far bits_per_px moves with it.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OVER_TARGET = 1.01


def plant(fault):
    """Plant `fault` (see the module's docstring) in the program."""
    if fault == "over_target":
        from guetzli_tpu_torch import consts
        real = consts.butteraugli_score_for_quality
        consts.butteraugli_score_for_quality = \
            lambda q: real(q) * OVER_TARGET
    elif fault == "tf32":
        import torch

        from guetzli_tpu_torch import api, device
        real = device.resolve

        def resolve(*a, **k):
            dev = real(*a, **k)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            return dev
        device.resolve = api.resolve = resolve
    elif fault is not None:
        raise ValueError("unknown fault %r" % fault)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("over_target", "tf32"))
    args = ap.parse_args(argv)
    from h100bench.lib import cell
    from h100bench.reference import tf32
    bench = cell.load_json(cell.ROOT / "BENCHMARK.json")
    cell.prepare_env()
    import torch
    if not torch.cuda.is_available():
        cell.err("control: no CUDA device")
        return 3
    cell.err("card: %s (nvidia-smi: %s)" % (torch.cuda.get_device_name(0),
                                            cell.card_power_limit()))
    plant(args.fault)
    bits = cell.load_metric("bits_per_px").read
    worst = {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res, rec = cell.run_cell(
            bench, args.workload, seed, args.seconds, False, t0,
            warm=(k == 0), control=tf32.distance if args.control else None)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "correct": res["correct"],
                "judged": rec["check"]["judged"],
                "bits_per_px": bits(rec),
                "seconds": time.perf_counter() - t0}
        for name in ("failed", "codec_faults"):
            line[name] = res["checks"][name]["value"]
        for name in ("dist_over_target", "dist_gap", "dist_gap_mean",
                     "control_correct", "control_gap", "control_gap_mean"):
            if name in rec["check"]:
                line[name] = rec["check"][name]
        for name in ("dist_over_target", "dist_gap", "dist_gap_mean",
                     "control_gap", "control_gap_mean"):
            if line.get(name) is not None:
                worst[name] = max(worst.get(name, line[name]), line[name])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "worst": worst,
                      "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
