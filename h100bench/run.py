"""The benchmark of guetzli_tpu_torch on one card: one run of one cell.

  python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. Makes
the cell's inputs from the seed, warms up every image size they hold,
measures for --seconds seconds (the image or batch in flight then
completes and counts), judges the outputs against the plain reference
(h100bench/reference/) and prints the result as the last line of
standard output, one JSON object; each number the check compares is
printed beside its limit as the last lines of standard error. With
--trace 1 it reports the cell's per-layer metrics from a torch.profiler
trace of a steady sub-window instead of the end-to-end ones. Exits
non-zero with no result when no CUDA device is present, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from h100bench.lib import cell
    return cell.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
