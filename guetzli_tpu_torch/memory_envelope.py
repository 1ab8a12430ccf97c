"""Measure the encoder's memory envelope: process RSS and device memory
against image size.

    python -m guetzli_tpu_torch.memory_envelope [--cpu] [image ...]

Each image is encoded at q95 (process_rgb, the CLI's path for a PNG) in
a fresh process, which reports its peak RSS (ru_maxrss) and, on the card,
torch.cuda.max_memory_allocated over the encode. A least-squares line,
base MB + bytes per pixel, is fitted to each; the CLI's memory guard
warns from the fit (cli.py). An image argument "tile2x2:PATH" is the PNG
at PATH tiled 2x2 in memory. Default images: photo_mosaic1.png
(1444x908), photo_mosaic2.png and photo_mosaic1.png tiled 2x2 (2888x1816).
Prints one JSON line: the card's name and power limit, one row per image
and the two fits.
"""

import json
import pathlib
import subprocess
import sys

_CORPUS = pathlib.Path(__file__).resolve().parent.parent / "tests" / "corpus"
DEFAULT = (str(_CORPUS / "photo_mosaic1.png"),
           str(_CORPUS / "photo_mosaic2.png"),
           "tile2x2:" + str(_CORPUS / "photo_mosaic1.png"))


def _child(image, device):
    import resource
    import time

    import numpy as np
    import torch

    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_rgb)
    dev = resolve(device)
    tile = image.startswith("tile2x2:")
    rgb, w, h = read_png(pathlib.Path(image.split(":", 1)[-1] if tile
                                      else image).read_bytes())
    if tile:
        rgb, w, h = np.ascontiguousarray(np.tile(rgb, (2, 2, 1))), 2 * w, \
            2 * h
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    t0 = time.time()
    out = process_rgb(params, rgb, w, h, ProcessStats(), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "image": image, "pixels": w * h, "bytes": len(out),
        "seconds": time.time() - t0, "rss_before_mb": base,
        "rss_peak_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "device_peak_mb": (torch.cuda.max_memory_allocated(dev) / 2**20
                           if dev.type == "cuda" else None)}))


def fit(xs, ys):
    """Least-squares (base, slope) of ys against xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - slope * mx, slope


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        _child(argv[1], argv[2])
        return 0
    device = "cuda"
    if argv[:1] == ["--cpu"]:
        device, argv = "cpu", argv[1:]
    rows = []
    for image in argv or DEFAULT:
        r = subprocess.run(
            [sys.executable, "-m", "guetzli_tpu_torch.memory_envelope",
             "--child", image, device], capture_output=True, text=True,
            timeout=1200)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return 1
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
    smi = None
    if device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    px = [r["pixels"] for r in rows]
    out = {"card": smi, "rows": rows}
    for key in ("rss_peak_mb", "device_peak_mb"):
        if rows[0][key] is not None and len(set(px)) > 1:
            base, slope = fit(px, [r[key] for r in rows])
            out[key + "_fit"] = {"base_mb": base,
                                 "bytes_per_pixel": slope * 2**20}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
