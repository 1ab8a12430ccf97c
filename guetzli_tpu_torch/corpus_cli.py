"""Encode a directory (or a list of files) of images.

Port of tools/corpus_encode.py.

  python -m guetzli_tpu_torch.corpus_cli --quality Q --out DIR inputs...

An input that is a directory stands for its .png, .jpg and .jpeg files.
The corpus is encoded by the lockstep encoder (parallel/lockstep.py: the
search of every image in phase, one greedy launch per masking pass for
the whole corpus), or one image at a time with --serial (api
.encode_corpus); both give each image the bytes of its own encode. Each
output is DIR/<input stem>.jpg, or DIR/<input name>.jpg where two inputs
share a stem (photo.png and photo.jpg). Runs on the CUDA device; --cpu
runs on the CPU instead. --num-hosts N --host-index I encode only every N-th
file from the I-th: a corpus split over N machines, each running its
own instance. --verbose writes each image's size and, for the lockstep
encoder, the phase walls to stderr.

Prints one JSON line: host, images, encoded, bytes, wall_s,
images_per_min. Exits 1 when an image was not encoded.
"""

import argparse
import json
import pathlib
import sys
import time


def output_names(names):
    """Input file name -> output file name: the stem + ".jpg", or the
    whole name + ".jpg" for inputs whose stems collide."""
    stems = [pathlib.Path(n).stem for n in names]
    return {n: (s if stems.count(s) == 1 else n) + ".jpg"
            for n, s in zip(names, stems)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m guetzli_tpu_torch.corpus_cli")
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--quality", type=float, default=95)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="not ported yet (the multi-GPU slice)")
    ap.add_argument("--coordinator", default=None,
                    help="not ported yet (the multi-GPU slice)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--threads", type=int, default=None,
                    help="threads of the per-image host work (default: "
                         "one per image up to 16; 1 with --serial)")
    ap.add_argument("--serial", action="store_true",
                    help="encode one image at a time instead of in "
                         "lockstep (the same bytes)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.distributed or args.coordinator:
        sys.stderr.write("--distributed and --coordinator are not ported "
                         "yet: they come with the multi-GPU slice of the "
                         "port. Split a corpus over machines with "
                         "--num-hosts and --host-index.\n")
        return 1
    if not 0 <= args.host_index < args.num_hosts:
        sys.stderr.write("--host-index must lie in [0, --num-hosts)\n")
        return 1

    from guetzli_tpu_torch.device import resolve
    try:
        dev = resolve("cpu" if args.cpu else None)
    except RuntimeError as e:
        sys.stderr.write("%s\n" % e)
        return 1

    paths = []
    for p in map(pathlib.Path, args.inputs):
        if p.is_dir():
            paths.extend(sorted(
                q for q in p.iterdir()
                if q.suffix.lower() in (".png", ".jpg", ".jpeg")))
        else:
            paths.append(p)
    mine = [p for i, p in enumerate(paths)
            if i % args.num_hosts == args.host_index]
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    items = [(p.name, p.read_bytes()) for p in mine]
    if args.serial:
        from guetzli_tpu_torch.api import encode_corpus
        results = [(n, d) for n, d, _s in encode_corpus(
            items, quality=args.quality, verbose=args.verbose,
            threads=args.threads or 1, device=dev)]
    else:
        from guetzli_tpu_torch.parallel.lockstep import encode_corpus_lockstep
        walls = {}
        results = encode_corpus_lockstep(
            items, quality=args.quality,
            threads=args.threads or max(1, min(len(items), 16)),
            phase_walls=walls, device=dev)
        if args.verbose:
            for name, data in results:
                sys.stderr.write("%s: %d bytes\n"
                                 % (name, len(data) if data else 0))
            sys.stderr.write("phase walls: %s\n" % json.dumps(walls))
    wall = time.time() - t0

    ok = total = 0
    out_names = output_names([n for n, _d in results])
    for name, data in results:
        if data is None:
            continue
        (out_dir / out_names[name]).write_bytes(data)
        ok += 1
        total += len(data)
    print(json.dumps({
        "host": args.host_index, "images": len(mine), "encoded": ok,
        "bytes": total, "wall_s": round(wall, 2),
        "images_per_min": round(60.0 * ok / wall, 2) if wall else None,
    }))
    return 0 if ok == len(mine) else 1


if __name__ == "__main__":
    sys.exit(main())
