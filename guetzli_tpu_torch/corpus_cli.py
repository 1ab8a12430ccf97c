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
own instance. --distributed joins the process to a torch.distributed
group instead, whose rank and world size take the places of
--host-index and --num-hosts: with --coordinator ADDR (host:port, or a
tcp:// or file:// URL) the group of --num-hosts processes meets there,
this one as rank --host-index; without it the group is torchrun's
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). Each rank encodes its
share on its own device (cuda:{rank % device_count}, or the CPU with
--cpu); the ranks exchange nothing. --verbose writes each image's size
and, for the lockstep encoder, the phase walls to stderr.

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


def init_method(coordinator):
    """torch.distributed's init_method for --coordinator: a tcp:// or
    file:// URL as it is, host:port as tcp://host:port."""
    if coordinator.startswith(("tcp://", "file://")):
        return coordinator
    host, sep, port = coordinator.rpartition(":")
    if not (sep and host and port.isdigit()):
        raise ValueError("--coordinator takes host:port or a tcp:// or "
                         "file:// URL, not %r" % coordinator)
    return "tcp://" + coordinator


def _join(args):
    """Join the group of --distributed: the Group (parallel/dist.py)."""
    import os

    from guetzli_tpu_torch.parallel import dist
    if args.coordinator:
        method, world, rank = (init_method(args.coordinator),
                               args.num_hosts, args.host_index)
    else:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise ValueError("--distributed without --coordinator reads "
                             "RANK and WORLD_SIZE (torchrun) and they are "
                             "not set")
        method, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                               int(os.environ["RANK"]))
    return dist.init(world, rank, method,
                     device="cpu" if args.cpu else None, timeout=300.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m guetzli_tpu_torch.corpus_cli")
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--quality", type=float, default=95)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed group; its rank and "
                         "world size split the file list")
    ap.add_argument("--coordinator", default=None,
                    help="with --distributed: the group's address "
                         "(host:port, or a tcp:// or file:// URL), with "
                         "--num-hosts/--host-index as world size and rank")
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
    if args.coordinator and not args.distributed:
        sys.stderr.write("--coordinator needs --distributed\n")
        return 1
    if not 0 <= args.host_index < args.num_hosts:
        sys.stderr.write("--host-index must lie in [0, --num-hosts)\n")
        return 1

    from guetzli_tpu_torch.device import resolve
    try:
        if args.distributed:
            group = _join(args)
            args.num_hosts, args.host_index = group.world, group.rank
            dev = group.device
        else:
            dev = resolve("cpu" if args.cpu else None)
    except (RuntimeError, ValueError) as e:
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
    if args.distributed:
        from guetzli_tpu_torch.parallel import dist
        dist.shutdown(wait=False)
    return 0 if ok == len(mine) else 1


if __name__ == "__main__":
    sys.exit(main())
