"""Golden rows on the card and on the CPU: output bytes against the
reference encoder's golden sizes (tests/golden_corpus.txt).

    python -m guetzli_tpu_torch.golden_rows [--cpu-procs N] [--prefix P]
        [--qualities 84,90,95] OUT_DIR

For each quality the corpus CLI encodes every tests/corpus/ file whose
name starts with the prefix (default "photo_") on the card, in one run
(``corpus_cli.main``, lockstep, one thread per image up to 16), writing
into OUT_DIR/card_q<Q>/. Meanwhile a pool of N processes (default 7, one
torch thread each; 0 skips it) encodes every row on the CPU, one
api.encode_bytes per row. Prints one JSON line per row (name, quality,
golden, card and CPU bytes, each one's deviation from golden in percent)
and a summary line: rows, rows outside 2% on each device, rows where the
two devices' bytes differ, the card's name and power limit and the
corpus CLI's lines.
"""

import contextlib
import io
import json
import multiprocessing
import pathlib
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

_REPO = pathlib.Path(__file__).resolve().parent.parent
_CORPUS = _REPO / "tests" / "corpus"
BAND = 0.02


def _cpu_row(task):
    import torch
    torch.set_num_threads(1)
    from guetzli_tpu_torch import api
    name, quality = task
    try:
        return len(api.encode_bytes((_CORPUS / name).read_bytes(), quality,
                                    device="cpu"))
    except ValueError:
        return None


def _golden(prefix):
    rows = []
    for ln in (_REPO / "tests" / "golden_corpus.txt").read_text() \
            .splitlines():
        parts = ln.split()
        if len(parts) == 3 and parts[0].startswith(prefix):
            rows.append((parts[0], int(parts[1]), int(parts[2])))
    return rows


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="python -m guetzli_tpu_torch."
                                 "golden_rows")
    ap.add_argument("out")
    ap.add_argument("--cpu-procs", type=int, default=7)
    ap.add_argument("--prefix", default="photo_")
    ap.add_argument("--qualities", default="84,90,95")
    args = ap.parse_args(argv)
    qualities = [int(q) for q in args.qualities.split(",")]
    rows = [r for r in _golden(args.prefix) if r[1] in qualities]
    names = sorted({r[0] for r in rows})
    pool, futures = None, {}
    if args.cpu_procs:
        pool = ProcessPoolExecutor(
            args.cpu_procs, mp_context=multiprocessing.get_context("spawn"))
        # Largest images first, so that the pool ends together.
        for t in sorted({(n, q) for n, q, _g in rows},
                        key=lambda t: -(_CORPUS / t[0]).stat().st_size):
            futures[t] = pool.submit(_cpu_row, t)
    from guetzli_tpu_torch import corpus_cli
    card, lines = {}, []
    for q in qualities:
        out_dir = pathlib.Path(args.out) / ("card_q%d" % q)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = corpus_cli.main(["--quality", str(q), "--out", str(out_dir)]
                                 + [str(_CORPUS / n) for n in names])
        lines.append(buf.getvalue().strip())
        sys.stderr.write("card q%d: rc %d %s\n" % (q, rc, lines[-1]))
        for n, out_name in corpus_cli.output_names(names).items():
            f = out_dir / out_name
            card[(n, q)] = f.stat().st_size if f.exists() else None
    cpu_bytes = {t: f.result() for t, f in futures.items()}
    if pool is not None:
        pool.shutdown()

    def dev(b, g):
        return None if b is None else 100.0 * (b - g) / g
    out_card = out_cpu = differ = 0
    for n, q, g in rows:
        c, p = card.get((n, q)), cpu_bytes.get((n, q))
        out_card += c is None or abs(c - g) > BAND * g
        out_cpu += p is not None and abs(p - g) > BAND * g
        differ += p is not None and c != p
        print(json.dumps({"name": n, "quality": q, "golden": g, "card": c,
                          "card_pct": dev(c, g), "cpu": p,
                          "cpu_pct": dev(p, g)}))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except OSError:
        smi = None
    print(json.dumps({"rows": len(rows), "outside_band_card": out_card,
                      "outside_band_cpu": out_cpu,
                      "card_cpu_differ": differ, "card": smi,
                      "corpus_cli": lines}))
    return 0 if out_card == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
