"""Device time of one encode on the card, from a torch.profiler trace.

  python -m guetzli_tpu_torch.trace_encode in.png|in.jpg [quality]

Encodes the image three times: once to build and warm up the kernels and
libraries, once untraced, and once under torch.profiler with CPU and CUDA
activities. Prints both walls, the device time summed over the trace's
device activities (kernels, copies, sets), its share of the wall (the
device's busy share: one stream, so device activities do not overlap),
and the device time of the top activities by name. The profiler's own host
overhead lengthens the traced wall, so the share of the traced wall is a
lower bound; the share of the untraced wall is printed beside it.
"""

import sys
import time

import torch


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) > 2:
        sys.stderr.write(__doc__)
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("trace_encode: no CUDA device\n")
        return 1
    from torch.profiler import ProfilerActivity, profile

    from guetzli_tpu_torch import api
    data = open(argv[0], "rb").read()
    quality = float(argv[1]) if len(argv) > 1 else 95.0

    def encode():
        torch.cuda.synchronize()
        t0 = time.time()
        out = api.encode_bytes(data, quality=quality, device="cuda")
        torch.cuda.synchronize()
        return out, time.time() - t0

    encode()
    out, plain_wall = encode()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, wall = encode()
    if traced != out:
        sys.stderr.write("trace_encode: the traced encode differs\n")
        return 1
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _k, ms, _n in rows)
    print("%s q%g: %d bytes; untraced wall %.3f s, traced wall %.3f s"
          % (argv[0], quality, len(out), plain_wall, wall))
    if not rows:
        print("device time: not measured (the trace holds no device "
              "activity)")
        return 1
    print("device time %.1f ms; busy share of the traced wall %.4f, of "
          "the untraced wall %.4f" % (device_ms, device_ms / (wall * 1e3),
                                     device_ms / (plain_wall * 1e3)))
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print("  %10.3f ms %6d x  %s" % (ms, n, key[:90]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
