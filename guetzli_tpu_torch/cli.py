"""guetzli_tpu_torch command line, flag-compatible with the reference CLI
(guetzli/guetzli.cc:221-366).

  python -m guetzli_tpu_torch.cli [flags] in.png|in.jpg out.jpg

The input is a PNG or a JPEG (a 4:2:0 JPEG is searched at 4:2:0). Runs on
the CUDA device; --cpu runs on the CPU instead. --c/--opencl/--cuda select
the reference's accelerated-mode trade-off: each block's greedy zeroing
stops once its error reaches the block error limit (processor.cc:458-465).
--checkcuda (alias --checkcl) first runs the kernel verification of
checkcl.py on the input image (the clguetzli_test.cpp analog) and prints
its report to stderr; --profile DIR writes a torch.profiler Chrome trace
of the run to DIR/trace.json.
"""

import os
import sys

from guetzli_tpu_torch import consts

_USAGE = """Guetzli JPEG compressor (PyTorch/CUDA port). Usage:
python -m guetzli_tpu_torch.cli [flags] input_filename output_filename

Flags:
  --verbose    - Print a verbose trace of all attempts to standard error.
  --quality Q  - Visual quality to aim for, expressed as a JPEG quality value.
                 Default value is 95.
  --memlimit M - Memory limit in MB. Guetzli will fail if unable to stay under
                 the limit. Default limit is 6000 MB.
  --nomemlimit - Do not limit memory usage.
  --c, --opencl, --cuda
               - Stop each block's zeroing search at the error limit
                 (faster, slightly larger output).
  --cpu        - Run on the CPU instead of the CUDA device.
  --checkcuda, --checkcl
               - First verify the butteraugli stages and the block compare
                 kernels on the input image (report on standard error).
  --profile D  - Write a torch.profiler Chrome trace of the run to
                 D/trace.json.
"""

# Host-memory guard: the reference's contract values (guetzli.cc:42-45).
K_BYTES_PER_PIXEL = 110
K_LOWEST_MEMUSAGE_MB = 100
K_DEFAULT_MEMLIMIT_MB = 6000
K_DEFAULT_QUALITY = 95


def _check_memory(pixels, memlimit_mb) -> bool:
    """guetzli.cc:333-356 memory guard (reference contract)."""
    if memlimit_mb == -1:
        return True
    estimate_mb = max(K_LOWEST_MEMUSAGE_MB,
                      pixels * K_BYTES_PER_PIXEL // (1 << 20))
    if memlimit_mb < estimate_mb or memlimit_mb < K_LOWEST_MEMUSAGE_MB:
        sys.stderr.write("Memory limit would be exceeded. Failing.\n")
        return False
    return True


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"verbose": False, "fast_zeroing": False, "check": False,
            "device": None, "quality": K_DEFAULT_QUALITY,
            "memlimit_mb": K_DEFAULT_MEMLIMIT_MB}
    profile_dir = None
    i = 0
    try:
        while i < len(argv) and argv[i].startswith("-") and argv[i] != "-":
            flag = argv[i]
            if flag == "--verbose":
                opts["verbose"] = True
            elif flag == "--quality":
                i += 1
                opts["quality"] = int(argv[i])
            elif flag == "--memlimit":
                i += 1
                opts["memlimit_mb"] = int(argv[i])
            elif flag == "--nomemlimit":
                opts["memlimit_mb"] = -1
            elif flag in ("--c", "--opencl", "--cuda"):
                opts["fast_zeroing"] = True
            elif flag in ("--checkcl", "--checkcuda"):
                opts["check"] = True
            elif flag == "--cpu":
                opts["device"] = "cpu"
            elif flag == "--profile":
                i += 1
                profile_dir = argv[i]
            else:
                sys.stderr.write(_USAGE)
                return 1
            i += 1
    except (IndexError, ValueError):
        sys.stderr.write(_USAGE)
        return 1
    if len(argv) - i != 2:
        sys.stderr.write(_USAGE)
        return 1
    if profile_dir is None:
        return _run(argv[i], argv[i + 1], **opts)
    # gperftools analog (guetzli.cc:32-34): trace the whole run, the
    # card's activity too when the run is on it.
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if opts["device"] != "cpu" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        return _run(argv[i], argv[i + 1], **opts)
    finally:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _pixels(data):
    """(rgb, w, h) of a JPEG for the kernel check, decoded as the encoder
    decodes it; None when the reader rejects the file (the encode that
    follows reports why)."""
    from guetzli_tpu_torch.codec import full_decode, reader
    from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb
    try:
        jpg = reader.read_jpeg(data)
        rgb = decode_jpeg_to_rgb(jpg)
        if rgb is None:
            return full_decode.decode_any_to_rgb(jpg)
    except (reader.JpegError, ValueError):
        return None
    return rgb, jpg.width, jpg.height


def _run(in_name, out_name, verbose, fast_zeroing, check, device, quality,
         memlimit_mb) -> int:
    if in_name == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(in_name, "rb") as f:
            data = f.read()

    from guetzli_tpu_torch.api import is_jpeg
    from guetzli_tpu_torch.codec.reader import peek_dimensions
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_jpeg_bytes,
                                                    process_rgb)
    if is_jpeg(data):
        dims = peek_dimensions(data)
        pixels = dims[0] * dims[1] if dims is not None else None
    else:
        try:
            rgb, w, h = read_png(data)
        except ValueError:
            sys.stderr.write("Can't decode input image\n")
            return 1
        pixels = w * h
    if pixels is not None and not _check_memory(pixels, memlimit_mb):
        return 1
    try:
        dev = resolve(device)
    except RuntimeError as e:
        sys.stderr.write("%s\n" % e)
        return 1
    if check:
        # Runtime dual-execution verification of the kernels on this input
        # (clguetzli_test.cpp analog); the report goes to stderr.
        from guetzli_tpu_torch.checkcl import run_checkcl
        pix = _pixels(data) if is_jpeg(data) else (rgb, w, h)
        if pix is not None:
            run_checkcl(*pix, device=dev)
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(quality)
    params.zeroing_early_exit = fast_zeroing
    stats = ProcessStats(debug=verbose)
    if is_jpeg(data):
        # None: unreadable or unsupported; the processor printed why.
        out = process_jpeg_bytes(params, data, stats, dev)
        if out is None:
            return 1
    else:
        try:
            out = process_rgb(params, rgb, w, h, stats, dev)
        except ValueError:
            # e.g. quality below 84; the processor printed the reason.
            return 1
    if out_name == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(out_name, "wb") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
