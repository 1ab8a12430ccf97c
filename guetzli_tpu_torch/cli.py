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
of the run to DIR/trace.json. --mesh N encodes one 4:4:4 image over N
ranks, processes that this command starts itself (run_ranks): each holds
a band of the image's rows, on cuda:{rank % device_count} or, with
--cpu, on the CPU, and the output's bytes are those of one device
(parallel/mesh.py). --mesh 1 is the one-device path.
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
  --mesh N     - Encode over N ranks, each on a band of the image's rows
                 (4:4:4 input; the same bytes as one device).
"""

# Memory guard: the reference's contract values (guetzli.cc:42-45) decide
# whether to fail. On the card the guard also warns when the port's
# measured process envelope passes the limit, as the JAX package's CLI
# does. The envelope is a least-squares base + bytes per pixel over
# photo_mosaic2 (1.00 MPix), photo_mosaic1 (1.31 MPix) and photo_mosaic1
# tiled 2x2 (5.24 MPix) at q95, one process each (python -m
# guetzli_tpu_torch.memory_envelope, on an NVIDIA H100 80GB HBM3 at
# 700.00 W): the peak RSS is mostly PyTorch's CUDA runtime (4.75 GB
# before the encode starts); the card holds the image's state, and its
# peak is the quant tree's widest wave (the card's default route). The
# smallest image measured the same way, bees96x64 (6,144 pixels), peaks
# at 6,187-6,203 MB, within 40 MB of the fit's base: above the default
# limit, so on the card the warning stands for every image, and says so.
K_BYTES_PER_PIXEL = 110
K_LOWEST_MEMUSAGE_MB = 100
K_DEFAULT_MEMLIMIT_MB = 6000
K_MEASURED_BASE_MB = 6165         # process peak RSS
K_MEASURED_BYTES_PER_PIXEL = 134
K_DEVICE_BASE_MB = 2503           # torch.cuda.max_memory_allocated
K_DEVICE_BYTES_PER_PIXEL = 3139
K_DEFAULT_QUALITY = 95


def _check_memory(pixels, memlimit_mb, on_card=True) -> bool:
    """guetzli.cc:333-356 memory guard (reference contract), and on the
    card a warning from the port's measured envelope."""
    if memlimit_mb == -1:
        return True
    estimate_mb = max(K_LOWEST_MEMUSAGE_MB,
                      pixels * K_BYTES_PER_PIXEL // (1 << 20))
    if memlimit_mb < estimate_mb or memlimit_mb < K_LOWEST_MEMUSAGE_MB:
        sys.stderr.write("Memory limit would be exceeded. Failing.\n")
        return False
    if not on_card:
        return True
    measured_mb = K_MEASURED_BASE_MB + (
        pixels * K_MEASURED_BYTES_PER_PIXEL >> 20)
    if memlimit_mb < measured_mb:
        sys.stderr.write(
            "Warning: the measured process envelope of this port is ~%d MB "
            "for this image (PyTorch and the CUDA context; ~%d MB more on "
            "the card), above the %d MB limit. On the card every image "
            "passes %d MB: the CUDA runtime holds ~4,750 MB before the "
            "encode starts. Proceeding per the reference guard model.\n"
            % (measured_mb, K_DEVICE_BASE_MB
               + (pixels * K_DEVICE_BYTES_PER_PIXEL >> 20), memlimit_mb,
               K_DEFAULT_MEMLIMIT_MB))
    return True


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"verbose": False, "fast_zeroing": False, "check": False,
            "device": None, "quality": K_DEFAULT_QUALITY,
            "memlimit_mb": K_DEFAULT_MEMLIMIT_MB, "mesh": 1}
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
            elif flag == "--mesh":
                i += 1
                opts["mesh"] = int(argv[i])
                if opts["mesh"] < 1:
                    raise ValueError(opts["mesh"])
            else:
                sys.stderr.write(_USAGE)
                return 1
            i += 1
    except (IndexError, ValueError):
        sys.stderr.write(_USAGE)
        return 1
    if len(argv) - i != 2 or (profile_dir and opts["mesh"] > 1):
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


def _is_420(data):
    from guetzli_tpu_torch.codec import reader
    try:
        return reader.read_jpeg(data).is_420()
    except reader.JpegError:
        return False


def _run(in_name, out_name, verbose, fast_zeroing, check, device, quality,
         memlimit_mb, mesh=1) -> int:
    if in_name == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(in_name, "rb") as f:
            data = f.read()

    from guetzli_tpu_torch.api import is_jpeg
    from guetzli_tpu_torch.codec.reader import peek_dimensions
    from guetzli_tpu_torch.device import resolve
    from guetzli_tpu_torch.io.png import read_png
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
    if pixels is not None and not _check_memory(pixels, memlimit_mb,
                                                device != "cpu"):
        return 1
    try:
        dev = resolve(device)
    except RuntimeError as e:
        sys.stderr.write("%s\n" % e)
        return 1
    if mesh > 1:
        if is_jpeg(data) and _is_420(data):
            sys.stderr.write("--mesh: a 4:2:0 input over several ranks comes "
                             "with the next slice of the port; encode it "
                             "without --mesh\n")
            return 1
        return run_ranks(mesh, _encode_job, data, out_name, verbose,
                         fast_zeroing, check, quality, device=device)
    pix = None if is_jpeg(data) else (rgb, w, h)
    return _encode(data, pix, out_name, dev, verbose, fast_zeroing, check,
                   quality)


def _encode(data, pix, out_name, dev, verbose, fast_zeroing, check,
            quality, lead=True) -> int:
    """The kernel check, when asked, then the encode of `data` (pix: a
    PNG's (rgb, w, h)) on `dev`, and the output written. Under a mesh
    every rank runs both, and the rank that is not `lead` neither
    reports nor writes."""
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_jpeg_bytes,
                                                    process_rgb)
    if check:
        # Runtime dual-execution verification of the kernels on this input
        # (clguetzli_test.cpp analog); the report goes to stderr.
        import contextlib
        import io

        from guetzli_tpu_torch.checkcl import run_checkcl
        checked = _pixels(data) if pix is None else pix
        if checked is not None:
            with (contextlib.nullcontext() if lead else
                  contextlib.redirect_stderr(io.StringIO())):
                run_checkcl(*checked, device=dev)
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(quality)
    params.zeroing_early_exit = fast_zeroing
    stats = ProcessStats(debug=verbose and lead)
    if pix is None:
        # None: unreadable or unsupported; the processor printed why.
        out = process_jpeg_bytes(params, data, stats, dev)
        if out is None:
            return 1
    else:
        try:
            out = process_rgb(params, *pix, stats, dev)
        except ValueError:
            # e.g. quality below 84; the processor printed the reason.
            return 1
    if not lead:
        return 0
    if out_name == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(out_name, "wb") as f:
            f.write(out)
    return 0


def run_ranks(n, fn, *args, device=None, timeout=1800.0):
    """Run fn(group, *args) in n new processes, the ranks of one group
    (parallel/dist.init through a FileStore in a temporary directory) on
    `device` ("cpu", or None: cuda:{rank % device_count}), with
    GUETZLI_TPU_MESH=n. Returns 0, or 1 after the failed rank's error on
    stderr: a rank that fails takes the run down, and its peers' waits
    end at `timeout` seconds. fn must be a module-level function."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    # CPU ranks share this process's torch threads.
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(_rank_main, nprocs=n, join=True,
                     args=(n, "file://" + os.path.join(tmp, "store"),
                           device, timeout, threads, fn, args))
        except Exception as e:
            sys.stderr.write("--mesh %d: %s\n" % (n, e))
            return 1
    return 0


def _rank_main(rank, n, init_method, device, timeout, threads, fn, args):
    os.environ["GUETZLI_TPU_MESH"] = str(n)
    if device == "cpu":
        import torch
        torch.set_num_threads(threads)
    from guetzli_tpu_torch.parallel import dist
    group = dist.init(n, rank, init_method, device=device, timeout=timeout)
    rc = fn(group, *args)
    if rc:
        sys.exit(rc)
    dist.shutdown()


def _encode_job(group, data, out_name, verbose, fast_zeroing, check,
                quality) -> int:
    """One rank's part of a --mesh encode: every rank runs the search,
    rank 0 alone reports and writes the output."""
    from guetzli_tpu_torch.api import is_jpeg
    from guetzli_tpu_torch.io.png import read_png
    pix = None if is_jpeg(data) else read_png(data)
    return _encode(data, pix, out_name, group.device, verbose, fast_zeroing,
                   check, quality, lead=group.rank == 0)


if __name__ == "__main__":
    sys.exit(main())
