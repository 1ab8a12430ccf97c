"""Build and load the CUDA kernels of csrc/.

Each source is compiled by nvcc at first use into a shared library with a
plain C interface (guetzli_tpu_torch/_build/, listed in .gitignore) and
loaded with ctypes. All missing libraries are built together, one nvcc
process per source started at once. A library's file name carries a hash
of its sources and flags, so an edited source is rebuilt, never reused.

Nothing here runs at import: the CPU tests import the wrappers on a
machine without nvcc. ``lock`` makes the lazy build and the wrappers'
launch counts safe under the corpus encoders' threads.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Library name -> its source file; every source includes both headers.
SOURCES = {
    "tile_compare_lanes": "tile_compare_lanes.cu",
    "zeroing_loop": "zeroing_loop.cu",
    "tile_compare": "tile_compare.cu",
}
HEADERS = ("compare_block.cuh", "compare_team.cuh")

# --fmad=false: each multiply and add rounds on its own, as the plain
# PyTorch versions' separate tensor ops do (csrc/compare_block.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Entry point -> (library, C function, ctypes argument types): every
# pointer and the stream as c_void_p. A compare takes (candidates, state
# pointers..., tables, out, n, stream), kernel C's state being (xyb0,
# scales, sy, sx); a greedy loop takes (coeffs, order, nrem, lim, state
# pointers..., tables, out_idx, out_err, n, lookahead, early_exit,
# stream); a geometry query takes (mode, &threads, &smem_bytes,
# &ctas_per_sm).
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "tile_compare_lanes": ("tile_compare_lanes", "gt_tile_compare_lanes",
                           [_P] * 7 + [_I, _P]),
    "tile_compare_lanes_420y": ("tile_compare_lanes",
                                "gt_tile_compare_lanes_420y",
                                [_P] * 8 + [_I, _P]),
    "tile_compare_lanes_420c": ("tile_compare_lanes",
                                "gt_tile_compare_lanes_420c",
                                [_P] * 11 + [_I, _P]),
    "tile_compare_lanes_geometry": ("tile_compare_lanes",
                                    "gt_tile_compare_lanes_geometry",
                                    [_I, _P, _P, _P]),
    "zeroing_loop": ("zeroing_loop", "gt_zeroing_loop",
                     [_P] * 11 + [_I, _I, _I, _P]),
    "zeroing_loop_420y": ("zeroing_loop", "gt_zeroing_loop_420y",
                          [_P] * 12 + [_I, _I, _I, _P]),
    "zeroing_loop_420c": ("zeroing_loop", "gt_zeroing_loop_420c",
                          [_P] * 15 + [_I, _I, _I, _P]),
    "zeroing_loop_geometry": ("zeroing_loop", "gt_zeroing_loop_geometry",
                              [_I, _P, _P, _P]),
    "tile_compare": ("tile_compare", "gt_tile_compare", [_P] * 7 + [_I, _P]),
    "tile_compare_geometry": ("tile_compare", "gt_tile_compare_geometry",
                              [_I, _P, _P, _P]),
}

_loaded = {}
lock = threading.Lock()
# name -> {"seconds": build wall time, "ptxas": compiler resource report}
build_log = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _lib_path(name):
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build_all(names=None):
    """Compile every missing library among `names` (default: all), in
    parallel. Raises RuntimeError with the compiler output on failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.time()
    for n in todo:
        tmp = _lib_path(n).with_suffix(".tmp%d" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for n, (p, tmp) in procs.items():
        out, _ = p.communicate()
        text = out.decode(errors="replace")
        build_log[n] = {"seconds": time.time() - t0, "ptxas": text}
        if p.returncode != 0:
            errors.append("%s:\n%s" % (n, text[-4000:]))
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))


def load(name):
    """The ctypes handle of entry point `name` (SIGNATURES; builds all
    missing libraries first)."""
    with lock:
        if name not in _loaded:
            build_all()
            libname, fname, argtypes = SIGNATURES[name]
            lib = ctypes.CDLL(str(_lib_path(libname)))
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]
