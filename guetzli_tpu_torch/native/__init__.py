"""Native host-kernel loader.

Compiles src/native.cc and src/png_decode.cc once with g++ into a cached
shared library (``_cache/``, listed in .gitignore) and binds it via ctypes.
The scan codec, histogram and quantize helpers keep their pure-Python
fallbacks when the toolchain is missing; the PNG reader does not (it
raises, see io/png.py).
"""

import ctypes
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).parent
_SRCS = [_DIR / "src" / "native.cc", _DIR / "src" / "png_decode.cc"]
_LIB = _DIR / "_cache" / "libguetzli_native.so"

_lib = None
_tried = False
_build_error = None
_lock = threading.Lock()


def _build():
    global _build_error
    _LIB.parent.mkdir(exist_ok=True)
    stamp = _LIB.with_suffix(".stamp")
    src_mtime = ",".join(str(s.stat().st_mtime_ns) for s in _SRCS)
    if _LIB.exists() and stamp.exists() and stamp.read_text() == src_mtime:
        return True
    cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", str(_LIB)] + [str(s) for s in _SRCS] + ["-lz"])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        _build_error = e.stderr.decode(errors="replace")[-2000:]
        return False
    except (OSError, subprocess.SubprocessError) as e:
        _build_error = str(e)
        return False
    stamp.write_text(src_mtime)
    return True


def get_lib():
    """The ctypes library handle, or None if it cannot be built."""
    with _lock:
        return _get_lib()


def _get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError as e:
        global _build_error
        _build_error = str(e)
        return None
    lib.gt_encode_scan.restype = ctypes.c_int64
    lib.gt_decode_scan.restype = ctypes.c_int64
    lib.gt_backend_flips.restype = ctypes.c_int64
    lib.gt_png_dims.restype = ctypes.c_int64
    lib.gt_png_decode.restype = ctypes.c_int64
    lib.gt_quantize_blocks.restype = ctypes.c_int64
    lib.gt_ac_histogram.restype = ctypes.c_int64
    _lib = lib
    return _lib


def require_lib():
    """The ctypes library handle; raises if it cannot be built."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library build failed: %s" % _build_error)
    return lib
