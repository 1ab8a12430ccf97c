"""The compare chain's constants, kept on their device.

The whole-image compare reads tables, index arrays, masks and 0-dim
operands that depend only on the image's geometry and the knobs. Made
from numpy on every call, each cost a host-to-device copy, and a
pageable copy waits until the stream has caught up; nor can a chain that
copies from the host be captured as a CUDA graph (compare_graphs.py).
Here each is made once, on first use, with the values, dtype and shape
the per-call upload had, keyed by what determines it (a name, the
integers of the geometry, the knobs it depends on) and the device.

The cache holds at most MAX_BYTES of tensors and drops the least
recently used beyond that. A graph's capture records every constant it
reads (recording()) and keeps them alive, since a graph reads them
through their addresses. A capture must not copy from the host: a
constant missing then raises Missing, and the capture is abandoned for
an eager run, which makes it.
"""

import collections
import threading
from contextlib import contextmanager

import numpy as np
import torch

# Bytes of device constants kept beyond those a graph holds.
MAX_BYTES = 256 << 20

_lock = threading.Lock()
_cache = collections.OrderedDict()    # key -> (tensor or tuple, bytes)
_bytes = [0]
_local = threading.local()


class Missing(RuntimeError):
    """A constant was first asked for while its device's stream was
    being captured."""


def _capturing(device):
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _nbytes(value):
    ts = value if isinstance(value, tuple) else (value,)
    return sum(t.numel() * t.element_size() for t in ts)


def get(key, device, make, dtype=None):
    """The constant `key` on `device`: make() (a numpy array, a number,
    or a tuple of them) uploaded once, as torch.as_tensor(x, dtype,
    device) would upload it; a tuple gives a tuple of tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    full = (key, str(device), dtype)
    with _lock:
        hit = _cache.get(full)
        if hit is not None:
            _cache.move_to_end(full)
    if hit is None:
        if _capturing(device):
            raise Missing(str(key))
        made = make()
        value = (tuple(torch.as_tensor(x, dtype=dtype, device=device)
                       for x in made) if isinstance(made, tuple)
                 else torch.as_tensor(made, dtype=dtype, device=device))
        with _lock:
            # First one in wins: a graph may hold the other's address.
            hit = _cache.setdefault(full, (value, _nbytes(value)))
            if hit[0] is value:
                _bytes[0] += hit[1]
                while _bytes[0] > MAX_BYTES and len(_cache) > 1:
                    _k, (_v, n) = _cache.popitem(last=False)
                    _bytes[0] -= n
    rec = getattr(_local, "record", None)
    if rec is not None:
        rec.append(hit[0])
    return hit[0]


def array(arr, device, dtype=None):
    """A module-level numpy array (alive for the process, so its id names
    it) on `device`."""
    return get(("array", id(arr)), device, lambda: arr, dtype)


def scalar(value, dtype, device):
    """A 0-dim tensor of `value` in `dtype` on `device`, as
    torch.tensor(value, dtype=dtype, device=device) makes it."""
    return get(("scalar", float(value)), device,
               lambda: np.asarray(float(value)), dtype)


@contextmanager
def recording():
    """Collect every constant this thread reads inside the block: the
    list yielded."""
    prev = getattr(_local, "record", None)
    _local.record = []
    try:
        yield _local.record
    finally:
        _local.record = prev


def clear():
    """Drop every constant (tests)."""
    with _lock:
        _cache.clear()
        _bytes[0] = 0
