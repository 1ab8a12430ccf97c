"""CUDA graphs of the whole-image compares, shared by every comparator.

The eager compare chain makes ~800 PyTorch calls, and the host takes
5-20 times longer to issue them than the card takes to run them. A
Comparator on a CUDA device therefore captures each compare form it
runs into a torch.cuda.CUDAGraph and replays it: one graph launch (two
for a compare with its block weights) instead of the chain's. The
graphs replay exactly the kernels that eager mode launches, on the same
data, so every result is the same bit for bit.

The graphs live in one cache per device, shared by every comparator: a
corpus repeats a few image sizes, and a comparator whose keys an
earlier one captured replays them from its first compare. A graph's
key is the comparator's geometry (its width and height, and its bucket
when padded), the compare form and everything else that fixes its op
sequence and shapes (comparator.py gives them: the block grids, a
weights graph's direction, target and factors, the knobs); the shapes
and dtypes of the inputs are added here. A graph reads nothing of one
image but its inputs: the coefficient planes and the image's own device
state (its original's opsin, and on a bucket its size and border
scales), which are copied into the graph's static buffers before each
replay, device to device, as host arrays are through pinned memory
(without waiting for the stream). The outputs are copied out after the
replay, so that every caller owns its results while the graph runs
again.

The first compare at a geometry new to the device runs eagerly: it
builds the chain's device constants (ops/devconst.py) and the
libraries' per-shape state (cuDNN's plans, cuBLAS's handle), which
every form at that geometry shares, since each trial of a wave runs at
the shape of a single compare. From then on a key's first use captures
the chain and replays it, and later uses, by any comparator, replay. A
constant still missing at a capture (one a form adds, or one dropped
from the cache) gives up the capture for an eager run, which makes it;
the key's next use captures.

The static buffers and the outputs take ordinary device memory, which
the quant waves' sizing (Comparator.quant_batch_sizes) counts as used,
so the cache keeps at most MAX_BYTES of them and drops the least
recently used graphs beyond that.

Every graph on a device shares one memory pool, which stays open while
graphs come and go (a one-kernel graph of its own holds it): a pool per
comparator would cudaMalloc its segments afresh for each image and keep
them until the allocator's cache is emptied, which a capture cannot do,
so a corpus ran out of memory. Graphs of one pool may reuse each
other's intermediate memory, which is safe as long as no two run at
once and each replay's outputs are copied before another graph
replays: every compare runs on the device's current stream, and one
lock for the process covers each capture (on a side stream, in
thread-local error mode) and each load, replay and copy of the outputs
(compares may come from several threads). drop() releases every graph
on a device (a comparator's recovery); drop_all() also closes the pool,
whose memory the allocator then frees (recovery from an out-of-memory
error, runtime.py); the next use of a key captures again, into a new
pool. A capture that fails leaves its key eager for the comparator;
one that fails for another reason than memory also closes the pool.

Counters (comparator.py keeps them): compare_graph_captures,
compare_graph_replays and compare_eager, one per compare dispatched
(combined() names a dispatch of several graphs); of the replays,
compare_graph_shared, those of a graph another comparator captured;
and compare_graph_evictions, the graphs a comparator's captures pushed
out of the cache. Spans: compare_capture, the seconds of capture and
instantiation; compare_upload, the host-to-device copies of a
compare's host arrays (its coefficient planes, a wave's matrices),
including their pinning, whose bytes the counter compare_upload_bytes
adds up (uploading(): the comparator's own uploads take it too).
"""

import collections
import sys
import threading
import warnings
import weakref
from contextlib import contextmanager

import numpy as np
import torch

from guetzli_tpu_torch import spans
from guetzli_tpu_torch.ops import devconst

CAPTURES = "compare_graph_captures"
REPLAYS = "compare_graph_replays"
EAGER = "compare_eager"
# How a dispatch ran: one of these each.
COUNTERS = (CAPTURES, REPLAYS, EAGER)
SHARED = "compare_graph_shared"
EVICTIONS = "compare_graph_evictions"
# Counted beside COUNTERS: shared replays and evictions.
CACHE_COUNTERS = (SHARED, EVICTIONS)
# The span and the counter of a compare's host-to-device copies.
UPLOAD = "compare_upload"
UPLOAD_BYTES = "compare_upload_bytes"

# Bytes of static buffers and outputs the cache keeps on a device. A
# key takes its inputs and outputs: ~1-2 MB for a thumbnail, ~170 MB for
# the four 0.3-0.6 MPix photo sizes together, ~0.5-0.9 GB for a 6.29
# MPix size (its planes and opsin are 75 MB each). 1 GiB holds a
# thumbnail or photo corpus's sizes whole and a large photo's keys,
# and takes 1.3% of an 80 GB card from what the quant waves may use: a
# 6.29 MPix image keeps its waves of 3 and then 2 trials.
MAX_BYTES = 1 << 30

_lock = threading.RLock()
_side_streams = {}
_pools = {}               # device -> _Pool
_caches = {}              # device -> _Cache
_warned = []


class _Pool:
    """A device's graph memory pool: its handle, the graph that holds it
    open, and the bytes the captures into it reserved."""

    def __init__(self):
        self.handle = None
        self.bytes = 0
        self._hold = None

    def open(self, graph_class, device):
        """The pool's handle, a new pool if it is closed."""
        if self.handle is None:
            self.handle = graph_class.new_pool(device)
            # The allocator keeps a pool while a graph captured into it
            # lives; a new capture into a pool it let go is refused.
            self._hold = graph_class(device, self.handle)
            self._hold.capture(
                lambda: torch.zeros(1, device=device).add_(1))
        return self.handle

    def close(self):
        self.handle = self._hold = None
        self.bytes = 0


def _device_key(device):
    if device.index is not None or device.type != "cuda":
        return str(device)
    return "cuda:%d" % torch.cuda.current_device()


def _pool(device):
    return _pools.setdefault(_device_key(device), _Pool())


class _Cache:
    """A device's graphs by key, least recently used first, the bytes
    of their static buffers and outputs, and the geometries at which an
    eager compare ran (kept when the graphs are dropped)."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        self.bytes = 0
        self.warm = set()

    def put(self, key, entry, counters):
        """Add `entry` under `key`; drop the least recently used others
        while the cache holds more than MAX_BYTES, counting each in
        `counters` as an eviction."""
        self.entries[key] = entry
        self.bytes += entry.bytes
        while self.bytes > MAX_BYTES and len(self.entries) > 1:
            _key, old = self.entries.popitem(last=False)
            self.bytes -= old.bytes
            count(counters, EVICTIONS)

    def drop(self):
        self.entries.clear()
        self.bytes = 0


def _cache(device):
    return _caches.setdefault(_device_key(device), _Cache())


def count(counters, mode):
    """Count a dispatch or an eviction in the dict `counters`; a replay
    of a graph another comparator captured (SHARED) counts as a replay
    too."""
    for name in (REPLAYS, SHARED) if mode == SHARED else (mode,):
        counters[name] = counters.get(name, 0) + 1


def combined(*modes):
    """How a dispatch of several graphs ran: eager if any part did, else
    a capture if any part captured, else a shared replay if any part
    replayed another comparator's graph, else a replay."""
    for mode in (EAGER, CAPTURES, SHARED):
        if mode in modes:
            return mode
    return REPLAYS


def to_device(a, device):
    """A host array on `device`: on the card through pinned memory and a
    copy that does not wait for the stream (the pinned block is reused
    only once the copy is done), else torch.as_tensor."""
    a = np.ascontiguousarray(a)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)


def host_bytes(arrays):
    """Bytes of the host arrays among `arrays` (device tensors: 0)."""
    return sum(np.asarray(a).nbytes for a in arrays
               if not isinstance(a, torch.Tensor))


@contextmanager
def uploading(timings, counters, nbytes):
    """The compare_upload span (spans.timed) on `timings` around a
    compare's host-to-device copies of `nbytes` bytes, which are added
    to counters[UPLOAD_BYTES] (counters a dict or None). The copies are
    the caller's: the span adds no sync."""
    with spans.timed(timings, UPLOAD):
        yield
    if counters is not None:
        counters[UPLOAD_BYTES] = counters.get(UPLOAD_BYTES, 0) + nbytes


def copy_into(dst, a):
    """Write host array or device tensor `a` into device tensor `dst`
    (to_device's copy for a host array)."""
    if isinstance(a, torch.Tensor):
        dst.copy_(a)
    elif dst.device.type != "cuda":
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    else:
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a)).pin_memory(),
                  non_blocking=True)


def _side_stream(device):
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class CudaGraph:
    """One captured chain on a CUDA device (torch.cuda.CUDAGraph), in the
    owner's memory pool. Not the torch.cuda.graph context manager, whose
    entry collects garbage and empties the allocator's cache."""

    def __init__(self, device, pool):
        self.device = device
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def new_pool(device):
        del device
        return torch.cuda.graph_pool_handle()

    def capture(self, fn):
        """Capture fn() on a side stream: its outputs, written by
        replay()."""
        main = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                outs = fn()
            except BaseException:
                try:
                    with warnings.catch_warnings():
                        # An empty graph, when fn raised at once.
                        warnings.simplefilter("ignore")
                        self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()
        main.wait_stream(side)
        return outs

    def replay(self):
        self.graph.replay()


class _Entry:
    """A key's graph, its static inputs and outputs, the device
    constants its capture read (alive as long as the graph), the
    CompareGraphs (weakly) that captured it, and the bytes of its
    statics and outputs."""

    def __init__(self, statics, owner):
        self.statics = statics
        self.owner = weakref.ref(owner)
        self.graph = None
        self.outputs = None
        self.consts = None
        self.bytes = 0

    def load(self, inputs, timings, counters):
        """Copy `inputs` into the static buffers: the host arrays inside
        one compare_upload span (uploading), the device tensors device
        to device."""
        pairs = list(zip(self.statics, inputs))
        host = [(dst, a) for dst, a in pairs
                if not isinstance(a, torch.Tensor)]
        if host:
            with uploading(timings, counters,
                           host_bytes(a for _dst, a in host)):
                for dst, a in host:
                    copy_into(dst, a)
        for dst, a in pairs:
            if isinstance(a, torch.Tensor):
                dst.copy_(a)


def _signature(a):
    return tuple(a.shape), _torch_dtype(a)


def _torch_dtype(a):
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class CompareGraphs:
    """One comparator's way into its device's graphs (module docstring):
    its geometry, the keys whose capture failed for it, and whether it
    takes graphs at all (`enabled` False, the CPU and a mesh, runs every
    compare eagerly). graph_class makes one graph (tests put a stub in
    its place)."""

    graph_class = CudaGraph

    def __init__(self, device, enabled, geometry):
        self.device = torch.device(device)
        self.enabled = enabled
        self.geometry = tuple(geometry)
        self._eager_only = set()

    def keys(self):
        """The keys at this comparator's geometry that have a graph."""
        with _lock:
            return {k for k in _cache(self.device).entries
                    if k[0] == self.geometry}

    def run(self, key, fn, inputs, timings, counters):
        """(fn(*inputs on the device), how it ran): fn gives a tuple of
        device tensors and reads nothing of the image but its inputs
        (the geometry and `key` fix the rest), by the graph of the
        geometry and key (module docstring) when enabled, else eagerly;
        how is CAPTURES, REPLAYS, SHARED or EAGER. Each input is a host
        array or a device tensor (a host array and a tensor of one shape
        and dtype share a key); the outputs are the caller's own. Adds
        the seconds of a capture to timings["compare_capture"] (timings
        a dict or None, spans.timed), those of the host arrays' copies
        to timings[UPLOAD] and their bytes to counters[UPLOAD_BYTES]
        (uploading), and the graphs a capture evicts to
        counters[EVICTIONS]."""
        if not self.enabled:
            return fn(*self._on_device(inputs, timings, counters)), EAGER
        key = (self.geometry,) + tuple(key) + tuple(_signature(a)
                                                    for a in inputs)
        with _lock:
            cache = _cache(self.device)
            entry = cache.entries.get(key)
            if entry is not None:
                cache.entries.move_to_end(key)
                mode = REPLAYS if entry.owner() is self else SHARED
            elif self.geometry in cache.warm and \
                    key not in self._eager_only:
                entry, mode = self._capture(key, fn, inputs, timings,
                                            counters), CAPTURES
                if entry is not None:
                    cache.put(key, entry, counters)
            if entry is not None:
                entry.load(inputs, timings, counters)
                entry.graph.replay()
                return tuple(o.clone() for o in entry.outputs), mode
        out = fn(*self._on_device(inputs, timings, counters))
        with _lock:
            _cache(self.device).warm.add(self.geometry)
        return out, EAGER

    def _on_device(self, inputs, timings, counters):
        """The inputs on the device for an eager run: the host arrays
        through to_device, inside one compare_upload span."""
        if all(isinstance(a, torch.Tensor) for a in inputs):
            return list(inputs)
        with uploading(timings, counters, host_bytes(inputs)):
            return [a if isinstance(a, torch.Tensor)
                    else to_device(a, self.device) for a in inputs]

    def _capture(self, key, fn, inputs, timings, counters):
        """The key's entry, captured; None if the capture gave up."""
        entry = _Entry([torch.empty(tuple(a.shape), dtype=_torch_dtype(a),
                                    device=self.device) for a in inputs],
                       self)
        entry.load(inputs, timings, counters)
        cuda = self.device.type == "cuda"
        pool = _pool(self.device)
        with spans.timed(timings, "compare_capture"):
            before = torch.cuda.memory_reserved(self.device) if cuda else 0
            graph = self.graph_class(self.device,
                                     pool.open(self.graph_class,
                                               self.device))
            try:
                with devconst.recording() as consts:
                    outs = graph.capture(lambda: fn(*entry.statics))
            except devconst.Missing:
                # The eager run makes it; the key's next use captures.
                return None
            except torch.cuda.OutOfMemoryError:
                self._eager_only.add(key)
                raise
            except RuntimeError as e:
                self._eager_only.add(key)
                pool.close()
                if not _warned:
                    _warned.append(key)
                    sys.stderr.write("compare graph capture failed (%s); "
                                     "running that compare eagerly\n"
                                     % str(e).split("\n", 1)[0])
                return None
            if cuda:
                pool.bytes += max(
                    0, torch.cuda.memory_reserved(self.device) - before)
        entry.graph, entry.outputs, entry.consts = graph, tuple(outs), consts
        entry.bytes = _nbytes(entry.statics) + _nbytes(entry.outputs)
        return entry


def drop(device):
    """Release every graph on `device`; the keys' next uses capture
    again."""
    with _lock:
        _cache(torch.device(device)).drop()


def drop_all(device):
    """drop() the graphs on `device` and close its pool."""
    device = torch.device(device)
    with _lock:
        _cache(device).drop()
        _pool(device).close()


def pool_bytes(device):
    """Bytes the graph pool on `device` holds: the allocator counts them
    as reserved, but only graphs can use them."""
    return _pool(torch.device(device)).bytes
