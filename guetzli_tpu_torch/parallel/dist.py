"""The process group of the port's multi-device work (torch.distributed).

Counterpart of the JAX package's ``jax.distributed`` use
(tools/corpus_encode.py:56-66, parallel/api.py:10-13). Every rank is one
process; ``init`` joins it to the group and fixes its device and its
transport:

  * ``gloo``: the ranks run on the CPU (``device="cpu"``);
  * ``nccl``: every rank owns a card of its own (``cuda:{rank %
    device_count}``, no two ranks on one physical device);
  * ``gloo-staged``: ranks share a card. NCCL refuses two ranks on one
    device, so the tensors go through gloo, staged through pinned host
    memory.

The mode follows from the ranks' devices (their host names and card
UUIDs, gathered over gloo at init), is printed once on stderr by rank 0,
and never changes after an error: a rank that cannot reach its device or
its peers raises, and nothing falls back to one rank or to the CPU.

The collectives the port needs are the methods of ``Group``: the halo
rows' point-to-point exchange (parallel/halo.py), a max all-reduce of
the score, and an all-gather of per-band rows (the greedy rails and the
block weights). Every rank must issue them in the same order.

``Group.subgroup`` makes a Group of some of the ranks (the rows and
columns of parallel/corpus.py's ('batch', 'tile') mesh). A Group speaks
in its own ranks, 0 .. world - 1; its point-to-point peers are mapped to
the global ranks that torch.distributed's P2POp takes.
"""

import datetime
import socket
import sys

import torch
import torch.distributed as dist

_GROUP = None


class Group:
    """This process's place in the group: rank, world, device, mode.

    pg: the process group of the tensor collectives (NCCL's in mode
    "nccl"; None: the default, world-wide gloo group); gloo: the gloo
    group of the barrier (None: the default one); ranks: the global rank
    of each of this group's ranks (None: the world, in order)."""

    def __init__(self, rank, world, device, mode, pg=None, gloo=None,
                 ranks=None, timeout=None):
        self.rank = rank
        self.world = world
        self.device = device
        self.mode = mode
        self._pg = pg
        self._gloo = gloo
        self._ranks = ranks
        self._timeout = timeout

    def __repr__(self):
        return "Group(rank=%d, world=%d, device=%s, mode=%s)" % (
            self.rank, self.world, self.device, self.mode)

    def _global(self, rank):
        """The global rank of this group's `rank`."""
        return rank if self._ranks is None else self._ranks[rank]

    def _wire(self, t):
        """The tensor the transport sends: itself, or a pinned host copy."""
        t = t.contiguous()
        if self.mode != "gloo-staged":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t)

    def _buffer(self, shape, dtype):
        if self.mode == "gloo-staged":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def sendrecv(self, sends, recvs):
        """Point-to-point: sends [(peer, tensor)], recvs [(peer, shape,
        dtype)] -> the received tensors on this rank's device, in recvs'
        order. Both sides of a pair list each other."""
        ops, bufs = [], []
        for peer, t in sends:
            ops.append(dist.P2POp(dist.isend, self._wire(t),
                                  self._global(peer), group=self._pg))
        for peer, shape, dtype in recvs:
            b = self._buffer(shape, dtype)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, self._global(peer),
                                  group=self._pg))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(self.device) for b in bufs]

    def all_reduce_max(self, t):
        """The max of a tensor over the ranks, on this rank's device."""
        w = self._wire(t)
        if w is t or w.data_ptr() == t.data_ptr():
            w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self._pg)
        return w.to(self.device)

    def all_gather_rows(self, t, counts):
        """Every rank's rows t [counts[rank], ...] concatenated in rank
        order -> [sum(counts), ...] on every rank."""
        top = max(counts)
        pad = t.new_zeros((top,) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        w = self._wire(pad)
        parts = [self._buffer(w.shape, w.dtype) for _ in range(self.world)]
        dist.all_gather(parts, w, group=self._pg)
        return torch.cat([p[:n].to(self.device)
                          for p, n in zip(parts, counts)])

    def barrier(self):
        dist.barrier(group=self._gloo)

    def subgroup(self, ranks):
        """The Group of this group's `ranks` (ascending), or None on a
        rank outside them. Every rank of the world (torch.distributed's
        default group) must call it, with the same ranks, in the same
        order of calls."""
        glob = [self._global(r) for r in ranks]
        wait = self._timeout
        gloo = dist.new_group(glob, timeout=wait, backend="gloo")
        pg = gloo
        if self.mode == "nccl":
            pg = dist.new_group(glob, timeout=wait, backend="nccl")
        me = self._global(self.rank)
        if me not in glob:
            return None
        return Group(glob.index(me), len(glob), self.device, self.mode, pg,
                     gloo, glob, wait)


def _rank_device(rank, device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("rank %d: no CUDA device; pass device='cpu' "
                           "(--cpu) to run the ranks on the CPU" % rank)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init(world, rank, init_method, device=None, timeout=120.0):
    """Join this process to a group of `world` ranks as `rank`, through
    torch.distributed's `init_method` ("file://...", "tcp://host:port" or
    "env://"). device: "cpu" for every rank on the CPU; None for
    cuda:{rank % device_count}. timeout: seconds a collective may wait
    for its peers before it raises. Returns the Group."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("this process already belongs to a group")
    dev = _rank_device(rank, device)
    if device is None:
        from guetzli_tpu_torch.device import resolve
        resolve(dev)
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank, timeout=wait)
    mode, nccl = "gloo", None
    if dev.type == "cuda":
        where = [None] * world
        dist.all_gather_object(
            where, (socket.gethostname(),
                    str(torch.cuda.get_device_properties(dev).uuid)))
        if len(set(where)) == world:
            mode = "nccl"
            nccl = dist.new_group(backend="nccl", timeout=wait)
            warm = torch.zeros(1, device=dev)
            dist.all_reduce(warm, group=nccl)
        else:
            mode = "gloo-staged"
    if rank == 0:
        sys.stderr.write("parallel: %d rank(s), transport %s (%s)\n"
                         % (world, mode, "cpu" if dev.type == "cpu"
                            else "cuda:{rank %% %d}"
                            % torch.cuda.device_count()))
    _GROUP = Group(rank, world, dev, mode, nccl, timeout=wait)
    return _GROUP


def current():
    """This process's Group, or None outside a group."""
    return _GROUP


def shutdown(wait=True):
    """Leave the group, after every rank has come here if `wait`."""
    global _GROUP
    if _GROUP is None:
        return
    if wait:
        dist.barrier()
    dist.destroy_process_group()
    _GROUP = None
