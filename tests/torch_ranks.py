"""Run a function on the ranks of a gloo group of CPU processes.

The port's multi-device tests (tests/test_torch_halo.py,
test_torch_mesh_encode.py) run ``fn(group, *args)`` in `world` spawned
processes, one torch thread each, joined through a FileStore in a fresh
temporary directory (no TCP port, so parallel test workers cannot
collide). A rank that waits longer than `timeout` seconds for its peers
raises, so a hang fails the test instead of eating the suite's limit.
Results come back through files the ranks write under a directory the
caller passes in `args`.
"""

import tempfile

import torch
import torch.multiprocessing as mp

TIMEOUT = 120.0


def run(world, fn, *args, timeout=TIMEOUT):
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_main, nprocs=world, join=True,
                 args=(world, "file://%s/store" % tmp, timeout, fn, args))


def _main(rank, world, init_method, timeout, fn, args):
    torch.set_num_threads(1)
    from guetzli_tpu_torch.parallel import dist
    group = dist.init(world, rank, init_method, device="cpu",
                      timeout=timeout)
    fn(group, *args)
    dist.shutdown()
