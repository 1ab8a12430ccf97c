"""The sharded corpus search step: a batch of images over a ('batch', 'tile')
mesh of ranks.

Port of guetzli_tpu/parallel/corpus.py. One step is a whole-image compare
and one greedy zeroing evaluation round (lookahead 3) for every image of a
batch of same-geometry images: the unit the JAX package's multi-device dry
run jits. The JAX package shards its operands over the mesh and lets XLA
SPMD partition the step; the port runs it SPMD by hand:

  * ``batch``: image i goes to the ranks of batch index i % batch;
  * ``tile``: of each image, a tile rank takes its band of pixel rows and
    of block rows (parallel/mesh.RowBands over the tile group). The
    compare is the banded 4:4:4 chain of parallel/banded.py, its score
    max-reduced over the tile group; the evaluation round is per block.

The JAX mesh splits the rows evenly. The port's bands start on multiples
of 48 rows (parallel/mesh.py), which keeps the strided blurs' grids, so
the tile axis splits an image only at 48-row boundaries: with T tile
ranks, a rank holds rows only if the image has more than 48 (T - 1) rows.

Every rank's candidates of one step go through kernel C
(kernels/tile_compare.py) in one launch; on CPU tensors its plain
version. The scores and the per-block outputs are gathered, first over
the tile group, then over the batch group, so every rank returns the
whole batch.
"""

import collections

import numpy as np
import torch

from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.parallel import banded
from guetzli_tpu_torch.parallel.mesh import RowBands
from guetzli_tpu_torch.search import zeroing

K = zeroing.K

Mesh = collections.namedtuple(
    "Mesh", "batch tile b t tile_group batch_group")
Mesh.__doc__ = """A ('batch', 'tile') mesh from this rank's view: the axes'
sizes, this rank's (batch index, tile index), the Group of its tile row
(halos, the score's max) and the Group of its batch column (the
gathers of the batch's results)."""


def make_mesh(group, batch=None):
    """Lay the ranks of `group` (parallel/dist.Group) out as (batch, tile),
    rank r at (r // tile, r % tile); batch defaults to JAX's: 2 when the
    world is even and larger than 1, else 1. Every rank of the group must
    call it (it creates every subgroup, in one order)."""
    n = group.world
    if batch is None:
        batch = 2 if n % 2 == 0 and n > 1 else 1
    if batch < 1 or n % batch:
        raise ValueError("a batch axis of %d does not divide %d ranks"
                         % (batch, n))
    tile = n // batch
    b, t = divmod(group.rank, tile)
    tile_group = batch_group = None
    for i in range(batch):
        g = group.subgroup([i * tile + j for j in range(tile)])
        if i == b:
            tile_group = g
    for j in range(tile):
        g = group.subgroup([i * tile + j for i in range(batch)])
        if j == t:
            batch_group = g
    return Mesh(batch, tile, b, t, tile_group, batch_group)


def compare_one(coeffs, xyb0, bw, bands, w):
    """JAX _compare_one on a band: this rank's block rows of a 4:4:4
    image's coefficients [3, NB_band, 64] and its pixel rows of the
    original's opsin [3, n, W] -> the score over the tile group."""
    px = bands.pixels()
    dmap = xyb0.new_zeros((0, w))
    if px.n:
        xyb1 = banded.opsin(banded.linear_rgb(coeffs, bw, bands, w), px)
        dmap = banded.diffmap(xyb0, xyb1, bands)
    return banded.score(dmap, bands)


def zeroing_eval(blocks, orig, xyb0_tiles, scales, ysel, xsel, limit):
    """JAX _zeroing_eval_one over N blocks of any images: blocks, orig [N,
    3, 64] int32 and their compare state -> (new blocks [N, 3, 64], errs
    [N, 3]). Each block's three lowest-scored candidates (a stable sort)
    go through kernel C, the strict argmin of their errors is zeroed when
    its error is at or below `limit`."""
    n = blocks.shape[0]
    flat = blocks.reshape(n, K)
    if n == 0:
        return blocks, torch.zeros((0, 3), device=blocks.device)
    order = zeroing.candidate_scores(blocks, orig, 7).argsort(
        dim=1, stable=True)[:, :3]
    cand = flat[:, None, :].repeat(1, 3, 1).scatter_(2, order[:, :, None], 0)
    sy, sx = kc.selection_matrices(ysel, xsel)

    def rep(a):
        return a.repeat_interleave(3, dim=0).contiguous()
    errs = kc.tile_compare(cand.reshape(3 * n, 3, 64), rep(xyb0_tiles),
                           rep(scales), rep(sy), rep(sx)).reshape(n, 3)
    min_err, best = errs.min(dim=1)
    best_idx = order.gather(1, best[:, None])
    zeroed = flat.scatter(1, best_idx, 0)
    keep = (min_err <= limit)[:, None]
    return torch.where(keep, zeroed, flat).reshape(n, 3, 64), errs


def make_search_step(mesh, bw, bh, w, h):
    """The sharded search step over a batch of B images of w x h pixels
    (bw x bh blocks, NB = bw * bh), on this rank's device:

      step(coeffs, orig, xyb0, xyb0_tiles, scales, ysel, xsel, limit)
        -> (scores [B], new_coeffs [B, NB, 3, 64], errs [B, NB, 3])

    with the JAX package's operand layout: coeffs, orig [B, 3, NB, 64]
    int32; xyb0 [B, 3, H, W] float32; xyb0_tiles [B, NB, 3, 64];
    scales [B, NB, 3]; ysel, xsel [B, NB, 8]; limit a float. The
    operands are whole (numpy or tensors, on any device); each rank
    takes its images and their bands. Every rank returns the whole
    batch."""
    tile, bat = mesh.tile_group, mesh.batch_group
    dev = tile.device
    bands = RowBands(h, tile)
    px, bs = bands.pixels(), bands.blocks()
    if bs.size != bh:
        raise ValueError("%d block rows for %d pixel rows" % (bh, h))
    rows = slice(bs.lo * bw, bs.hi * bw)

    def up(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev).contiguous()
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def step(coeffs, orig, xyb0, xyb0_tiles, scales, ysel, xsel, limit):
        nimg = len(coeffs)
        if nimg < mesh.batch:
            raise ValueError("%d images for a batch axis of %d"
                             % (nimg, mesh.batch))
        mine = range(mesh.b, nimg, mesh.batch)
        score = torch.stack([compare_one(up(coeffs[i][:, rows]),
                                         up(xyb0[i][:, px.lo:px.hi]), bw,
                                         bands, w) for i in mine])

        def blocks_of(a):                  # [3, NB, 64] each -> [N, 3, 64]
            return torch.cat([up(a[i][:, rows]).transpose(0, 1)
                              for i in mine]).contiguous()

        def rows_of(a):
            return torch.cat([up(a[i][rows]) for i in mine])
        new, errs = zeroing_eval(
            blocks_of(coeffs), blocks_of(orig), rows_of(xyb0_tiles),
            rows_of(scales), rows_of(ysel), rows_of(xsel),
            float(np.float32(limit)))
        shards = [len(range(j, nimg, mesh.batch)) for j in range(mesh.batch)]
        counts = [c * bw for c in bs.counts()]

        def gather(x):
            # [Bs * NB_band, ...] -> [NB_band, Bs, ...]: the tile gather
            # concatenates block rows, then the batch gather images.
            x = x.reshape((len(mine), bs.n * bw) + tuple(x.shape[1:]))
            x = tile.all_gather_rows(x.transpose(0, 1).contiguous(), counts)
            return _unshard(bat.all_gather_rows(
                x.transpose(0, 1).contiguous(), shards), mesh.batch)
        return (_unshard(bat.all_gather_rows(score, shards), mesh.batch),
                gather(new), gather(errs))

    return step


def _unshard(x, batch):
    """Rows in shard order (shard j holds images j, j + batch, ...) ->
    image order."""
    nimg = x.shape[0]
    order = np.concatenate([np.arange(j, nimg, batch) for j in range(batch)])
    return x[torch.as_tensor(np.argsort(order), device=x.device)]


def _toy_image(w, h, seed=0):
    """The JAX dry run's image: seeded uniform bytes [h, w, 3]."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)


def step_inputs(rgbs, device):
    """The search step's operands of same-geometry images rgbs [h, w, 3]
    uint8: their initial JPEG coefficients (also the originals), the
    opsin of each original and each one's block state from a one-device
    Comparator at target 1.0, as numpy (the JAX dry run's inputs)."""
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.comparator import Comparator
    h, w = rgbs[0].shape[:2]
    coeffs, xyb0, state = [], [], []
    for rgb in rgbs:
        jpg = encode_rgb_to_jpeg(rgb, w, h)
        coeffs.append(np.stack([c.coeffs.astype(np.int32)
                                for c in jpg.components]))
        comp = Comparator(rgb, w, h, 1.0, device, padded=False, mesh=False)
        xyb0.append(comp.xyb0.cpu().numpy())
        comp.start_block_comparisons()
        state.append([a.cpu().numpy() for a in comp.block_state(1, 1)])
    coeffs = np.stack(coeffs)
    return (coeffs, coeffs.copy(), np.stack(xyb0),
            *[np.stack([s[k] for s in state]) for k in range(4)])


def dryrun_multichip(group):
    """The port's counterpart of the JAX package's dryrun_multichip, over
    the ranks of `group`: the search step on tiny shapes (one image per
    batch shard, 48 rows per tile rank), the sharded blur against the
    single blur, and a mesh encode of the 48x40 gradient image at q90
    over every rank. Returns what it checked: {"scores", "blur_max_diff",
    "bytes"}."""
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.ops.blur import blur
    from guetzli_tpu_torch.parallel.halo import sharded_blur
    from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                    process_rgb)
    dev = group.device
    mesh = make_mesh(group)
    w, h = 32, 48 * mesh.tile
    bw, bh = w // 8, h // 8
    b = mesh.batch
    args = step_inputs([_toy_image(w, h, seed=i) for i in range(b)], dev)
    step = make_search_step(mesh, bw, bh, w, h)
    scores, new_coeffs, errs = step(*args, np.float32(1.0))
    if tuple(scores.shape) != (b,) or tuple(new_coeffs.shape) != (
            b, bw * bh, 3, 64) or tuple(errs.shape) != (b, bw * bh, 3):
        raise RuntimeError("search step: shapes %s %s %s" % (
            tuple(scores.shape), tuple(new_coeffs.shape), tuple(errs.shape)))
    if not bool(torch.isfinite(scores).all()):
        raise RuntimeError("search step: scores %s" % scores.tolist())

    # The explicit halo exchange over every rank.
    n = group.world
    img = torch.linspace(0, 255, 48 * n * 32, device=dev).reshape(48 * n, 32)
    px = RowBands(48 * n, group).pixels()
    got = group.all_gather_rows(
        sharded_blur(img[px.lo:px.hi], 1.5, 0.0, px), px.counts())
    want = blur(img, 1.5, 0.0)
    diff = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-5 + 1e-6 * want.abs()).all()):
        raise RuntimeError("sharded blur: max difference %g" % diff)

    # The production mesh path: one image encoded over every rank.
    y, x = np.mgrid[0:40, 0:48]
    rgb = np.stack([(x * 5) % 256, (y * 6) % 256, (x + y) * 3 % 256],
                   axis=-1).astype(np.uint8)
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(90)
    out = process_rgb(params, rgb, 48, 40, ProcessStats(), dev, group)
    if out[:2] != b"\xff\xd8" or len(out) <= 100:
        raise RuntimeError("mesh encode: %d bytes" % len(out))
    return {"scores": scores.tolist(), "blur_max_diff": diff,
            "bytes": len(out)}


def _dryrun_job(group):
    out = dryrun_multichip(group)
    if group.rank == 0:
        print("dryrun_multichip(%d ranks): %s" % (group.world, out))
    return 0


def main(argv):
    """python -m guetzli_tpu_torch.parallel.corpus [--cpu] [N]: the dry
    run over N ranks (default 2) that this command starts, on the card
    (cuda:{rank % device_count}) or with --cpu on the CPU."""
    from guetzli_tpu_torch import cli
    cpu = "--cpu" in argv
    rest = [a for a in argv if a != "--cpu"]
    n = int(rest[0]) if rest else 2
    return cli.run_ranks(n, _dryrun_job, device="cpu" if cpu else None)


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
