"""The row-sharded blur and its halo exchange (guetzli_tpu_torch/parallel/
halo.py), on gloo CPU ranks: bit for bit the single-device blur at 2 and 3
ranks for every sigma the compare blurs with, the strided ones included,
and within the JAX package's sharded-blur tolerance of its blur; each
border fill of the exchange; the 48-row bands of parallel/mesh.py; and
--checkcuda's blur(sharded) line over two ranks.
"""

import contextlib
import io
import pathlib
import re

import numpy as np
import pytest
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.ops.blur import blur
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

# Every (sigma, border ratio) of consts.py's blurs, plus the JAX test's
# (2.0, 0.3).
SIGMAS = ([(consts.OPSIN_SIGMA, 0.0)]
          + [(s, 0.0) for s in consts.EDGE_DETECTOR_SIGMAS]
          + [(consts.EDGE_LF_SIGMA, 0.0)]
          + [(s, 0.0) for s in consts.MASK_SIGMAS]
          + [(consts.DIFFMAP_SIGMA, consts.DIFFMAP_BORDER_RATIO),
             (2.0, 0.3)])
IDS = ["%.4g/%.3g" % s for s in SIGMAS]
H, W = 120, 40          # 48, 48 and 24 rows at 3 ranks; 96 and 24 at 2
FILLS = (0.0, float("inf"), float("-inf"))


def _plane():
    rng = np.random.RandomState(0)
    return rng.rand(2, H, W).astype(np.float32) * 255.0


def _blur_ranks(group, out):
    """Each rank's sharded blurs of its band, and the exchange of each
    fill (2 rows up, 34 down: past the 24-row last band)."""
    from guetzli_tpu_torch.parallel import halo, mesh
    px = mesh.RowBands(H, group).pixels()
    band = torch.as_tensor(_plane())[..., px.lo:px.hi, :]
    res = {"span": (px.lo, px.hi),
           "blur": [halo.sharded_blur(band, s, r, px) for s, r in SIGMAS],
           "fill": [halo.halo_exchange_rows(band, (2, 34), f, px)
                    for f in FILLS]}
    torch.save(res, pathlib.Path(out) / ("rank%d.pt" % group.rank))


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("halo%d" % request.param)
    torch_ranks.run(request.param, _blur_ranks, str(out))
    return [torch.load(out / ("rank%d.pt" % r))
            for r in range(request.param)]


@pytest.mark.parametrize("i", range(len(SIGMAS)), ids=IDS)
def test_sharded_blur_bit_for_bit(ranks, i):
    sigma, ratio = SIGMAS[i]
    got = torch.cat([r["blur"][i] for r in ranks], dim=-2)
    assert torch.equal(got, blur(torch.as_tensor(_plane()), sigma, ratio))


@pytest.mark.parametrize("i", range(len(SIGMAS)), ids=IDS)
def test_sharded_blur_matches_jax(ranks, i):
    """Within the tolerance of JAX's test_sharded_blur_exact."""
    import jax.numpy as jnp

    from guetzli_tpu.ops.blur import blur as jax_blur
    sigma, ratio = SIGMAS[i]
    got = torch.cat([r["blur"][i] for r in ranks], dim=-2).numpy()
    want = np.asarray(jax_blur(jnp.asarray(_plane()), sigma, ratio))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("k", range(len(FILLS)), ids=["0", "+inf", "-inf"])
def test_halo_exchange_fills_past_the_edge(ranks, k):
    """Neighbours' rows where the image goes on, the stage's fill past
    its edges: above the first band, and below the last band's rows
    (the band above the last one reads all 24 of its rows, then fill)."""
    plane = _plane()
    fill = FILLS[k]
    for r in ranks:
        lo, hi = r["span"]
        got = r["fill"][k].numpy()
        want = np.full((2, hi - lo + 36, W), fill, np.float32)
        src_lo, src_hi = max(0, lo - 2), min(H, hi + 34)
        want[:, src_lo - (lo - 2):src_hi - (lo - 2)] = plane[:, src_lo:src_hi]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("height,world,want", [
    (64, 3, [48, 16, 0]),
    (908, 2, [480, 428]),
    (120, 3, [48, 48, 24]),
    (120, 2, [96, 24]),
    (200, 4, [96, 96, 8, 0]),
    (47, 2, [47, 0]),
])
def test_band_ranges(height, world, want):
    from guetzli_tpu_torch.parallel import mesh
    got = mesh.band_ranges(height, world)
    assert [hi - lo for lo, hi in got] == want
    assert got[0][0] == 0 and got[-1][1] == height
    assert all(lo % mesh.UNIT == 0 for lo, hi in got if hi > lo)
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_spans_of_other_row_units():
    """Block rows, the res grid and the diffmap's inner region cut where
    the pixel bands cut."""
    from guetzli_tpu_torch.parallel import mesh

    class _Group:
        world, rank = 3, 1
    b = mesh.RowBands(130, _Group())
    assert (b.lo, b.hi) == (48, 96)
    assert b.blocks().ranges == [(0, 6), (6, 12), (12, 17)]
    assert b.span(3).ranges == [(0, 16), (16, 32), (32, 44)]
    inner = b.span(1, shift=2, size=125)
    assert inner.ranges == [(0, 46), (46, 94), (94, 125)]


def _check_ranks(group, out):
    from guetzli_tpu_torch import checkcl
    err = io.StringIO()
    plane = torch.as_tensor(_plane()[0])
    with contextlib.redirect_stderr(err):
        bad = checkcl.sharded_blur_check(plane, group)
    (pathlib.Path(out) / ("rank%d.txt" % group.rank)).write_text(
        "%d\n%s" % (bad, err.getvalue()))


def test_checkcl_sharded_blur_runs_over_two_ranks(tmp_path):
    """--checkcuda's blur(sharded) line counts mismatches over the ranks
    of a group (SKIPPED on one device, as in the JAX package)."""
    torch_ranks.run(2, _check_ranks, str(tmp_path))
    for r in range(2):
        bad, text = (tmp_path / ("rank%d.txt" % r)).read_text().split(
            "\n", 1)
        assert bad == "0"
        assert re.match(r"checkcl blur\(sharded\): 0/%d mismatches" % (H * W),
                        text), text
