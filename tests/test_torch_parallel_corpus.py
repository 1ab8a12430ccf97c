"""The sharded corpus search step (guetzli_tpu_torch/parallel/corpus.py) on
gloo CPU ranks. Port of the JAX package's tests/test_parallel.py
test_sharded_search_step_numerics and test_mesh_factoring:

  * at one rank, against the JAX package's single-device _compare_one and
    _zeroing_eval_one on the same seeded inputs (RandomState(7), two
    32x96 images): the scores and errors within JAX's own rtol 1e-3,
    atol 1e-3, the new coefficients equal to JAX run op by op;
  * at (batch, tile) = (2, 1), (1, 2) and (2, 2): bit for bit the port's
    one-rank step, kernel C's wrapper called once per rank per step over
    3 x its band's blocks x its images' lanes;
  * the device form of candidate_scores against JAX's;
  * dryrun_multichip at 1, 2 and 4 ranks; make_mesh's layout.
"""

import pathlib

import numpy as np
import pytest
import torch

from guetzli_tpu_torch.parallel import corpus
from guetzli_tpu_torch.search import zeroing as tz
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

W, H, B = 32, 96, 2
LIMIT = 1.0
LAYOUTS = {1: [1], 2: [2, 1], 4: [2]}        # world -> batch axes


def _inputs():
    rng = np.random.RandomState(7)
    rgbs = [rng.randint(0, 256, size=(H, W, 3), dtype=np.uint8)
            for _ in range(B)]
    return corpus.step_inputs(rgbs, "cpu")


def _step_ranks(group, out):
    """Every layout of LAYOUTS[world]: this rank's step outputs and the
    lanes of each call of kernel C's wrapper; then dryrun_multichip."""
    from guetzli_tpu_torch.kernels import tile_compare as kc
    args = _inputs()
    lanes = []
    real = kc.tile_compare

    def spy(cand, *a):
        lanes.append(cand.shape[0])
        return real(cand, *a)
    kc.tile_compare = spy
    res = {}
    for batch in LAYOUTS[group.world]:
        mesh = corpus.make_mesh(group, batch)
        del lanes[:]
        step = corpus.make_search_step(mesh, W // 8, H // 8, W, H)
        got = step(*args, np.float32(LIMIT))
        res[batch] = {"out": got, "lanes": list(lanes),
                      "place": (mesh.b, mesh.t, mesh.tile)}
    kc.tile_compare = real
    res["dryrun"] = corpus.dryrun_multichip(group)
    torch.save(res, pathlib.Path(out) / ("rank%d.pt" % group.rank))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp("step%d" % world)
    torch_ranks.run(world, _step_ranks, str(out))
    return world, [torch.load(out / ("rank%d.pt" % r), weights_only=False)
                   for r in range(world)]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The step's outputs at one rank."""
    out = tmp_path_factory.mktemp("step_one")
    torch_ranks.run(1, _step_ranks, str(out))
    return torch.load(out / "rank0.pt", weights_only=False)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's single-device compare and evaluation of each image, run op
    by op (jax.disable_jit): (scores, new_coeffs [B, NB, 3, 64], errs [B,
    NB, 3]) as numpy."""
    import jax
    import jax.numpy as jnp

    from guetzli_tpu.parallel import corpus as jc
    coeffs, orig, xyb0, tiles, scales, ysels, xsels = _inputs()
    scores, new, errs = [], [], []
    with jax.disable_jit():
        for i in range(B):
            s, _ = jc._compare_one(jnp.asarray(coeffs[i]),
                                   jnp.asarray(xyb0[i]), bw=W // 8,
                                   bh=H // 8, w=W, h=H)
            nbt = np.transpose(coeffs[i], (1, 0, 2))
            nbo = np.transpose(orig[i], (1, 0, 2))
            nc, e = jc._zeroing_eval_one(
                jnp.asarray(nbt), jnp.asarray(nbo), jnp.asarray(tiles[i]),
                jnp.asarray(scales[i]), jnp.asarray(ysels[i]),
                jnp.asarray(xsels[i]), jnp.float32(LIMIT))
            scores.append(float(s))
            new.append(np.asarray(nc))
            errs.append(np.asarray(e))
    return np.array(scores), np.stack(new), np.stack(errs)


def test_one_rank_against_jax(one_rank, jax_ref):
    """Scores and errors within JAX's own tolerance."""
    scores, _new, errs = one_rank[1]["out"]
    jscores, _jnew, jerrs = jax_ref
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(errs.numpy(), jerrs, rtol=1e-3, atol=1e-3)


def test_one_rank_new_coeffs_equal_jax_op_by_op(one_rank, jax_ref):
    new = one_rank[1]["out"][1].numpy()
    np.testing.assert_array_equal(new, jax_ref[1])
    # The round zeroed something: the comparison is not of the inputs.
    assert (new != np.transpose(_inputs()[0], (0, 2, 1, 3))).any()


def test_layouts_bit_for_bit_the_one_rank_step(ranks, one_rank):
    world, res = ranks
    for batch in LAYOUTS[world]:
        for r in res:
            for got, want in zip(r[batch]["out"], one_rank[1]["out"]):
                assert torch.equal(got, want)


def test_kernel_c_once_per_rank_per_step(ranks):
    """3 lanes per block of the rank's band (48 of the 96 rows at two
    tile ranks), of each of its images."""
    world, res = ranks
    nbw = W // 8
    for batch in LAYOUTS[world]:
        for r in res:
            _b, _t, tile = r[batch]["place"]
            rows = (H // 8) // tile
            assert r[batch]["lanes"] == [3 * rows * nbw * (B // batch)]


class _Flat:
    """A group's shape alone: its subgroups are their ranks."""

    def __init__(self, world, rank):
        self.world, self.rank = world, rank

    def subgroup(self, ranks):
        return ranks if self.rank in ranks else None


@pytest.mark.parametrize("world,batch,tile", [(8, 2, 4), (4, 2, 2),
                                              (3, 1, 3), (1, 1, 1)])
def test_make_mesh_factoring(world, batch, tile):
    """JAX's default batch axis; rank r at (r // tile, r % tile), its
    tile row and batch column."""
    for r in range(world):
        m = corpus.make_mesh(_Flat(world, r))
        assert (m.batch, m.tile, m.b, m.t) == (batch, tile, r // tile,
                                               r % tile)
        assert m.tile_group == [m.b * tile + j for j in range(tile)]
        assert m.batch_group == [i * tile + m.t for i in range(batch)]
    with pytest.raises(ValueError):
        corpus.make_mesh(_Flat(world, 0), batch=world + 1)


def test_layout_places(ranks):
    world, res = ranks
    for batch in LAYOUTS[world]:
        tile = world // batch
        assert [r[batch]["place"] for r in res] == [
            (k // tile, k % tile, tile) for k in range(world)]


def _check_dryrun(world, res):
    for r in res:
        d = r["dryrun"]
        assert len(d["scores"]) == (2 if world % 2 == 0 else 1)
        assert np.isfinite(d["scores"]).all()
        assert d["blur_max_diff"] <= 1e-5
        assert d["bytes"] > 100
    assert all(r["dryrun"] == res[0]["dryrun"] for r in res)


def test_dryrun_multichip(ranks):
    _check_dryrun(*ranks)


def test_dryrun_multichip_one_rank(one_rank):
    _check_dryrun(1, [one_rank])


@pytest.mark.parametrize("new_model", [True, False])
@pytest.mark.parametrize("mask", [7, 1, 6])
def test_candidate_scores_equal_jax(new_model, mask):
    import jax.numpy as jnp

    from guetzli_tpu.search import zeroing as jz
    rng = np.random.RandomState(3)
    blocks = rng.randint(-40, 41, size=(50, 3, 64)).astype(np.int32)
    blocks[rng.rand(*blocks.shape) < 0.4] = 0
    orig = rng.randint(-300, 301, size=(50, 3, 64)).astype(np.int32)
    got = tz.candidate_scores(torch.as_tensor(blocks), torch.as_tensor(orig),
                              mask, new_model).numpy()
    want = np.asarray(jz.candidate_scores(jnp.asarray(blocks),
                                          jnp.asarray(orig), mask,
                                          new_model))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tz.candidate_scores_host(blocks, orig, mask, new_model))
