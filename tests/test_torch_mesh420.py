"""One 4:2:0 image over several ranks (guetzli_tpu_torch/parallel/banded.py
linear_rgb_420, the comparator's 4:2:0 state on a band, kernels B' and
B'' per band), on gloo CPU ranks, against one device, bit for bit at 2
and 3 ranks:

  * the compare's score and diffmap, and the block weights at factor 2
    (16x16 blocks) in both directions;
  * the frozen 4:2:0 zeroing state (each rank's rows against the same
    rows of one device): the chroma bytes of the Y pass, the Y bytes, the
    chroma neighborhoods and the children of the chroma pass; a child
    outside the image gathers another block on a band than on one
    device, which the kernels never read, so the children's state is
    compared where it is valid (and the validity everywhere);
  * the CSR of the Y pass ("420y") and of the chroma pass ("420c");
  * bees97x63 with force_420 at q95: the one-device bytes (port of the
    JAX package's tests/test_mesh_encode.py
    test_mesh_encode_odd_geometry_420).

Images: bees160x120 re-encoded 4:2:0 (bands of 96 and 24 rows at 2 ranks;
48, 48 and 24 at 3) and bees_d-420.jpg (97x63: 48 and 15 rows; then 48,
15 and 0, the last band's subsampled rows ending at 32, not at hi / 2).
"""

import pathlib

import numpy as np
import pytest
import torch

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing
from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                decode_jpeg_to_rgb,
                                                process_rgb)
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

FIX = pathlib.Path(__file__).parent / "fixtures"
CORPUS = pathlib.Path(__file__).parent / "corpus"
IMAGES = ("bees160x120.png", "bees_d-420.jpg")
STATES = ("chroma_bytes", "y16", "neigh_u", "neigh_v")
CHILDREN = ("tiles", "scales", "ysel", "xsel")
# The quant of the zeroing passes' state: 8 for Y, 16 for chroma.
QUANT = np.repeat(np.array([8, 16, 16], np.int32)[:, None], 64, axis=1)


def _setup(name):
    """(rgb, w, h, the 4:2:0 CoeffImage) of a test image."""
    if name.endswith(".png"):
        rgb, w, h = read_png((FIX / name).read_bytes())
        jpg = encode_rgb_to_jpeg(rgb, w, h)
        st.remove_original_quantization(jpg)
        img = st.CoeffImage.from_jpeg(jpg)
        img.downsample()
    else:
        jpg = reader.read_jpeg((CORPUS / name).read_bytes())
        rgb, w, h = decode_jpeg_to_rgb(jpg), jpg.width, jpg.height
        st.remove_original_quantization(jpg)
        img = st.CoeffImage.from_jpeg(jpg)
    assert not img.is_444()
    img.apply_global_quantization(QUANT)
    return rgb, w, h, img


def _blocks(img, mask):
    grid = img.comps[mask.bit_length() - 1]
    out = np.zeros((grid.bw * grid.bh, 3, 64), np.int32)
    for c in range(3):
        if (mask >> c) & 1:
            out[:, c] = img.comps[c].coeffs
    return out


def _run(comp, img):
    """Score and diffmap, the factor-2 weights of both directions, the
    frozen state of both passes and their CSRs."""
    out = {"distance": comp.compare_img(img), "distmap": comp.distmap}
    for direction in (1, -1):
        out["w4_%d" % direction] = torch.as_tensor(comp.fetch_compare(
            comp.dispatch_compare_with_weights(img, direction, 1.0, 2,
                                               2))[1])
    cgrid = img.comps[1]
    limit = np.float32(comp.block_error_limit())
    for mode, mask, factor in (("420y", 1, 1), ("420c", 6, 2)):
        comp.start_block_comparisons()
        if mode == "420y":
            aux = (comp.frozen_chroma_blocks(img),) + comp.block_state(1, 1)
            out["chroma_bytes"] = aux[0]
        else:
            nu, nv = comp.frozen_neighborhoods(img)
            y16 = comp.frozen_y_16x16(img, cgrid.bw, cgrid.bh)
            children = comp.children_state(cgrid.bw, cgrid.bh)
            aux = (nu, nv, y16) + children
            out.update(neigh_u=nu, neigh_v=nv, y16=y16,
                       children=children)
        blocks = _blocks(img, mask)
        out[mode] = zeroing.compute_zeroing_csr(
            blocks, blocks, limit, aux, mask, comp.device, mode=mode,
            bands=comp.bands, factor=factor)
        comp.finish_block_comparisons()
    return out


def _encode_97x63():
    rgb, w, h = read_png((FIX / "bees97x63.png").read_bytes())
    params = Params(force_420=True)
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    return process_rgb(params, rgb, w, h, ProcessStats(), "cpu")


def _ranks_main(group, out):
    res = {}
    for name in IMAGES:
        rgb, w, h, img = _setup(name)
        comp = Comparator(rgb, w, h, consts.butteraugli_score_for_quality(90),
                          "cpu", mesh=group)
        res[name] = _run(comp, img)
    import os
    os.environ["GUETZLI_TPU_MESH"] = str(group.world)
    res["bees97x63"] = _encode_97x63()
    torch.save(res, pathlib.Path(out) / ("rank%d.pt" % group.rank))


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh420_%d" % request.param)
    torch_ranks.run(request.param, _ranks_main, str(out))
    return [torch.load(out / ("rank%d.pt" % r), weights_only=False)
            for r in range(request.param)]


@pytest.fixture(scope="module")
def single():
    res = {}
    for name in IMAGES:
        rgb, w, h, img = _setup(name)
        comp = Comparator(rgb, w, h, consts.butteraugli_score_for_quality(90),
                          "cpu", mesh=False)
        res[name] = _run(comp, img)
    res["bees97x63"] = _encode_97x63()
    return res


@pytest.mark.parametrize("name", IMAGES)
def test_score_and_diffmap_bit_for_bit(ranks, single, name):
    want = single[name]
    for r in ranks:
        assert r[name]["distance"] == want["distance"]
    got = torch.cat([r[name]["distmap"] for r in ranks])
    assert torch.equal(got, want["distmap"])


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("direction", [1, -1])
def test_factor2_weights_bit_for_bit(ranks, single, name, direction):
    key = "w4_%d" % direction
    for r in ranks:
        assert torch.equal(r[name][key], single[name][key])


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("key", STATES)
def test_frozen_state_bit_for_bit(ranks, single, name, key):
    got = torch.cat([r[name][key] for r in ranks])
    assert torch.equal(got, single[name][key])


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("k", range(len(CHILDREN)))
def test_children_state_bit_for_bit_where_valid(ranks, single, name, k):
    want, valid = single[name]["children"][k], single[name]["children"][4]
    got_valid = torch.cat([r[name]["children"][4] for r in ranks])
    assert torch.equal(got_valid, valid)
    got = torch.cat([r[name]["children"][k] for r in ranks])
    assert got.shape == want.shape
    assert torch.equal(got[valid], want[valid])


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("mode", ["420y", "420c"])
def test_csr_bit_for_bit(ranks, single, name, mode):
    for r in ranks:
        for a, b in zip(r[name][mode], single[name][mode]):
            np.testing.assert_array_equal(a, b)


def test_encode_odd_geometry_420_gives_the_one_device_bytes(ranks, single):
    """bees97x63, force_420, q95: 48 and 15 rows at 2 ranks, 48, 15 and 0
    at 3."""
    for r in ranks:
        assert r["bees97x63"] == single["bees97x63"]
