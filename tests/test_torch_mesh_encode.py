"""One 4:4:4 image over several ranks (guetzli_tpu_torch/parallel/mesh.py,
parallel/banded.py), on gloo CPU ranks, against one device: the compare's
score, diffmap and block weights, the block state and the zeroing CSR bit
for bit at 2 and 3 ranks (synth128x96: 96, 32 and 0 rows at 3 ranks;
bees160x120: 96 and 24 at 2, 48, 48 and 24 at 3), and a bees96x64 q95
encode with the one-device bytes at 2 ranks (the CLI's --mesh 2) and at
3 ranks (an empty band). Port of the JAX package's
tests/test_mesh_encode.py, whose bar is byte identity too.
"""

import pathlib

import numpy as np
import pytest
import torch

from guetzli_tpu_torch import cli, consts
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

FIX = pathlib.Path(__file__).parent / "fixtures"
IMAGES = ("synth128x96.png", "bees160x120.png")
BEES = FIX / "bees96x64.png"


def _setup(name):
    rgb, w, h = read_png((FIX / name).read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    return rgb, w, h, st.CoeffImage.from_jpeg(jpg)


def _compare(comp, img):
    """Score and diffmap of a compare, the weights of both directions,
    the block state and the zeroing CSR of the 4:4:4 pass."""
    d = comp.compare_img(img)
    out = {"distance": d, "distmap": comp.distmap}
    for direction in (1, -1):
        out["w4_%d" % direction] = torch.as_tensor(comp.fetch_compare(
            comp.dispatch_compare_with_weights(img, direction, 1.0, 1,
                                               1))[1])
    comp.start_block_comparisons()
    out["state"] = comp.block_state(1, 1)
    blocks = np.ascontiguousarray(img.coeffs.transpose(1, 0, 2))
    out["csr"] = zeroing.compute_zeroing_csr(
        blocks, blocks, np.float32(comp.block_error_limit()),
        out["state"], 7, comp.device, bands=comp.bands)
    return out


def _compare_ranks(group, out):
    res = {}
    for name in IMAGES:
        rgb, w, h, img = _setup(name)
        comp = Comparator(rgb, w, h, consts.butteraugli_score_for_quality(90),
                          "cpu", mesh=group)
        res[name] = _compare(comp, img)
    torch.save(res, pathlib.Path(out) / ("rank%d.pt" % group.rank))


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh%d" % request.param)
    torch_ranks.run(request.param, _compare_ranks, str(out))
    return [torch.load(out / ("rank%d.pt" % r), weights_only=False)
            for r in range(request.param)]


@pytest.fixture(scope="module")
def single():
    res = {}
    for name in IMAGES:
        rgb, w, h, img = _setup(name)
        comp = Comparator(rgb, w, h, consts.butteraugli_score_for_quality(90),
                          "cpu", mesh=False)
        res[name] = _compare(comp, img)
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
def test_weights_bit_for_bit(ranks, single, name, direction):
    key = "w4_%d" % direction
    for r in ranks:
        assert torch.equal(r[name][key], single[name][key])


@pytest.mark.parametrize("name", IMAGES)
def test_block_state_and_csr_bit_for_bit(ranks, single, name):
    want = single[name]
    for k in range(4):
        got = torch.cat([r[name]["state"][k] for r in ranks])
        assert torch.equal(got, want["state"][k])
    for r in ranks:
        for a, b in zip(r[name]["csr"], want["csr"]):
            np.testing.assert_array_equal(a, b)


def _encode_ranks(group, out):
    from guetzli_tpu_torch import api
    data = BEES.read_bytes()
    got = api.encode_bytes(data, 95, device="cpu")
    if group.rank == 0:
        (pathlib.Path(out) / "out.jpg").write_bytes(got)


@pytest.fixture(scope="module")
def one_device():
    return BEES.read_bytes(), cli_one()


def cli_one():
    from guetzli_tpu_torch import api
    return api.encode_bytes(BEES.read_bytes(), 95, device="cpu")


def test_mesh_encode_three_ranks_with_an_empty_band(tmp_path, monkeypatch,
                                                   one_device):
    """bees96x64's 64 rows are 48, 16 and 0 rows at 3 ranks."""
    monkeypatch.setenv("GUETZLI_TPU_MESH", "3")
    torch_ranks.run(3, _encode_ranks, str(tmp_path))
    assert (tmp_path / "out.jpg").read_bytes() == one_device[1]


def test_cli_mesh_two_ranks(tmp_path, one_device):
    out = tmp_path / "o.jpg"
    assert cli.main(["--cpu", "--mesh", "2", str(BEES), str(out)]) == 0
    assert out.read_bytes() == one_device[1]


def test_cli_mesh_encodes_a_420_input(tmp_path):
    """bees_d-420 (97x63: bands of 48 and 15 rows) through --mesh 2 gives
    the bytes of --mesh 1."""
    src = FIX.parent / "corpus" / "bees_d-420.jpg"
    one, two = tmp_path / "one.jpg", tmp_path / "two.jpg"
    assert cli.main(["--cpu", "--mesh", "1", str(src), str(one)]) == 0
    assert cli.main(["--cpu", "--mesh", "2", str(src), str(two)]) == 0
    assert two.read_bytes() == one.read_bytes()


def test_cli_mesh_usage(tmp_path, capsys):
    for flags in (["--mesh", "0"], ["--mesh", "x"],
                  ["--mesh", "2", "--profile", str(tmp_path)]):
        assert cli.main(["--cpu", *flags, str(BEES),
                         str(tmp_path / "o.jpg")]) == 1
        assert "Usage" in capsys.readouterr().err


def test_mesh_from_env(monkeypatch):
    """GUETZLI_TPU_MESH unset, 0 or 1: one device; N > 1 without a group
    of N ranks raises (no fallback to one device)."""
    from guetzli_tpu_torch import config
    from guetzli_tpu_torch.parallel import mesh
    for v in (None, "0", "1"):
        if v is None:
            monkeypatch.delenv("GUETZLI_TPU_MESH", raising=False)
        else:
            monkeypatch.setenv("GUETZLI_TPU_MESH", v)
        assert mesh.mesh_from_env() is None
    monkeypatch.setenv("GUETZLI_TPU_MESH", "2")
    assert config.mesh() == 2
    with pytest.raises(RuntimeError, match="no group"):
        mesh.mesh_from_env()
    rgb, w, h, _img = _setup(IMAGES[0])
    with pytest.raises(RuntimeError, match="no group"):
        Comparator(rgb, w, h, 1.0, "cpu")
    assert Comparator(rgb, w, h, 1.0, "cpu", mesh=False).mesh is None


def _routes_ranks(group, out):
    rgb, w, h, img = _setup(IMAGES[0])
    comp = Comparator(rgb, w, h, 1.0, "cpu", mesh=group)
    res = [comp.supports_quant_batch(), comp.supports_sparse(img, 7),
           comp.geom is None]
    try:
        Comparator(rgb, w, h, 1.0, "cpu", mesh=group, padded=True)
        res.append("no error")
    except ValueError as e:
        res.append(str(e))
    (pathlib.Path(out) / ("rank%d.txt" % group.rank)).write_text(repr(res))


def test_a_mesh_turns_the_device_state_routes_off(tmp_path):
    """As in the JAX package: no quant waves, no sparse back end, no
    padded geometry under a mesh."""
    torch_ranks.run(2, _routes_ranks, str(tmp_path))
    for r in range(2):
        res = eval((tmp_path / ("rank%d.txt" % r)).read_text())
        assert res[:3] == [False, False, True]
        assert "padded" in res[3]
