"""Traffic generation: deterministic per seed, sized per the cell's file,
the same sizes in the same proportions for every seed; and the inputs
PIL makes, read back by PIL and by the plain decoder."""

import io
import json

import numpy as np
import pytest

from PIL import Image

from h100bench.lib import traffic
from h100bench.reference import jpegdec
from h100bench.tests import minibench

CELLS = sorted(p.stem for p in (minibench.BENCH / "traffic").glob("*.json"))


def _small(t):
    """The cell's traffic cut to its first group, for speed."""
    t = dict(t)
    t["deck"] = t["deck"][:int(t.get("group", len(t["deck"])))]
    return t


def _config(cell_name):
    return json.loads((minibench.BENCH / "configs" / (
        cell_name.split(".")[0] + ".json")).read_text())


@pytest.mark.parametrize("cell_name", CELLS)
def test_deck_per_seed(cell_name):
    t = _small(json.loads((minibench.BENCH / "traffic" / (
        cell_name + ".json")).read_text()))
    cfg = _config(cell_name)
    a = traffic.generate(t, cfg, 11)
    b = traffic.generate(t, cfg, 11)
    c = traffic.generate(t, cfg, 12)
    assert [x["data"] for x in a] == [x["data"] for x in b]
    assert [x["data"] for x in a] != [x["data"] for x in c]
    want = sorted((e.get("out_w", e["w"]), e.get("out_h", e["h"]))
                  for e in t["deck"])
    for items in (a, c):
        assert sorted((x["width"], x["height"]) for x in items) == want
        for x in items:
            assert x["rgb"].shape == (x["height"], x["width"], 3)


def test_groups_hold_every_size():
    t = json.loads((minibench.BENCH / "traffic" /
                    "png444_q95.photo_serial.json").read_text())
    sizes = {(e["w"], e["h"]) for e in t["deck"]}
    order = [t["deck"][s] for s in
             [x["slot"] for x in traffic.generate(
                 dict(t, deck=t["deck"]), {"input": {"kind": "png"}}, 3)]]
    g = t["group"]
    for k in range(0, len(order), g):
        assert {(e["w"], e["h"]) for e in order[k:k + g]} == sizes


def test_png_input_is_the_crop():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    data = traffic.input_bytes(rgb, {"input": {"kind": "png"}})
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), rgb)


@pytest.mark.parametrize("sub", ["420", "444"])
def test_jpeg_input_decodes_to_the_crop(sub):
    src = traffic._load_sources(["photo_hopper"])["photo_hopper"]
    crop = np.ascontiguousarray(src[33:33 + 75, 17:17 + 101])
    data = traffic.input_bytes(crop, {"input": {
        "kind": "jpeg", "quality": 90, "subsampling": sub}})
    rgb, sampling = jpegdec.decode(data)
    assert sampling == sub and rgb.shape == crop.shape
    assert np.abs(rgb.astype(int) - crop).mean() < 3.0
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert np.abs(pil.astype(int) - rgb).max() <= 2


def test_thumbnails_are_downscaled_to_their_size():
    t = {"deck": [dict(minibench.TINY[0], out_w=20, out_h=16)]}
    (item,) = traffic.generate(t, {"input": {"kind": "png"}}, 5)
    assert item["rgb"].shape == (16, 20, 3)
    assert (item["width"], item["height"]) == (20, 16)
