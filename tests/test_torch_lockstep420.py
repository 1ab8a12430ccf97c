"""The port's lockstep corpus encoder against its serial encoder, byte for
byte, on the CPU (one torch thread): the 4:2:0 cases of
tests/test_lockstep.py.

  * force_420: the 420y and 420c passes over concatenated blocks;
  * try_420 (test_torch_lockstep_try420.py): the 4:4:4 and the 4:2:0
    pass groups, MaybeOutput keeping the better result as the serial path
    does;
  * JPEG and PNG inputs mixed: a 4:2:0 JPEG runs only the 4:2:0 group, a
    4:4:4 JPEG the 4:4:4 group;
  * a grayscale PNG beside a color one, under try_420 (the gray image
    skips the 4:2:0 group) and under force_420 with use_silver_screen (the
    gray image keeps 4:4:4 geometry in the 4:2:0 pass, a zeroing call of
    its own mode).
"""

import io

import numpy as np
import pytest
from PIL import Image

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, consts
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import zeroing as tz
from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                process_rgb)


def _serial_rgb(data, **kw):
    rgb, w, h = read_png(data)
    params = Params(**kw)
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    return process_rgb(params, rgb, w, h, ProcessStats(), "cpu")


def _spy_zeroing(monkeypatch):
    calls = []
    real = tz.compute_zeroing_csr

    def spy(blocks, *a, **k):
        calls.append((k["mode"], blocks.shape[0]))
        return real(blocks, *a, **k)
    monkeypatch.setattr(tz, "compute_zeroing_csr", spy)
    return calls


def test_force_420(monkeypatch):
    names = ("bees96x64.png", "bees97x63.png")
    inputs = [(n, (FIXTURES / n).read_bytes()) for n in names]
    calls = _spy_zeroing(monkeypatch)
    lock = dict(lockstep.encode_corpus_lockstep(inputs, 95, force_420=True,
                                                device="cpu"))
    # 12x8 + 13x8 Y blocks; 6x4 + 7x4 macroblocks.
    assert calls == [("420y", 200), ("420c", 52)]
    for name, data in inputs:
        assert lock[name] == _serial_rgb(data, force_420=True), name


def test_jpeg_and_png_inputs():
    buf = io.BytesIO()
    Image.open(FIXTURES / "bees96x64.png").save(
        buf, format="JPEG", quality=90, subsampling=2)
    inputs = [("in420.jpg", buf.getvalue()),
              ("plain.png", (FIXTURES / "bees97x63.png").read_bytes()),
              ("in444.jpg", (FIXTURES / "bees96x64_ref_q95.jpg")
               .read_bytes())]
    lock = dict(lockstep.encode_corpus_lockstep(inputs, 95, device="cpu"))
    for name, data in inputs:
        assert lock[name] == api.encode_bytes(data, 95, device="cpu"), name


@pytest.mark.parametrize("kw", [{"try_420": True},
                                {"force_420": True,
                                 "use_silver_screen": True}],
                         ids=["try_420", "force_420_silver_screen"])
def test_grayscale_and_silver_screen(kw, monkeypatch):
    rng = np.random.default_rng(5)
    gray = np.repeat(rng.integers(0, 256, (48, 64, 1), np.uint8), 3, axis=2)
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, format="PNG")
    inputs = [("gray.png", buf.getvalue()),
              ("color.png", (FIXTURES / "bees96x64.png").read_bytes())]
    calls = _spy_zeroing(monkeypatch)
    lock = dict(lockstep.encode_corpus_lockstep(inputs, 95, device="cpu",
                                                **kw))
    if kw.get("force_420"):
        # The 4:2:0 Y pass: the gray image's 4:4:4 blocks and the color
        # image's Y blocks in two calls, one a mode.
        assert sorted(calls[:2]) == [("420y", 96), ("444", 48)]
    for name, data in inputs:
        assert lock[name] == _serial_rgb(data, **kw), (kw, name)
