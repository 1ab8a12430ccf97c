"""guetzli_tpu_torch end to end on the CPU: codec bytes against the JAX
package, the PNG reader, the bees q95 encodes (PNG, 4:4:4 and 4:2:0 JPEG,
forced 4:2:0) against the reference encoder's golden sizes, the CLI, and
the device rule (the entry points run on CUDA unless the CPU is asked for,
and never fall back)."""

import io
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu.codec import writer as jwriter
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.io.png import read_png as jread_png

from guetzli_tpu_torch import api, cli, device
from guetzli_tpu_torch.codec import writer
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search.processor import ProcessStats

# Reference-encoder output for bees96x64 at q95 (tests/test_e2e.py).
REF_96x64_Q95 = 2364
CORPUS = FIXTURES.parent / "corpus"


@pytest.fixture(scope="module")
def bees_png():
    return (FIXTURES / "bees96x64.png").read_bytes()


@pytest.fixture(scope="module")
def bees_encode(bees_png):
    stats = ProcessStats()
    out = api.encode_bytes(bees_png, quality=95, stats=stats, device="cpu")
    return out, stats


def test_read_png_matches_jax(bees_png):
    rgb, w, h = read_png(bees_png)
    jrgb, jw, jh = jread_png(bees_png)
    assert (w, h) == (jw, jh) == (96, 64)
    np.testing.assert_array_equal(rgb, jrgb)
    with pytest.raises(ValueError):
        read_png(b"not a png at all")


@pytest.mark.parametrize("crop", [(96, 64), (37, 29)])
def test_codec_bytes_match_jax(bees_png, crop):
    """encode_rgb_to_jpeg + write_jpeg give the JAX package's bytes."""
    rgb, _, _ = read_png(bees_png)
    w, h = crop
    sub = np.ascontiguousarray(rgb[:h, :w])
    for quant in (None, np.full((3, 64), 7, dtype=np.int32)):
        got = writer.write_jpeg(encode_rgb_to_jpeg(sub, w, h, quant=quant),
                                True)
        want = jwriter.write_jpeg(jencode(sub, w, h, quant=quant), True)
        assert got == want


def test_encode_bees_q95(bees_encode):
    out, stats = bees_encode
    assert stats.search_error is None
    assert abs(len(out) - REF_96x64_Q95) <= 0.02 * REF_96x64_Q95, len(out)
    from guetzli_tpu_torch import consts
    target = consts.butteraugli_score_for_quality(95)
    assert stats.final_distance is not None
    assert stats.final_distance <= target
    assert stats.counters["zeroing_passes"] == 1
    assert stats.counters["quant_trials"] >= 1
    assert stats.counters["backend_iters"] >= 1
    from PIL import Image
    im = Image.open(io.BytesIO(out))
    im.load()
    assert im.size == (96, 64)


def test_small_image_passthrough():
    """Images under 32x32 skip the comparator (processor.cc:971-977)."""
    import PIL.Image
    buf = io.BytesIO()
    PIL.Image.new("RGB", (16, 16), (120, 130, 140)).save(buf, "PNG")
    stats = ProcessStats()
    out = api.encode_bytes(buf.getvalue(), 95, stats=stats, device="cpu")
    assert out[:2] == b"\xff\xd8" and stats.final_distance is None


def test_jpeg_input_not_ported(tmp_path):
    """JPEG input is ported: a 40x40 4:2:0 JPEG goes through
    api.encode_bytes and through the CLI (exit 0) to the same bytes."""
    import PIL.Image
    rgb, _, _ = read_png((FIXTURES / "bees96x64.png").read_bytes())
    buf = io.BytesIO()
    PIL.Image.fromarray(np.ascontiguousarray(rgb[:40, :40])).save(
        buf, "JPEG", quality=90, subsampling=2)
    stats = ProcessStats()
    out = api.encode_bytes(buf.getvalue(), 95, stats=stats, device="cpu")
    assert out[:2] == b"\xff\xd8" and stats.search_error is None
    assert stats.counters["zeroing_passes"] == 2      # Y and chroma passes
    src = tmp_path / "in.jpg"
    src.write_bytes(buf.getvalue())
    assert cli.main(["--cpu", str(src), str(tmp_path / "o.jpg")]) == 0
    assert (tmp_path / "o.jpg").read_bytes() == out
    src.write_bytes(b"\xff\xd8 truncated")
    assert cli.main(["--cpu", str(src), str(tmp_path / "o.jpg")]) == 1
    with pytest.raises(ValueError):
        api.encode_bytes(b"\xff\xd8 truncated", device="cpu")


def test_cli_cpu(tmp_path):
    src = tmp_path / "in.png"
    dst = tmp_path / "out.jpg"
    import PIL.Image
    rgb, _, _ = read_png((FIXTURES / "bees96x64.png").read_bytes())
    PIL.Image.fromarray(np.ascontiguousarray(rgb[:40, :40])).save(src)
    assert cli.main(["--cpu", "--quality", "90", "--c", str(src),
                     str(dst)]) == 0
    assert dst.read_bytes()[:2] == b"\xff\xd8"
    assert cli.main(["--bogus", str(src), str(dst)]) == 1
    assert cli.main(["--cpu", str(src)]) == 1
    assert cli.main(["--cpu", "--memlimit", "1", str(src), str(dst)]) == 1


def test_device_defaults_to_cuda(monkeypatch, bees_png, tmp_path):
    """Without a GPU, an entry point not asked for the CPU raises (the
    CLI exits 1); it does not silently run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError):
        api.encode_bytes(bees_png)
    src = tmp_path / "in.png"
    src.write_bytes(bees_png)
    assert cli.main([str(src), str(tmp_path / "o.jpg")]) == 1
    assert device.resolve("cpu").type == "cpu"


def test_resolve_disables_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    device.resolve("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.benchmark is False


def test_resolve_cuda_one_host_thread(monkeypatch):
    """On the card the host's tensor copies run on one intra-op thread;
    the CPU device keeps the caller's pool."""
    n = torch.get_num_threads()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        torch.set_num_threads(3)
        assert device.resolve("cpu").type == "cpu"
        assert torch.get_num_threads() == 3
        assert device.resolve("cuda").type == "cuda"
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(n)


def test_cli_module_runs(tmp_path):
    """python -m guetzli_tpu_torch.cli is an entry point."""
    r = subprocess.run([sys.executable, "-m", "guetzli_tpu_torch.cli"],
                       capture_output=True, timeout=120)
    assert r.returncode == 1 and b"Usage" in r.stderr


def test_python_fallbacks_byte_parity(bees_png, monkeypatch):
    """Without the native library (flip loop, quantize, histograms, scan
    writer), the pure-Python paths give the same bytes."""
    from guetzli_tpu_torch import consts, native
    from guetzli_tpu_torch.search.processor import Params, process_rgb
    rgb, _, _ = read_png(bees_png)
    sub = np.ascontiguousarray(rgb[:40, :48])
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    want = process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = process_rgb(params, sub, 48, 40, ProcessStats(), "cpu")
    assert got == want


def _golden(name, quality=95):
    """The reference encoder's size for a tests/golden_corpus.txt row."""
    for line in (FIXTURES.parent / "golden_corpus.txt").read_text() \
            .splitlines():
        parts = line.split()
        if parts and parts[0] == name and int(parts[1]) == quality:
            return int(parts[2])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["bees_d-420.jpg",
                                  "bees_d-progressive.jpg"])
def test_encode_jpeg_q95_golden(name):
    """A 4:2:0 JPEG (the two-pass 4:2:0 search: greedy zeroing modes 420y
    and 420c) and a 4:4:4 progressive one, 97x63, within 2% of the
    reference encoder's size, at or below the target distance."""
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.codec import reader
    stats = ProcessStats()
    out = api.encode_bytes((CORPUS / name).read_bytes(), 95, stats=stats,
                           device="cpu")
    golden = _golden(name)
    assert abs(len(out) - golden) <= 0.02 * golden, (len(out), golden)
    assert stats.search_error is None
    assert stats.final_distance <= consts.butteraugli_score_for_quality(95)
    back = reader.read_jpeg(out)
    assert (back.width, back.height) == (97, 63)
    if "420" in name:
        assert back.is_420() and stats.counters["zeroing_passes"] == 2


def test_force_420_png_smaller_than_444(bees_png, bees_encode):
    """Params.force_420 from a PNG (CoeffImage.downsample, then both 4:2:0
    passes) gives a 4:2:0 JPEG smaller than the 4:4:4 encode
    (tests/test_e2e_420.py::test_force_420_from_png)."""
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.search.processor import Params
    out444, _ = bees_encode
    stats = ProcessStats()
    out = api.encode_bytes(bees_png, 95, params=Params(force_420=True),
                           stats=stats, device="cpu")
    assert stats.search_error is None
    assert reader.read_jpeg(out).is_420()
    assert len(out) < len(out444)


def test_unsupported_jpeg_takes_the_pixel_path():
    """A grayscale JPEG is decoded to pixels (codec/full_decode.py) and
    encoded from them: the bytes equal process_rgb on those pixels."""
    import PIL.Image
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.codec import full_decode, reader
    from guetzli_tpu_torch.search.processor import Params, process_rgb
    rgb, _, _ = read_png((FIXTURES / "bees96x64.png").read_bytes())
    buf = io.BytesIO()
    PIL.Image.fromarray(np.ascontiguousarray(rgb[:40, :40])).convert(
        "L").save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    out = api.encode_bytes(data, 95, device="cpu")
    pix, w, h = full_decode.decode_any_to_rgb(reader.read_jpeg(data))
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    assert out == process_rgb(params, pix, w, h, ProcessStats(), "cpu")
