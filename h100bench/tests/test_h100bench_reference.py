"""The plain reference: its decoder against the program's on the
repository's JPEGs (bit for bit), its butteraugli against the program's
float64 oracle, and its independence from the program."""

import ast

import numpy as np
import pytest

from h100bench.reference import distance, jpegdec, tf32
from h100bench.tests import minibench

JPEGS = ["tests/corpus/bees_d-420.jpg", "tests/fixtures/bees96x64_ref_q95.jpg",
         "tests/corpus/photo_hopper-420.jpg"]


@pytest.mark.parametrize("path", JPEGS)
def test_decoder_equals_the_programs(path):
    from guetzli_tpu_torch.codec import reader
    from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb
    data = (minibench.ROOT / path).read_bytes()
    rgb, _sampling = jpegdec.decode(data)
    assert np.array_equal(rgb, decode_jpeg_to_rgb(reader.read_jpeg(data)))


def test_progressive_is_refused():
    data = (minibench.ROOT
            / "tests/corpus/bees_d-progressive.jpg").read_bytes()
    with pytest.raises(jpegdec.JpegFormatError):
        jpegdec.decode(data)


def test_distance_equals_the_programs_oracle():
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.ops import numpy_ref
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-4, 5, a.shape), 0,
                255).astype(np.uint8)
    lut = consts.SRGB_TO_LINEAR
    want = numpy_ref.score_from_diffmap(numpy_ref.diffmap_opsin_dynamics(
        numpy_ref.opsin_dynamics_image(lut[a.transpose(2, 0, 1)]),
        numpy_ref.opsin_dynamics_image(lut[b.transpose(2, 0, 1)])))
    assert distance.distance(a, b) == want


def test_reference_imports_nothing_of_the_program():
    for f in (minibench.BENCH / "reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "guetzli_tpu", "guetzli_tpu_torch", "jax", "jaxlib",
                    "flax"), (f.name, n)
                assert not n.startswith("h100bench.lib"), (f.name, n)


def test_tf32_control():
    """TF32 rounding keeps 10 mantissa bits; the control's DFT is the
    reference's to TF32 precision; its distance differs from the
    reference's by far more than float32 rounding would."""
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159])
    assert list(tf32.round_tf32(x)) == [1.0, 1.0 + 2.0 ** -10,
                                        1.0 + 2.0 ** -10, 3.140625]
    from h100bench.reference import butteraugli64
    b = np.random.default_rng(2).random((4, 8, 8)) * 50
    want = butteraugli64.fft8x8_squared(b)
    assert np.abs(tf32.fft8x8_squared(b) - want).max() < 1e-2 * want.max()
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)
    c = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0,
                255).astype(np.uint8)
    d = distance.distance(a, c)
    assert butteraugli64.blur is not tf32.blur
    assert abs(tf32.distance(a, c) - d) > 1e-5 * d
    assert distance.distance(a, c) == d
