"""The port's quant search route (guetzli_tpu_torch/search/quant_tree.py,
Comparator.dispatch_quant_batch) on the CPU, one torch thread, on
bees96x64.png, bees97x63.png and, for 4:2:0, tests/corpus/bees_d-420.jpg
at q95:

  * the device requantize equals the JAX package's and the host's
    bit for bit on seeded int32 coefficients and matrices;
  * a wave's scores for B in {1, 3, 4, 8}, 4:4:4 and 4:2:0, equal the
    port's single compares bit for bit, and the JAX package's waves
    (its padded _quant_batch_444_dyn / _420_dyn) within the 2e-3 band
    of XLA's jitted FMA contraction;
  * the tree gives the result, best matrix, iteration count, output
    bytes and score of the serial loop
    (Processor.select_quant_matrix_serial); the lockstep tree over two images gives each image's serial
    tree; the default encode runs the waves and writes the bytes of an
    encode through the serial loop;
  * an out-of-memory error in a wave is replayed with the same result;
    a sticky CUDA error in a wave propagates, through the encoder's
    resilience too.
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import comparator as jcmp
from guetzli_tpu.codec import reader as jreader
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.search import processor as jproc
from guetzli_tpu.search import state as jst

from guetzli_tpu_torch import api, consts
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import quant_tree
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                ProcessStats, _copy_jpeg)

PNGS = ("bees96x64.png", "bees97x63.png")
JPEG420 = FIXTURES.parent / "corpus" / "bees_d-420.jpg"
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"
STICKY = "CUDA error: an illegal memory access was encountered"


def _load(name):
    """(rgb, w, h, jpg_in) of a fixture PNG or of the 4:2:0 JPEG."""
    if name == "420":
        jpg = reader.read_jpeg(JPEG420.read_bytes())
        return (proc_mod.decode_jpeg_to_rgb(jpg), jpg.width, jpg.height,
                jpg)
    rgb, w, h = read_png((FIXTURES / name).read_bytes())
    return rgb, w, h, encode_rgb_to_jpeg(rgb, w, h)


def _setup(name):
    """A processor at the start of the quant search, as the encoder's
    _run_search sets it up: (proc, jpg, best_q, img, downsample)."""
    rgb, w, h, jpg_in = _load(name)
    params = Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    comp = cmp_mod.Comparator(rgb, w, h, params.butteraugli_target, "cpu")
    proc = Processor(params, comp, ProcessStats())
    proc.final.score = -1
    jpg = _copy_jpeg(jpg_in)
    q_in = st.remove_original_quantization(jpg)
    return proc, jpg, q_in.copy(), st.CoeffImage.from_jpeg(jpg), \
        jpg_in.is_420()


def _outcome(proc, ok, best_q):
    return (ok, best_q.tobytes(), proc.stats.counters["iters"],
            proc.final.jpeg_data, proc.final.score)


def _serial(name):
    proc, jpg, best_q, img, ds = _setup(name)
    ok = proc.select_quant_matrix_serial(jpg, ds, best_q, img)
    return _outcome(proc, ok, best_q)


def test_device_quantize_matches_jax_and_host():
    rng = np.random.RandomState(5)
    c = rng.randint(-2048, 2048, (3, 300, 64)).astype(np.int32)
    q = rng.randint(1, 256, (3, 1, 64)).astype(np.int32)
    got = cmp_mod._device_quantize(torch.as_tensor(c),
                                   torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcmp._device_quantize(c, q)))
    np.testing.assert_array_equal(
        got, np.stack([st.quantize(c[i], q[i]) for i in range(3)]))


def _jax_wave(name, qs):
    """The JAX package's wave scores for the same image and matrices
    (its default padded comparator)."""
    if name == "420":
        jpg = jreader.read_jpeg(JPEG420.read_bytes())
        rgb, w, h = jproc.decode_jpeg_to_rgb(jpg), jpg.width, jpg.height
    else:
        rgb, w, h = jread_png((FIXTURES / name).read_bytes())
        jpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jpg)
    comp = jcmp.Comparator(rgb, w, h,
                           consts.butteraugli_score_for_quality(95))
    base = comp.quant_base_upload(jst.CoeffImage.from_jpeg(jpg))
    return comp.fetch_quant_scores(comp.dispatch_quant_batch(base, qs))


@pytest.mark.parametrize("name", PNGS + ("420",))
def test_wave_scores_equal_single_compares(name):
    proc, _jpg, q_in, img, ds = _setup(name)
    comp = proc.comparator
    qs = quant_tree._enumerate_subtree(proc_mod.QuantMatrixGenerator(ds),
                                       q_in, True, 4)[:8]
    assert len(qs) == 8
    singles = []
    for q in qs:
        t = img.copy()
        t.apply_global_quantization(q)
        singles.append(comp.compare_img(t))
    base = comp.quant_base_upload(img)
    assert comp.supports_quant_batch()
    assert comp.quant_batch_sizes() == (4, 8)
    for b in (1, 3, 4, 8):
        got = comp.fetch_quant_scores(comp.dispatch_quant_batch(base,
                                                                qs[:b]))
        assert got.shape == (b,) and got.dtype == np.float64
        assert list(got) == singles[:b], (name, b)
    # The band of the port's compares against jitted JAX
    # (test_torch_jpeg420.test_compare_420_and_weights): 2e-3 relative,
    # and absolute near 0 (the input's own matrix scores ~5e-5 there).
    want = _jax_wave(name, qs)
    np.testing.assert_allclose(singles, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", PNGS + ("420",))
def test_tree_matches_serial(name):
    serial = _serial(name)
    proc, jpg, best_q, img, ds = _setup(name)
    ok = quant_tree.select_quant_matrix_tree(proc, jpg, ds, best_q, img)
    assert _outcome(proc, ok, best_q) == serial
    assert proc.stats.counters["quant_waves"] >= 2
    assert proc.stats.counters["quant_trials"] == serial[2]


def test_lockstep_tree_matches_each_serial_tree():
    serial = []
    for name in PNGS:
        proc, jpg, best_q, img, ds = _setup(name)
        ok = quant_tree.select_quant_matrix_tree(proc, jpg, ds, best_q,
                                                 img)
        serial.append(_outcome(proc, ok, best_q))
    sets = [_setup(name) for name in PNGS]
    oks = quant_tree.lockstep_select_quant_matrix_tree(
        [s[0] for s in sets], [s[1] for s in sets], [s[4] for s in sets],
        [s[2] for s in sets], [s[3] for s in sets])
    assert [_outcome(s[0], ok, s[2]) for s, ok in zip(sets, oks)] == serial


def _fail_waves(monkeypatch, exc, calls):
    real = cmp_mod.Comparator.dispatch_quant_batch
    n = [0]

    def wrapped(self, base, qs):
        n[0] += 1
        if n[0] in calls:
            raise exc
        return real(self, base, qs)
    monkeypatch.setattr(cmp_mod.Comparator, "dispatch_quant_batch", wrapped)
    return n


def test_wave_oom_is_replayed(monkeypatch):
    name = PNGS[0]
    serial = _serial(name)
    released = []
    from guetzli_tpu_torch import runtime
    monkeypatch.setattr(runtime, "release_memory",
                        lambda device, what: released.append(what))
    n = _fail_waves(monkeypatch, torch.cuda.OutOfMemoryError(OOM), {1, 3})
    proc, jpg, best_q, img, ds = _setup(name)
    ok = quant_tree.select_quant_matrix_tree(proc, jpg, ds, best_q, img)
    assert _outcome(proc, ok, best_q) == serial
    assert len(released) == 2 and n[0] > 3


def test_sticky_error_in_a_wave_propagates(monkeypatch):
    _fail_waves(monkeypatch, RuntimeError(STICKY), {2})
    proc, jpg, best_q, img, ds = _setup(PNGS[0])
    with pytest.raises(RuntimeError, match="illegal memory access"):
        quant_tree.select_quant_matrix_tree(proc, jpg, ds, best_q, img)
    # Through the encoder, whose default route is the waves: the
    # search's resilience lets a sticky error through instead of emitting
    # the pre-search output.
    monkeypatch.undo()
    _fail_waves(monkeypatch, RuntimeError(STICKY), {2})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        api.encode_bytes((FIXTURES / PNGS[0]).read_bytes(), 95,
                         device="cpu")


def test_tree_encode_runs_waves_and_keeps_the_bytes(monkeypatch):
    data = JPEG420.read_bytes()
    stats = ProcessStats()
    out = api.encode_bytes(data, 95, stats=stats, device="cpu")
    assert stats.counters["quant_waves"] >= 2
    serial_calls = []
    real = Processor.select_quant_matrix_serial
    monkeypatch.setattr(Processor, "select_quant_matrix_serial",
                        lambda self, *a: serial_calls.append(1)
                        or real(self, *a))
    monkeypatch.setattr(cmp_mod.Comparator, "supports_quant_batch",
                        lambda self: False)
    serial_stats = ProcessStats()
    assert api.encode_bytes(data, 95, stats=serial_stats,
                            device="cpu") == out
    assert "quant_waves" not in serial_stats.counters
    assert serial_calls == [1]
