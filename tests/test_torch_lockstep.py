"""The port's lockstep corpus encoder (guetzli_tpu_torch/parallel/
lockstep.py) on the CPU, one torch thread.

  * against the port's serial encode (api.encode_bytes), byte for byte:
    the 3-PNG corpus of tests/test_lockstep.py (with one zeroing call per
    masking pass for the whole corpus), the same corpus on 3 threads,
    and under GUETZLI_TPU_PALLAS=1 (mode 444p); the 4:2:0 cases are in
    test_torch_lockstep420.py, the combined zeroing call against JAX in
    test_torch_lockstep_csr.py;
  * the corpus quant search (the port's lockstep tree waves) against the
    JAX package's lockstep rounds (exact geometry, its serial trials):
    the same decisions (best matrices, dist_ok, iteration counts) and,
    image by image, the same trials in the same order, every trial's
    distance within the 2e-3 band of XLA's jitted FMA contraction
    (ROADMAP: the port equals JAX op by op; jitted JAX differs by up to
    2e-3 relative).
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu import consts as jconsts
from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.io.png import read_png as jread_png
from guetzli_tpu.parallel import lockstep as jlockstep
from guetzli_tpu.search import processor as jproc
from guetzli_tpu.search import state as jst

from guetzli_tpu_torch import api, consts
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import quant_tree
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing as tz

CPU = torch.device("cpu")
NAMES = ("bees96x64.png", "synth128x96.png", "bees97x63.png")
# XLA's FMA contraction under jit: JAX's own jitted vs op-by-op distances.
FMA_BAND = 2e-3


@pytest.fixture(scope="module")
def corpus():
    return [(n, (FIXTURES / n).read_bytes()) for n in NAMES]


@pytest.fixture(scope="module")
def serial(corpus):
    return {n: api.encode_bytes(d, 95, device="cpu") for n, d in corpus}


def _spy_zeroing(monkeypatch):
    """Records the mode and block count of every zeroing call."""
    calls = []
    real = tz.compute_zeroing_csr

    def spy(blocks, *a, **k):
        calls.append((k["mode"], blocks.shape[0]))
        return real(blocks, *a, **k)
    monkeypatch.setattr(tz, "compute_zeroing_csr", spy)
    return calls


@pytest.fixture(scope="module")
def lock1(corpus):
    mp = pytest.MonkeyPatch()
    calls = _spy_zeroing(mp)
    try:
        out = dict(lockstep.encode_corpus_lockstep(corpus, 95, device="cpu"))
    finally:
        mp.undo()
    return out, calls


def test_corpus_matches_serial(lock1, serial):
    """One zeroing call (one greedy launch on the card) covers every
    image's blocks: 12x8 + 16x12 + 13x8 = 392."""
    out, calls = lock1
    for name in NAMES:
        assert out[name] == serial[name], (name, len(out[name]),
                                           len(serial[name]))
    assert calls == [("444", 392)]


def test_threads_give_same_bytes(corpus, lock1):
    out3 = dict(lockstep.encode_corpus_lockstep(corpus, 95, threads=3,
                                                device="cpu"))
    assert out3 == lock1[0]


def test_pallas_corpus_matches_serial(corpus, serial, monkeypatch):
    """Mode 444p (the staged loop with kernel C per step) gives the
    default path's bytes, as the serial encoder's 444p does."""
    monkeypatch.setenv("GUETZLI_TPU_PALLAS", "1")
    calls = _spy_zeroing(monkeypatch)
    out = dict(lockstep.encode_corpus_lockstep(corpus, 95, device="cpu"))
    assert calls == [("444p", 392)]
    assert out == serial


# -- the quant rounds against JAX ---------------------------------------

def _trail(monkeypatch, side):
    """Records (comparator id, distance) as each trial's distance is
    adopted: after JAX's _quant_resolve, at the port's
    set_quant_result."""
    trail = []
    if side == "jax":
        real = jproc.Processor._quant_resolve

        def spy(self, *a, **k):
            out = real(self, *a, **k)
            trail.append((id(self.comparator), self.comparator.distance))
            return out
        monkeypatch.setattr(jproc.Processor, "_quant_resolve", spy)
        return trail
    real_set = Comparator.set_quant_result

    def spy_set(self, *a):
        real_set(self, *a)
        trail.append((id(self), self.distance))
    monkeypatch.setattr(Comparator, "set_quant_result", spy_set)
    return trail


def test_quant_rounds_vs_jax(monkeypatch):
    monkeypatch.setenv("GUETZLI_TPU_PAD", "0")
    sides = {}
    for side in ("jax", "port"):
        trail = _trail(monkeypatch, side)
        procs, jpgs, best_qs, imgs = [], [], [], []
        for name in NAMES:
            data = (FIXTURES / name).read_bytes()
            if side == "jax":
                rgb, w, h = jread_png(data)
                target = jconsts.butteraugli_score_for_quality(95)
                comp = JComparator(rgb, w, h, target)
                assert comp.geom is None
                proc = jproc.Processor(jproc.Params(), comp,
                                       jproc.ProcessStats())
                jpg, s = jencode(rgb, w, h), jst
            else:
                rgb, w, h = read_png(data)
                target = consts.butteraugli_score_for_quality(95)
                proc = proc_mod.Processor(
                    proc_mod.Params(), Comparator(rgb, w, h, target, CPU),
                    proc_mod.ProcessStats())
                jpg, s = encode_rgb_to_jpeg(rgb, w, h), st
            proc.final.score = -1
            best_qs.append(s.remove_original_quantization(jpg).copy())
            procs.append(proc)
            jpgs.append(jpg)
            imgs.append(s.CoeffImage.from_jpeg(jpg))
        select = (jlockstep.lockstep_select_quant_matrix if side == "jax"
                  else quant_tree.lockstep_select_quant_matrix_tree)
        oks = select(procs, jpgs, [False] * len(NAMES), best_qs, imgs)
        ids = {id(p.comparator): i for i, p in enumerate(procs)}
        # Each image's trials in its own order: JAX's rounds interleave
        # the images a trial at a time, the port's a wave at a time.
        sides[side] = (oks, best_qs,
                       [p.stats.counters["iters"] for p in procs],
                       [[d for k, d in trail if ids[k] == i]
                        for i in range(len(procs))])
    (j_ok, j_q, j_iters, j_trail), (p_ok, p_q, p_iters, p_trail) = \
        sides["jax"], sides["port"]
    assert p_ok == j_ok
    for a, b in zip(p_q, j_q):
        np.testing.assert_array_equal(a, b)
    assert p_iters == j_iters
    assert [len(t) for t in p_trail] == [len(t) for t in j_trail] \
        == p_iters
    for p_d, j_d in zip(p_trail, j_trail):
        np.testing.assert_allclose(p_d, j_d, rtol=FMA_BAND)
