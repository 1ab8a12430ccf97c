"""The port's error recovery (guetzli_tpu_torch/runtime) and its corpus
entry points' edges, on the CPU, one torch thread.

  * the predicates: only torch.cuda.OutOfMemoryError is recoverable; a
    RuntimeError whose first line names a CUDA error is sticky;
  * an OutOfMemoryError injected into the fetches (a quant wave, a
    back-end iteration, the lockstep corpus's first compares, its
    combined fetch and its zeroing call) is replayed after the comparator's device state is
    rebuilt on the same device, and the bytes are those of a run without
    it; a sticky error propagates, through the serial search's resilience
    and through the corpus encoders alike;
  * fetch_compare_many completes several comparators' compares with the
    results and side effects of fetch_compare;
  * api.encode_corpus and the lockstep encoder record None for a
    truncated JPEG and go on; without a card and without the CPU asked
    for, both raise and the corpus CLI exits 1; the corpus CLI on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import api, corpus_cli, runtime
from guetzli_tpu_torch import comparator as cmp_mod
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import zeroing as tz
from guetzli_tpu_torch.search.processor import ProcessStats

NAMES = ("bees96x64.png", "bees97x63.png")
OOM = "CUDA out of memory. Tried to allocate 2.00 MiB"
STICKY = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(scope="module")
def corpus():
    return [(n, (FIXTURES / n).read_bytes()) for n in NAMES]


@pytest.fixture(scope="module")
def serial(corpus):
    return {n: api.encode_bytes(d, 95, device="cpu") for n, d in corpus}


def test_predicates():
    oom = torch.cuda.OutOfMemoryError(OOM)
    assert runtime.is_recoverable(oom) and not runtime.is_sticky(oom)
    for e in (RuntimeError(STICKY), torch.AcceleratorError(STICKY),
              RuntimeError("zeroing_loop launch failed: CUDA error 700")):
        assert runtime.is_sticky(e) and not runtime.is_recoverable(e), e
    for e in (ValueError(STICKY), RuntimeError("shapes differ\n" + STICKY),
              RuntimeError("out of memory"), KeyError("CUDA error")):
        assert not runtime.is_sticky(e) and not runtime.is_recoverable(e), e


def _fail(monkeypatch, owner, name, exc, calls):
    """owner.name raises exc on the calls numbered in `calls` (from 1)."""
    real = getattr(owner, name)
    n = [0]

    def wrapped(*a, **k):
        n[0] += 1
        if n[0] in calls:
            raise exc
        return real(*a, **k)
    monkeypatch.setattr(owner, name, wrapped)
    return n


def _recoveries(monkeypatch):
    """Counts recover_device_state calls, checking that each rebuilds the
    original's opsin on the comparator's own device."""
    seen = []
    real = cmp_mod.Comparator.recover_device_state

    def spy(self):
        before = self.xyb0
        real(self)
        assert self.xyb0.device == self.device == before.device
        assert torch.equal(self.xyb0, before) and self.distmap is None
        seen.append(self)
    monkeypatch.setattr(cmp_mod.Comparator, "recover_device_state", spy)
    return seen


def test_oom_in_serial_fetches_is_replayed(corpus, serial, monkeypatch):
    seen = _recoveries(monkeypatch)
    oom = torch.cuda.OutOfMemoryError(OOM)
    waves = _fail(monkeypatch, cmp_mod.Comparator, "fetch_quant_scores",
                  oom, {2})
    back = _fail(monkeypatch, cmp_mod.Comparator, "fetch_compare", oom,
                 {2, 3})
    stats = ProcessStats()
    name, data = corpus[0]
    assert api.encode_bytes(data, 95, stats=stats, device="cpu") \
        == serial[name]
    assert stats.search_error is None
    assert waves[0] > 2 and back[0] > 3 and len(seen) == 3


def test_oom_in_lockstep_is_replayed(corpus, serial, monkeypatch):
    seen = _recoveries(monkeypatch)
    oom = torch.cuda.OutOfMemoryError(OOM)
    _fail(monkeypatch, cmp_mod.Comparator, "fetch_compare_plain", oom, {2})
    many = _fail(monkeypatch, cmp_mod, "fetch_compare_many", oom, {1, 3})
    zero = _fail(monkeypatch, tz, "compute_zeroing_csr", oom, {1})
    # The first image's fetch after the combined fetch's failure fails
    # again: its replay follows.
    _fail(monkeypatch, cmp_mod.Comparator, "fetch_compare", oom, {1})
    released = []
    monkeypatch.setattr(runtime, "release_memory",
                        lambda device, what: released.append(what))
    out = dict(lockstep.encode_corpus_lockstep(corpus, 95, device="cpu"))
    assert out == serial
    assert many[0] > 3 and zero[0] == 2
    assert len(seen) == 2
    assert sorted(set(released)) == ["a compare", "corpus zeroing",
                                     "the corpus back end"]


def test_sticky_error_propagates(corpus, monkeypatch):
    seen = _recoveries(monkeypatch)
    sticky = RuntimeError(STICKY)
    # Inside the search (a quant wave, after the first compare): the
    # serial resilience must not swallow it, nor the corpus record it and
    # go on.
    for encode in (lambda: api.encode_bytes(corpus[0][1], 95, device="cpu"),
                   lambda: api.encode_corpus(corpus, 95, device="cpu")):
        with monkeypatch.context() as m:
            _fail(m, cmp_mod.Comparator, "fetch_quant_scores", sticky, {2})
            with pytest.raises(RuntimeError, match="illegal memory access"):
                encode()
    with monkeypatch.context() as m:
        _fail(m, cmp_mod, "fetch_compare_many", sticky, {1})
        with pytest.raises(RuntimeError, match="illegal memory access"):
            lockstep.encode_corpus_lockstep(corpus, 95, device="cpu")
    assert seen == []


def test_other_search_errors_keep_the_resilience(corpus, monkeypatch):
    """A search error that is not a CUDA error still ends in the best
    output so far, with stats.search_error set (processor.cc:965-977)."""
    name, data = corpus[0]
    _fail(monkeypatch, cmp_mod.Comparator, "fetch_quant_scores",
          ValueError("bad trial"), {2})
    stats = ProcessStats()
    out = api.encode_bytes(data, 95, stats=stats, device="cpu")
    assert out[:2] == b"\xff\xd8" and "bad trial" in stats.search_error


def test_fetch_compare_many_matches_fetch_compare():
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    comps, imgs = [], []
    for name in NAMES:
        rgb, w, h = read_png((FIXTURES / name).read_bytes())
        comps.append(cmp_mod.Comparator(rgb, w, h, 1.0, "cpu"))
        img = st.CoeffImage.from_jpeg(
            proc_mod.encode_rgb_to_jpeg(rgb, w, h))
        imgs.append(img)
    handles = [c.dispatch_compare_with_weights(i, -1, 1.0, 1, 1)
               for c, i in zip(comps, imgs)]
    want = [c.fetch_compare(h) for c, h in zip(comps, handles)]
    maps = [c.distmap for c in comps]
    for c in comps:
        c.distance, c.distmap = -1.0, None
    got = cmp_mod.fetch_compare_many(comps, handles)
    assert cmp_mod.fetch_compare_many([], []) == []
    for c, m, (d, w4), (gd, gw4) in zip(comps, maps, want, got):
        assert gd == d == c.distance and c.distmap is m
        assert gw4.dtype == w4.dtype and gw4.shape == w4.shape
        np.testing.assert_array_equal(gw4, w4)


def _truncated():
    return (FIXTURES.parent / "corpus" / "bees_d-420.jpg").read_bytes()[:300]


def test_corpus_records_none_for_a_truncated_jpeg(corpus, serial):
    """The data ends inside a Huffman table segment: the reader raises
    JpegError (the JAX package's reader an IndexError)."""
    with pytest.raises(reader.JpegError, match="truncated"):
        reader.read_jpeg(_truncated())
    with pytest.raises(ValueError):
        api.encode_bytes(_truncated(), 95, device="cpu")
    png = corpus[0][1]
    items = [corpus[0], ("trunc.jpg", _truncated())]
    got = api.encode_corpus(items, 95, device="cpu")
    assert [(n, d) for n, d, _s in got] == [(corpus[0][0],
                                             serial[corpus[0][0]]),
                                            ("trunc.jpg", None)]
    assert all(s >= 0 for _n, _d, s in got)
    lock = lockstep.encode_corpus_lockstep(
        [("trunc.jpg", _truncated()), ("bad.png", b"\x89PNG junk"),
         ("same.png", png)], 95, device="cpu")
    assert lock == [("trunc.jpg", None), ("bad.png", None),
                    ("same.png", serial[corpus[0][0]])]


def test_no_card_and_no_cpu_asked(monkeypatch, tmp_path, corpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.encode_corpus(corpus, 95)
    with pytest.raises(RuntimeError, match="CUDA"):
        lockstep.encode_corpus_lockstep(corpus, 95)
    assert corpus_cli.main(["--out", str(tmp_path),
                            str(FIXTURES / NAMES[0])]) == 1
    assert not list(tmp_path.iterdir())


def test_corpus_cli_on_the_cpu(tmp_path, capsys, serial):
    trunc = tmp_path / "trunc.jpg"
    trunc.write_bytes(_truncated())
    out = tmp_path / "out"
    rc = corpus_cli.main(["--cpu", "--quality", "95", "--out", str(out),
                          str(FIXTURES / NAMES[0]), str(trunc)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert line["images"] == 2 and line["encoded"] == 1
    assert line["bytes"] == len(serial[NAMES[0]])
    assert (out / "bees96x64.jpg").read_bytes() == serial[NAMES[0]]
    # Host sharding: every 2nd file from the 2nd, here the truncated one.
    rc = corpus_cli.main(["--cpu", "--serial", "--num-hosts", "2",
                          "--host-index", "1", "--out", str(out),
                          str(FIXTURES / NAMES[0]), str(trunc)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and (line["host"], line["images"], line["encoded"]) \
        == (1, 1, 0)
    # Two inputs with one stem keep their own outputs (16x16: no search).
    import io

    from PIL import Image
    img = Image.fromarray(np.full((16, 16, 3), 90, np.uint8))
    for fmt, ext in (("PNG", "png"), ("JPEG", "jpg")):
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        (tmp_path / ("x." + ext)).write_bytes(buf.getvalue())
    assert corpus_cli.main(["--cpu", "--out", str(out),
                            str(tmp_path / "x.png"),
                            str(tmp_path / "x.jpg")]) == 0
    capsys.readouterr()
    for name in ("x.png", "x.jpg"):
        want = api.encode_bytes((tmp_path / name).read_bytes(), 95,
                                device="cpu")
        assert (out / (name + ".jpg")).read_bytes() == want
    # --distributed: a group of one gloo rank encodes every file, with
    # the serial bytes.
    from guetzli_tpu_torch.parallel import dist
    one = tmp_path / "one"
    try:
        assert corpus_cli.main(
            ["--cpu", "--distributed", "--coordinator",
             "file://%s" % (tmp_path / "store"), "--out", str(one),
             str(tmp_path / "x.png"), str(tmp_path / "x.jpg")]) == 0
    finally:
        dist.shutdown(wait=False)
    assert '"host": 0' in capsys.readouterr().out
    for name in ("x.png", "x.jpg"):
        assert ((one / (name + ".jpg")).read_bytes()
                == (out / (name + ".jpg")).read_bytes())
    # A coordinator that is no address, or one without --distributed.
    for flags, why in ((["--distributed", "--coordinator", "nohost"],
                        "host:port"),
                       (["--coordinator", "localhost:1"], "--distributed")):
        assert corpus_cli.main(["--cpu", *flags, "--out", str(out),
                                str(trunc)]) == 1
        assert why in capsys.readouterr().err


def test_memory_guard_warns_from_the_measured_envelope(capsys):
    """The reference's contract decides; on the card the measured process
    envelope (base + bytes per pixel) adds a warning above the limit."""
    from guetzli_tpu_torch import cli
    px = 1 << 20
    envelope = cli.K_MEASURED_BASE_MB + cli.K_MEASURED_BYTES_PER_PIXEL
    assert cli._check_memory(px, envelope - 1)
    assert "measured process envelope" in capsys.readouterr().err
    for limit, on_card in ((envelope, True), (envelope - 1, False)):
        assert cli._check_memory(px, limit, on_card)
        assert capsys.readouterr().err == ""
    assert not cli._check_memory(px, 99)
    assert "Memory limit would be exceeded" in capsys.readouterr().err


def test_native_library_loads_once_under_threads(monkeypatch):
    """get_lib from many threads at once, with a short switch interval:
    every caller gets the one handle (none sees the build in progress as
    a missing library)."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from guetzli_tpu_torch import native
    lib = native.get_lib()
    assert lib is not None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    start = threading.Barrier(16)

    def load(_):
        start.wait(timeout=60)
        return native.get_lib()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(load, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert all(g is not None and g._name == lib._name for g in got)
    assert len({id(g) for g in got}) == 1
