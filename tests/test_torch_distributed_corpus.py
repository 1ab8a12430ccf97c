"""The corpus across processes (corpus_cli --distributed; port of the
JAX package's tools/corpus_encode.py --distributed and its
tests/test_distributed.py), and api.encode_corpus with a thread pool
(JAX tests/test_parallel.py::test_encode_corpus_threads_match_sequential).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from guetzli_tpu_torch import api
from guetzli_tpu_torch import comparator as cmp_mod
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
CORPUS = [FIX / "bees96x64.png", REPO / "tests" / "corpus" / "bees_d-420.jpg",
          REPO / "tests" / "corpus" / "grad2.png",
          REPO / "tests" / "corpus" / "stripes0.png"]


@pytest.mark.slow
def test_two_processes_cover_the_corpus(tmp_path):
    """Two corpus_cli --cpu --distributed processes: disjoint, complete
    coverage (file i goes to rank i % 2), each output the one-process
    run's bytes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = "file://%s" % (tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "guetzli_tpu_torch.corpus_cli", "--cpu",
         "--distributed", "--coordinator", store, "--num-hosts", "2",
         "--host-index", str(r), "--out", str(tmp_path / ("r%d" % r))]
        + [str(p) for p in CORPUS], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [json.loads(o.strip().splitlines()[-1]) for o, _e in outs]
    assert [ln["host"] for ln in lines] == [0, 1]
    assert [ln["images"] for ln in lines] == [2, 2]
    got = {r: sorted(q.name for q in (tmp_path / ("r%d" % r)).iterdir())
           for r in range(2)}
    want = {r: sorted(p.stem + ".jpg" for i, p in enumerate(CORPUS)
                      if i % 2 == r) for r in range(2)}
    assert got == want
    assert not set(got[0]) & set(got[1])
    one = tmp_path / "one"
    r = subprocess.run(
        [sys.executable, "-m", "guetzli_tpu_torch.corpus_cli", "--cpu",
         "--out", str(one)] + [str(p) for p in CORPUS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    for rank, names in got.items():
        for name in names:
            assert ((tmp_path / ("r%d" % rank) / name).read_bytes()
                    == (one / name).read_bytes()), name


def test_encode_corpus_threads_match_sequential(monkeypatch):
    """threads=3 gives the bytes of threads=1, and every compare is
    issued from the calling thread: the pool only decodes."""
    data = (FIX / "bees96x64.png").read_bytes()
    items = [("img%d" % i, data) for i in range(3)]
    seq = api.encode_corpus(items, quality=95, threads=1, device="cpu")
    threads = set()
    dispatch = cmp_mod.Comparator.dispatch_compare

    def spy(self, img):
        threads.add(threading.current_thread())
        return dispatch(self, img)
    monkeypatch.setattr(cmp_mod.Comparator, "dispatch_compare", spy)
    par = api.encode_corpus(items, quality=95, threads=3, device="cpu")
    for (n1, b1, _t1), (n2, b2, _t2) in zip(seq, par):
        assert n1 == n2 and b1 is not None and b1 == b2
    assert threads == {threading.current_thread()}


def test_encode_corpus_threads_record_a_bad_png(capsys):
    """A PNG the pool cannot decode is recorded as None, and the corpus
    goes on."""
    data = (FIX / "bees96x64.png").read_bytes()
    items = [("bad.png", data[:40]), ("ok.png", data)]
    res = api.encode_corpus(items, quality=95, threads=2, device="cpu")
    assert res[0][0] == "bad.png" and res[0][1] is None
    assert res[1][1] == api.encode_bytes(data, 95, device="cpu")
    assert "bad.png" in capsys.readouterr().err


def test_memory_guard_warns_on_the_card_for_every_image(capsys):
    """On the card the port's process passes the default 6,000 MB limit
    for the smallest image (bees96x64 peaks at 6,187-6,203 MB on an H100,
    memory_envelope): the warning stands and says why; on the CPU the
    reference's contract alone decides and nothing is printed."""
    from guetzli_tpu_torch import cli
    assert cli.K_MEASURED_BASE_MB > cli.K_DEFAULT_MEMLIMIT_MB
    for pixels in (96 * 64, 1):
        assert cli._check_memory(pixels, cli.K_DEFAULT_MEMLIMIT_MB)
        err = capsys.readouterr().err
        assert "every image passes 6000 MB" in err
        assert "CUDA runtime" in err
        assert cli._check_memory(pixels, cli.K_DEFAULT_MEMLIMIT_MB,
                                 on_card=False)
        assert capsys.readouterr().err == ""
