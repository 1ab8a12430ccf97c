"""The check that decides `correct`, driven through a whole run on the
CPU at a tiny size (the card's look is skipped: the program runs with
device="cpu"), sound and with the timed path broken underneath in each
way a cell can break: an answer altered where it is produced, a step
that hands back its input unchanged, half of a batch left out, a
search that keeps outputs over the quality's target. (The
exchange between chips does not exist in a one-card cell.)"""

import struct
import sys
import time

import pytest

from h100bench.tests import minibench

sys.path.insert(0, str(minibench.ROOT))

from h100bench.lib import cell  # noqa: E402


def _run(tmp_path, workload, seed=20261017):
    bench, root, bench_dir = minibench.make(tmp_path)
    res, _rec = cell.run_cell(bench, workload, seed, 0.01, False,
                              time.perf_counter(), device="cpu", root=root,
                              bench_dir=bench_dir, warm=False)
    return res


def _alter_dqt(jpeg):
    """The first quantization table's first (DC) step raised by 1: the
    output decodes, to other pixels than the search scored."""
    pos = 2
    while jpeg[pos + 1] != 0xDB:
        (n,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        pos += 2 + n
    out = bytearray(jpeg)
    out[pos + 5] = min(255, out[pos + 5] + 1)
    return bytes(out)


def test_sound_run_is_correct(tmp_path):
    res = _run(tmp_path, "serial444")
    assert res["correct"], res["checks"]
    assert res["checks"]["dist_gap"]["value"] <= 1e-3
    assert res["checks"]["dist_over_target"]["value"] <= 2e-3


def test_output_over_target_is_caught(tmp_path, monkeypatch):
    """The search aims 1% over the target (h100bench/control.py's
    planted fault) and reports its distances honestly: the gap stays
    small, the distance over the target does not."""
    from guetzli_tpu_torch import consts
    from h100bench import control
    monkeypatch.setattr(consts, "butteraugli_score_for_quality",
                        consts.butteraugli_score_for_quality)
    control.plant("over_target")
    res = _run(tmp_path, "serial444")
    assert not res["correct"]
    assert res["checks"]["dist_gap"]["value"] <= 1e-3
    assert res["checks"]["dist_over_target"]["value"] > 2e-3


def test_altered_answer_is_caught(tmp_path, monkeypatch):
    from guetzli_tpu_torch import api
    real = api.encode_bytes
    monkeypatch.setattr(api, "encode_bytes",
                        lambda *a, **k: _alter_dqt(real(*a, **k)))
    res = _run(tmp_path, "serial444")
    assert not res["correct"]
    assert res["checks"]["dist_gap"]["value"] > 1e-3


def test_input_handed_back_is_caught(tmp_path, monkeypatch):
    from guetzli_tpu_torch import api
    monkeypatch.setattr(api, "encode_bytes", lambda data, *a, **k: data)
    res = _run(tmp_path, "serial420")
    assert not res["correct"]


def test_half_batch_left_out_is_caught(tmp_path, monkeypatch):
    from guetzli_tpu_torch.parallel import lockstep
    real = lockstep.encode_corpus_lockstep

    def half(inputs, *a, **k):
        inputs = list(inputs)
        kept = real(inputs[:len(inputs) // 2], *a, **k)
        return kept + [(n, None) for n, _d in inputs[len(inputs) // 2:]]
    monkeypatch.setattr(lockstep, "encode_corpus_lockstep", half)
    res = _run(tmp_path, "lock444")
    assert not res["correct"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("seed", [1, 2**31 + 5, -7])
def test_large_and_negative_seeds_make_inputs(seed):
    from h100bench.lib import traffic
    t = {"deck": minibench.TINY, "group": 2, "jitter": 8, "flip": 0.5}
    items = traffic.generate(t, {"input": {"kind": "png"}}, seed)
    assert [it["data"] for it in items] == [
        it["data"] for it in traffic.generate(
            t, {"input": {"kind": "png"}}, seed)]
