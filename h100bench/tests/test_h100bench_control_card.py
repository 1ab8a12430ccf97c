"""The lower-precision control on the card, at a size a test run holds:
the 4:4:4 photo cell for two seeds with an 8 s window (the cell's five
judged outputs), through h100bench/control.py --control. The check
(check.judge) finds the program correct and the control, the reference
with TF32 contractions in the program's place on the same outputs, not
correct, on every seed. Skips without a CUDA device (on the
card: python -m pytest --noconftest h100bench/tests -m gpu)."""

import json
import subprocess
import sys

import pytest

from h100bench.tests import minibench

CELL = "png444_q95.photo_serial"


def _readings():
    out = subprocess.run(
        [sys.executable, "h100bench/control.py", "--workload", CELL,
         "--seeds", "31,32", "--seconds", "8", "--control"],
        capture_output=True, text=True, timeout=900,
        cwd=str(minibench.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.strip().splitlines()[:-1]]


@pytest.mark.gpu
def test_control_fails_where_the_program_passes():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs on the card")
    readings = _readings()
    assert len(readings) == 2
    for r in readings:
        assert r["correct"], r
        assert r["control_correct"] is False, r
