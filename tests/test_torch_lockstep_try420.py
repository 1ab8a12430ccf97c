"""The port's lockstep corpus encoder against its serial encoder under
try_420, byte for byte, on the CPU (one torch thread): the 4:4:4 and the
4:2:0 pass groups run across the corpus and MaybeOutput keeps the better
result of each image, as the serial path does (tests/test_lockstep.py's
try_420 case; the other 4:2:0 cases are in test_torch_lockstep420.py).
"""

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                process_rgb)


def _serial_rgb(data, **kw):
    rgb, w, h = read_png(data)
    params = Params(**kw)
    params.butteraugli_target = consts.butteraugli_score_for_quality(95)
    return process_rgb(params, rgb, w, h, ProcessStats(), "cpu")


def test_try_420():
    names = ("bees96x64.png", "synth128x96.png")
    inputs = [(n, (FIXTURES / n).read_bytes()) for n in names]
    lock = dict(lockstep.encode_corpus_lockstep(inputs, 95, try_420=True,
                                                device="cpu"))
    for name, data in inputs:
        assert lock[name] == _serial_rgb(data, try_420=True), name
