"""The one knob of guetzli_tpu/config.py that the port reads.

``pallas()`` reads GUETZLI_TPU_PALLAS at call time, as the JAX package's
``config.current().pallas`` does, so a change of the environment (or a
monkeypatched test) takes effect at the next encode. Only the value 1
changes behaviour: 4:4:4 zeroing passes run in mode "444p", the staged
greedy loop with kernel C per step. Any other value, or none, keeps the
default, the fused greedy kernel B (the counterpart of the JAX package's
accelerator default).
"""

import os


def pallas():
    """GUETZLI_TPU_PALLAS as an int, None when unset or empty."""
    v = os.environ.get("GUETZLI_TPU_PALLAS")
    return None if v in (None, "") else int(v)
