"""Device selection for the port.

The encoder runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or the CLI's ``--cpu``). Without a card and without
that request, ``resolve`` raises: there is no silent fallback, so a
timing or a result always names the device it came from.

Float32 precision: the JAX reference runs every contraction at
``Precision.HIGHEST`` (full float32). On the card PyTorch's float32
matmuls are full precision by default, but float32 convolutions go through
cuDNN in TF32 (about 3 decimal digits) unless ``cudnn.allow_tf32`` is
False, which would move the blurs of the whole-image diffmap far past the
stage tolerances. ``resolve`` pins both switches off.

Host threads: on the card the encoder's host work is numpy, the native
library and small tensor copies (host planes into pinned memory). With
PyTorch's default intra-op pool of one OpenMP thread per core, each copy
wakes the pool and its threads spin between copies: on an 8-core H100
host a 4:2:0 photo encode burned ~3 CPU-seconds per wall second, taking
cores from the encoder's own thread, and ran 10-18% slower than on one
thread. ``resolve`` sets one intra-op thread for a CUDA device (process
wide, like the switches above); the CPU device keeps the pool.
"""

import torch


def resolve(device=None) -> torch.device:
    """The torch.device to run on: "cuda" by default, "cpu" only when
    asked. Raises RuntimeError when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "guetzli_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' (CLI: --cpu) to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % (device,))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's autotuner may pick another convolution algorithm per call,
    # and with it other bits: the corpus's threads must see the serial
    # encoder's choices.
    torch.backends.cudnn.benchmark = False
    if dev.type == "cuda":
        torch.set_num_threads(1)
    return dev
