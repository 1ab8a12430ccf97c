"""Float32 arithmetic that rounds the same on every device."""

import torch

from guetzli_tpu_torch.ops import devconst


def div(a, b):
    """a / b as one correctly rounded division, on the CPU and the card.

    PyTorch computes ``number / tensor`` as ``reciprocal(tensor) * number``
    and, on the card, ``tensor / number`` as ``tensor * (1 / number)``: two
    roundings, which the opsin gamma's recursion amplifies to ~4e-5
    relative. Given as a 0-dim tensor, the number takes part in a true
    division instead, as in the JAX package and the CUDA kernels (made
    once per value and device: ops/devconst.py)."""
    if not isinstance(a, torch.Tensor):
        a = devconst.scalar(a, b.dtype, b.device)
    if not isinstance(b, torch.Tensor):
        b = devconst.scalar(b, a.dtype, a.device)
    return torch.div(a, b)


def sqrt(x):
    """Correctly rounded float32 square root on every device. PyTorch's
    CPU sqrt is not correctly rounded; the square root of the float64
    value, rounded to float32, is (53 >= 2 * 24 + 2 bits), and equals the
    card's IEEE sqrtf."""
    return torch.sqrt(x.double()).to(x.dtype)
