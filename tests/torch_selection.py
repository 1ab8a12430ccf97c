"""General 0/1 selection matrices for kernel C's tests.

Kernel C (guetzli_tpu_torch/kernels/tile_compare.py) replicates the
image edge by contracting each block with two 0/1 matrices. The encoder
only ever gives it one-hot rows (a clamped gather); the JAX kernel and
the port contract arbitrary int32 matrices, so the tests also hold them
to rows that a clamp never gives.
"""

import numpy as np

KINDS = ("zero_rows", "two_ones", "permuted")


def selection_matrices(n, kind, seed):
    """(sy, sx), each [n, 8, 8] int32, from a numpy seed: "zero_rows",
    one-hot rows of which about a quarter are all zero; "two_ones", rows
    with two ones in distinct columns; "permuted", permutation matrices;
    "mixed", block i of kind KINDS[i % 3]."""
    rng = np.random.default_rng(seed)
    eye = np.eye(8, dtype=np.int32)
    if kind == "mixed":
        parts = [selection_matrices(n, k, seed + 1 + i)
                 for i, k in enumerate(KINDS)]
        pick = np.arange(n) % len(KINDS)
        return tuple(np.stack([parts[pick[b]][m][b] for b in range(n)])
                     for m in range(2))
    out = []
    for _ in range(2):
        if kind == "permuted":
            m = np.stack([eye[rng.permutation(8)] for _ in range(n)])
        else:
            first = rng.integers(0, 8, (n, 8))
            m = eye[first]
            if kind == "zero_rows":
                m[rng.random((n, 8)) < 0.25] = 0
            elif kind == "two_ones":
                m = m + eye[(first + rng.integers(1, 8, (n, 8))) % 8]
            else:
                raise ValueError("unknown kind %r" % (kind,))
        out.append(np.ascontiguousarray(m, dtype=np.int32))
    return tuple(out)
