"""guetzli_tpu_torch: the Guetzli perceptual JPEG encoder in PyTorch, with
its per-block kernels hand-written in CUDA for Hopper (csrc/).

The layout mirrors the JAX package ``guetzli_tpu`` module by module; the
JAX package is the reference the tests hold this one against. Entry
points: ``python -m guetzli_tpu_torch`` (the same as
``python -m guetzli_tpu_torch.cli``; ``--checkcuda`` verifies the kernels
on the input first, checkcl.py), ``python -m
guetzli_tpu_torch.butteraugli_cli``, ``python -m
guetzli_tpu_torch.corpus_cli`` (a corpus through the lockstep encoder,
parallel/lockstep.py), ``guetzli_tpu_torch.api.encode_bytes`` and
``encode_corpus``. They run on the CUDA device unless the caller asks for
the CPU (see device.py); runtime/ says which device errors are recovered.
"""
