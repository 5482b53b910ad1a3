"""PyTorch/CUDA port of the ``repro`` model path.

The layout mirrors ``src/repro/``: ``configs``, ``kernels`` (hand-written
Hopper kernels under ``csrc/`` with a plain PyTorch version beside each),
``models``, ``serving``, ``obs`` and ``launch``. The package imports
``torch``, ``numpy`` and the standard library only; it never imports
``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise if CUDA was asked for and is absent.
"""
