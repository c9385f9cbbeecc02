"""Task Bench in PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` (``core/``, ``core/runtimes/``, ``kernels/``),
one port file per reference file. The port imports ``torch`` and numpy and
never ``jax`` or any module of ``repro``. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
