"""PyTorch / CUDA port of the ``repro`` package (ROBE DLRM on an H100).

The package mirrors ``repro``'s subpackages and module names.  It imports
``torch`` and ``numpy`` only: never ``jax`` and nothing of ``repro``.  Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
its kernels, forward and backward, are hand-written CUDA for Hopper
(``kernels/csrc``), built at first launch.
"""
