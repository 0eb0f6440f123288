"""PyTorch/CUDA port of the filtered vector search system.

A package of its own beside the JAX reference package ``repro``: it imports
``torch`` and never ``jax`` nor anything of ``repro``. Module names mirror
``repro``'s (``core.engine``, ``core.search``, ``core.graph``, ...), so each
counterpart is found at the same path. The TPU kernels of the main path are
hand-written CUDA C++ for Hopper under ``kernels/csrc/``, each beside a plain
PyTorch version in ``kernels/ref.py``; ``kernels/ops.py`` dispatches on the
tensors' device.
"""
