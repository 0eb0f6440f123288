"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``control.py`` runs the
comparison's control. Nothing here imports JAX or the JAX package.
"""
