"""The benchmark of the PyTorch/CUDA port, ``wfa_tpu_torch``: see
``harness.py`` and ``BENCHMARK.json`` at the repository's root."""
