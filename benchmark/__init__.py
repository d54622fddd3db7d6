"""The benchmark of the PyTorch/CUDA port (``balatro_gym_tpu_torch``):
``run.py`` runs one cell of ``BENCHMARK.json``."""
