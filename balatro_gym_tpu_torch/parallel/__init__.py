"""Data parallelism over ``torch.distributed`` (``mesh.py``) and its
scaling benchmark (``scaling_bench.py``)."""
