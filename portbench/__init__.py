"""The benchmark of the PyTorch and CUDA port (``ibu_tpu_torch``): the
harness, its configurations, traffic, jobs, metrics and plain reference.
Run a cell with ``python3 portbench/run.py``."""
