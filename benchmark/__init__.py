"""The benchmark of the PyTorch + CUDA port (``nope_nerf_tpu_torch``) on one
NVIDIA H100; ``python3 benchmark/run.py --help``."""
