"""nope_nerf_tpu_torch — the PyTorch + CUDA port of nope_nerf_tpu for one
NVIDIA H100.

The JAX package ``nope_nerf_tpu`` is the reference this package is held
against. This package never imports jax: plain tensor code is PyTorch, and
each Pallas kernel on the ported path is a hand-written CUDA kernel for
``sm_90a`` (sources in ``csrc/``, built at first use by ``_build``).
"""
__version__ = "0.1.0"
