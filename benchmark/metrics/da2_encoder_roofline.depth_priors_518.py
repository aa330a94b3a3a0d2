"""da2_encoder_roofline.depth_priors_518: The DINOv2 encoder's least
time a frame (its sections ``dpt.dinov2`` and ``dpt.dinov2.attn``: the
larger of their FLOPs at the f32 peak and their own bytes at HBM's rate,
benchmark/counts_da2.py) over their device time a frame."""
from benchmark.readers_da2 import roofline


def read(t):
    return roofline(t, "encoder")
