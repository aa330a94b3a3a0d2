"""da2_head_roofline.depth_priors_518: The section ``dpt.decoder``'s least
time a frame (the larger of its FLOPs at the f32 peak and its own bytes at
HBM's rate, benchmark/counts_da2.py) over its device time a frame."""
from benchmark.readers_da2 import roofline


def read(t):
    return roofline(t, "head")
