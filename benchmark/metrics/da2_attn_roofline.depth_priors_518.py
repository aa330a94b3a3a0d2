"""da2_attn_roofline.depth_priors_518: The section ``dpt.dinov2.attn``'s
least time a frame (the larger of its FLOPs at the f32 peak and its floor
of bytes, q, k and v in and the output out, at HBM's rate,
benchmark/counts_da2.py) over its device time a frame."""
from benchmark.readers_da2 import roofline


def read(t):
    return roofline(t, "attn")
