"""dpt_resnet_roofline.depth_priors: The section ``dpt.resnet``'s least time a
frame (the larger of its FLOPs at the f32 peak and its own bytes at HBM's
rate, benchmark/counts_dpt.py) over its device time a frame."""
from benchmark.readers_dpt import roofline


def read(t):
    return roofline(t, "dpt.resnet")
