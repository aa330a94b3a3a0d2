"""dpt_mfu: DPT-Hybrid's FLOPs (462.6 G a 384x672 frame) per second of the
profiled slice as a share of the f32 peak, 67 TFLOP/s."""
from benchmark.readers_dpt import mfu


def read(t):
    return mfu(t)
