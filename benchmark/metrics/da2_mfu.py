"""da2_mfu: Depth Anything V2-Large's FLOPs (2,583.1 G a 518x924 frame)
per second of the profiled slice as a share of the f32 peak, 67 TFLOP/s."""
from benchmark.readers_da2 import mfu


def read(t):
    return mfu(t)
