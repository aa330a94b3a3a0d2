"""render_mfu: The whole step's model FLOPs per second as a share of the bf16
peak."""
from benchmark.readers import mfu


def read(t):
    return mfu(t, "render")
