"""dpt_host_ms.depth_priors: Host ms a frame of the span ``dpt.batch``
around one ``dpt_depth.depth_batch`` call, which never waits for the
device: the median over the window's batches."""
from benchmark.readers_dpt import host_ms


def read(t):
    return host_ms(t)
