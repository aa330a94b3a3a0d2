"""device_idle_pct.depth_priors_518: The share of the untraced window's
wall time per frame in which the device ran nothing: 1 - the profiled
slice's busy time per frame over the window's wall time per frame."""
from benchmark.readers_da2 import device_idle_pct


def read(t):
    return device_idle_pct(t)
