"""device_idle_pct.train: The share of the untraced window's wall time per
step in which the device ran nothing: 1 - the profiled slice's busy time
per step over the window's wall time per step."""
from benchmark.readers import device_idle_pct


def read(t):
    return device_idle_pct(t, "train")
