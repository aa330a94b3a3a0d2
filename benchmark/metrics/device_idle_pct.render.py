"""device_idle_pct.render: The share of the untraced window's wall time per
image in which the device ran nothing: 1 - the profiled slice's busy time
per image over the window's wall time per image."""
from benchmark.readers import device_idle_pct


def read(t):
    return device_idle_pct(t, "render")
