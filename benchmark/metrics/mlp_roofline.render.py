"""mlp_roofline.render: Kernel A's function
(ops/kernels/mlp_kernel.py::fused_mlp_composite) on the cell's shapes: least
time over device time."""
from benchmark.readers import roofline


def read(t):
    return roofline(t, "render", "mlp")
