"""chamfer_roofline.train: Kernel B
(ops/kernels/chamfer_band.py::nearest_idx_banded) on the cell's two clouds:
least time over device time."""
from benchmark.readers import roofline


def read(t):
    return roofline(t, "train", "chamfer")
