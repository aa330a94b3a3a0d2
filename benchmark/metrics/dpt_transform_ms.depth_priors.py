"""dpt_transform_ms.depth_priors: Device ms a frame of the section
``dpt.transform`` of ``dpt_depth.depth_batch``: the float64 bicubic input
transform (models/dpt.py::dpt_input_transform_batched) and the batch's
permute to NCHW."""
from benchmark.readers_dpt import section_ms


def read(t):
    return section_ms(t, "dpt.transform")
