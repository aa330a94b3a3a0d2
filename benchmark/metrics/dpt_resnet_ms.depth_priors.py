"""dpt_resnet_ms.depth_priors: Device ms a frame of the section
``dpt.resnet``: the ResNetV2-50 stem and its three stages
(models/dpt.py::_apply_resnet)."""
from benchmark.readers_dpt import section_ms


def read(t):
    return section_ms(t, "dpt.resnet")
