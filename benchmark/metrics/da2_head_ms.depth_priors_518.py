"""da2_head_ms.depth_priors_518: Device ms a frame of the section
``dpt.decoder`` of Depth Anything V2: the reassembly (projections,
transposed and strided convolutions), the four fusion blocks, the head at
518x924 and the depth tail."""
from benchmark.readers_da2 import section_ms


def read(t):
    return section_ms(t, "head")
