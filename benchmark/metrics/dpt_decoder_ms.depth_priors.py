"""dpt_decoder_ms.depth_priors: Device ms a frame of the section
``dpt.decoder``: the four scratch convolutions, the RefineNet fusion
blocks, the head and the depth tail."""
from benchmark.readers_dpt import section_ms


def read(t):
    return section_ms(t, "dpt.decoder")
