"""dpt_vit_ms.depth_priors: Device ms a frame of the section ``dpt.vit``:
the patch embedding, the 12 ViT-B/16 blocks, the two readouts and the
reassemble convolutions."""
from benchmark.readers_dpt import section_ms


def read(t):
    return section_ms(t, "dpt.vit")
