"""da2_encoder_ms.depth_priors_518: Device ms a frame of the DINOv2
ViT-L/14 encoder: the sections ``dpt.dinov2`` (patch and position
embeddings, each block's norms, projections, MLP and LayerScale, the
normed taps) and ``dpt.dinov2.attn`` (the 24 blocks' attention cores)."""
from benchmark.readers_da2 import section_ms


def read(t):
    return section_ms(t, "encoder")
