"""da2_attn_ms.depth_priors_518: Device ms a frame of the section
``dpt.dinov2.attn``: each of the 24 blocks' attention cores on 2,443
tokens (q's scaling, q k^T, softmax, times v), from q's scaling to the
output projection."""
from benchmark.readers_da2 import section_ms


def read(t):
    return section_ms(t, "attn")
