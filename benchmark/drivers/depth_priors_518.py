"""Depth Anything V2 depth-prior traffic: ``dpt_depth.depth_batch`` with
``depth.type: DepthAnythingV2`` (the 'lower_bound' input transform to
518x924 on the device in float64, Depth Anything V2-Large in float32 with
TF32 off, the depth tail) on the configuration's seeded frames, already on
the card.

The traffic, the window, the sample the comparison follows and the probes
are ``drivers/depth_priors.py``'s, read from its own copy of that file with
three names swapped: the weights (``benchmark/weights_da2.py``), the counts
(``benchmark/counts_da2.py``) and the plain reference
(``benchmark/reference/depth_anything_v2.py``). So batch j holds frames
4j..4j+3 modulo the sequence, each frame counts its batch's latency, each
batch's depths are on the host before the next is issued, and the
comparison holds the window's depths and pre-ReLU outputs of a seeded
sample of its batches to the reference, computed one frame at a time.
After the base set-up the head's last bias is centred on the reference's
pre-ReLU output of the first frame (``weights_da2.centre_head``), so that
the ReLU passes part of every seed's pixels.

Mix keys: those of ``depth_priors``, with ``driver`` "depth_priors_518".
"""
from __future__ import annotations

import os

from benchmark import counts_da2, harness
from benchmark.reference import depth_anything_v2 as ref
from benchmark.weights_da2 import centre_head, da2_weights

NETWORK = "DepthAnythingV2"

_base = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "depth_priors.py"), "bench_driver_depth_priors_518_base")
_base.counts_dpt = counts_da2
_base.dpt_weights = da2_weights
_base.ref = ref
_base.SECTIONS = ("dpt.transform",) + counts_da2.SECTIONS

call, keep, frames_of, worst_frame = (_base.call, _base.keep,
                                      _base.frames_of, _base.worst_frame)
window, compare = _base.window, _base.compare


def setup(ctx):
    if ctx.cfg["depth"]["type"] != NETWORK:
        raise ValueError(f"the configuration's depth.type is not {NETWORK}")
    s = _base.setup(ctx)
    _, pre = ref.forward(s.params, frames_of(s, 0)[:1], s.depth_cfg)
    centre_head(s.params, pre)
    return s


def probe(s, ctx):
    """The base driver's probe, marked as this network's readings."""
    return dict(_base.probe(s, ctx), network=NETWORK)
