"""Video writing of the port (``nope_nerf_tpu/utils/video.py``'s
``write_video``), numpy + PIL only.

``.mp4`` / ``.m4v`` / ``.mov`` go through the port's Motion-JPEG muxer
(:func:`.mp4.write_mjpeg_mp4`), with imageio's 0-10 quality mapped to JPEG
quality as the JAX package maps it. Any other suffix writes the frames as
PNGs into ``<path without suffix>_frames/``: without imageio there is no gif
writer, and the port does not depend on imageio.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .mp4 import write_mjpeg_mp4


def write_video(path, frames, fps=30, quality=9):
    """frames: (N, H, W, 3) uint8. Returns the path actually written: the
    video, or the directory of PNG frames."""
    frames = np.asarray(frames)
    if os.path.splitext(path)[1].lower() in (".mp4", ".m4v", ".mov"):
        return write_mjpeg_mp4(path, frames, fps=fps,
                               quality=int(np.clip(quality * 9.5, 50, 95)))
    frame_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(frame_dir, f"{i:04d}.png"))
    return frame_dir
