"""Scene loading of the port (numpy + PIL): the LLFF / COLMAP layout on disk
into host arrays, as ``nope_nerf_tpu/dataloading`` reads it."""
from .llff import load_llff_data, recenter_poses, spherify_poses  # noqa: F401
from .scene import SceneData, get_scene  # noqa: F401
