"""Camera-trajectory export of the port: camera frustums as an ASCII PLY
line set (viewable in MeshLab / CloudCompare / open3d).

The port's copy of ``nope_nerf_tpu/utils/vis.py::export_camera_frustums``
(byte-identical output), kept here so that the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import numpy as np


def frustum_vertices(c2w, fov_deg=50.0, size=0.1):
    """5 vertices of a camera frustum (apex + 4 image-plane corners) in world
    coordinates; the camera looks down -z."""
    half = np.tan(np.deg2rad(fov_deg) / 2.0) * size
    local = np.array(
        [
            [0, 0, 0],
            [-half, -half, -size],
            [half, -half, -size],
            [half, half, -size],
            [-half, half, -size],
        ]
    )
    R, t = c2w[:3, :3], c2w[:3, 3]
    return local @ R.T + t


FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def export_camera_frustums(path, trajectories, colors=None, fov_deg=50.0,
                           frustum_size=0.1, connect_centers=True):
    """Write frustums for one or more (N, 4, 4) trajectories to an ASCII PLY
    with colored edges. ``colors``: list of (r, g, b) 0-255 per trajectory."""
    if colors is None:
        colors = [(255, 0, 0)] * len(trajectories)
    verts, edges, vcolors = [], [], []
    for traj, color in zip(trajectories, colors):
        centers = []
        for c2w in np.asarray(traj):
            base = len(verts)
            verts.extend(frustum_vertices(c2w, fov_deg, frustum_size).tolist())
            vcolors.extend([color] * 5)
            edges.extend([(base + a, base + b) for a, b in FRUSTUM_EDGES])
            centers.append(base)
        if connect_centers:
            edges.extend(
                [(centers[i], centers[i + 1]) for i in range(len(centers) - 1)])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for v, c in zip(verts, vcolors):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")
    return path
