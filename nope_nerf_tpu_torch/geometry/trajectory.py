"""Novel-view trajectory generation (host-side numpy + scipy).

The port's copy of ``nope_nerf_tpu/geometry/trajectory.py`` (the same
functions, the same arithmetic), kept here so that the port imports nothing
of the JAX package: slerp interpolation, B-spline paths and LLFF spiral
paths, returning (N, 4, 4) or (N, 3, 4) c2w arrays for the render CLI
(``nope_nerf_tpu_torch.render``).
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate as si
from scipy.spatial.transform import Rotation as R
from scipy.spatial.transform import Slerp


def _convert3x4_4x4(m):
    out = np.tile(np.eye(4, dtype=np.float32), (m.shape[0], 1, 1))
    out[:, :3, :4] = m[:, :3, :4]
    return out


def interp_poses(c2ws, n_views):
    """Slerp rotations + linear translations (`model/common.py:511-522`)."""
    c2ws = np.asarray(c2ws)
    n_in = c2ws.shape[0]
    rots = R.from_matrix(c2ws[:, :3, :3])
    slerp = Slerp(np.linspace(0, 1, n_in), rots)
    t_out = np.linspace(0, 1, n_views)
    interp_rots = slerp(t_out).as_matrix().astype(np.float32)
    # torch F.interpolate(mode='linear', align_corners=False) on the
    # translation channel — half-sample offsets:
    trans = c2ws[:, :3, 3]
    src = (np.arange(n_views) + 0.5) * (n_in / n_views) - 0.5
    src = np.clip(src, 0, n_in - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (src - lo)[:, None]
    interp_trans = trans[lo] * (1 - w) + trans[hi] * w
    out = np.concatenate([interp_rots, interp_trans[:, :, None]], axis=2)
    return _convert3x4_4x4(out)


def scipy_bspline(cv, n=100, degree=3, periodic=False):
    """Sample ``n`` points on a degree-``degree`` B-spline whose control
    polygon is ``cv`` ((K, dim) array).

    Clamped (open-uniform) by default, so the curve starts and ends exactly
    at the first/last control vertex; ``periodic=True`` instead closes the
    curve by wrapping the control polygon around one full period. Output
    semantics match the reference's path generator (`model/common.py:563-589`)
    — same knot families evaluated over the same parameter span — but the
    construction here is re-derived from the standard clamped / periodic
    knot-vector definitions.
    """
    cv = np.asarray(cv)
    count = len(cv)
    if periodic:
        degree = max(int(degree), 1)
        # wrap the control polygon: extended vertex i is cv[(i+1) % count],
        # long enough (count+degree+1) to support one period of the curve
        cv = cv[(np.arange(count + degree + 1) + 1) % count]
        knots = np.arange(-degree, count + degree + 1, dtype=float)
        t_max = float(count)
    else:
        degree = int(np.clip(degree, 1, count - 1))
        # clamped knots: degree+1 repeats at each end, uniform interior
        knots = np.concatenate([
            np.zeros(degree),
            np.arange(count - degree + 1, dtype=float),
            np.full(degree, count - degree, dtype=float),
        ])
        t_max = float(count - degree)
    return si.BSpline(knots, cv, degree)(np.linspace(0.0, t_max, n))


def interp_poses_bspline(c2ws, n_novel, input_times, degree):
    """B-spline translations + slerp rotations (`model/common.py:523-531`)."""
    c2ws = np.asarray(c2ws)
    t_new = scipy_bspline(c2ws[:, :3, 3], n=n_novel, degree=degree,
                          periodic=False).astype(np.float32)
    rots = R.from_matrix(c2ws[:, :3, :3])
    slerp = Slerp(input_times, rots)
    tt = np.linspace(input_times[0], input_times[-1], n_novel)
    r_new = slerp(tt).as_matrix().astype(np.float32)
    out = np.concatenate([r_new, t_new[:, :, None]], axis=2)
    return _convert3x4_4x4(out)


def get_poses_at_times(c2ws, input_times, target_times):
    """Slerp rotations + piecewise-linear translations at arbitrary times
    (`model/common.py:533-558`).

    Documented divergence (executed-evidence:
    tests/test_trajectory_reference_exec.py): the reference's ``interp_t``
    applies the lerp weights to the wrong endpoints and 0/0-NaNs when a
    target time equals an input knot — dead code there (no reference CLI
    calls it); this is the standard correct lerp instead."""
    c2ws = np.asarray(c2ws)
    rots = R.from_matrix(c2ws[:, :3, :3])
    slerp = Slerp(input_times, rots)
    target_rots = slerp(target_times).as_matrix().astype(np.float32)
    # np.interp per-axis == the reference's two-neighbour linear blend
    target_trans = np.stack(
        [np.interp(target_times, input_times, c2ws[:, i, 3]) for i in range(3)],
        axis=1,
    ).astype(np.float32)
    out = np.concatenate([target_rots, target_trans[:, :, None]], axis=2)
    return _convert3x4_4x4(out)


def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    """`model/common.py:374-380`."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    """`model/common.py:393-402`. poses: (N, 3, 5) with hwf column."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """`model/common.py:381-392`."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array(
                [0.2 * np.cos(theta), -0.2 * np.sin(theta),
                 -np.sin(theta * zrate) * 0.1, 1.0]
            )
            * rads,
        )
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def generate_spiral_nerf(learned_poses, bds, n_novel_views, hwf):
    """LLFF spiral path around the average pose (`model/common.py:591-615`)."""
    learned_poses = np.asarray(learned_poses)
    poses_ = np.concatenate(
        [learned_poses[:, :3, :4], hwf[: len(learned_poses)]], axis=-1
    )
    c2w = poses_avg(poses_)
    up = _normalize(poses_[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    zdelta = close_depth * 0.2
    tt = poses_[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    c2ws = render_path_spiral(c2w, up, rads, focal, zdelta, zrate=0.5, rots=2,
                              N=n_novel_views)
    return np.stack(c2ws).astype(np.float32)[:, :3, :4]


def create_spheric_poses(radius, mean_h, n_poses=120):
    """Circular poses around z (`model/common.py:333-369`)."""
    def spheric_pose(theta, phi, radius):
        trans_t = lambda t: np.array(
            [[1, 0, 0, 0], [0, 1, 0, 2 * mean_h], [0, 0, 1, -t]]
        )
        rot_phi = lambda p: np.array(
            [[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]]
        )
        rot_theta = lambda th: np.array(
            [[np.cos(th), 0, -np.sin(th)], [0, 1, 0], [np.sin(th), 0, np.cos(th)]]
        )
        c2w = rot_theta(theta) @ rot_phi(phi) @ trans_t(radius)
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]]) @ c2w

    return np.stack(
        [
            spheric_pose(th, -np.pi / 12, radius)
            for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
        ],
        0,
    )
