"""LLFF / COLMAP dataset IO (host-side numpy + PIL).

The port's copy of ``nope_nerf_tpu/dataloading/llff.py`` (same functions,
same outputs), kept here so that the port imports nothing of the JAX
package:

* ``poses_bounds.npy`` parsing and hwf bookkeeping,
* the image minification cache ``images_{factor}/`` (PIL resize),
* pose recentering / spherification,
* gt / DPT-npz depth loading incl. cross-frame normalisation.

The JAX package reads the 16-bit gt depth PNGs with cv2; here PIL reads
them (the same uint16 values). Neither loader resizes depths on the scene
path, so the cv2 resize options are not carried over.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _list_images(d):
    return [f for f in sorted(os.listdir(d)) if f.endswith(_EXTS)]


def _minify(basedir, factor, img_folder="images"):
    """Create the ``{img_folder}_{factor}/`` downsampled cache if missing
    (PIL LANCZOS resize, png output)."""
    imgdir = os.path.join(basedir, f"{img_folder}_{factor}")
    if os.path.exists(imgdir):
        return
    srcdir = os.path.join(basedir, img_folder)
    names = _list_images(srcdir)
    os.makedirs(imgdir)
    for name in names:
        img = Image.open(os.path.join(srcdir, name))
        w, h = img.size
        out = img.resize((int(round(w / factor)), int(round(h / factor))),
                         Image.LANCZOS)
        stem = os.path.splitext(name)[0]
        out.save(os.path.join(imgdir, stem + ".png"))


def _imread(path):
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def load_llff_data(basedir, factor=None, crop_size=0, load_colmap_poses=True):
    """Load images (+ poses). Returns a dict with poses (3, 5, N) raw LLFF
    poses (or None), bds (2, N) bounds (or None), imgs (N, H, W, 3) f32,
    img_names, crop_ratio and focal_crop_factor."""
    poses = bds = None
    if load_colmap_poses:
        poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])

    img_folder = "images"
    crop_ratio = 1
    focal_crop_factor = 1
    if crop_size != 0:
        # crop black borders, then restore the original size
        img_folder = "images_cropped"
        crop_dir = os.path.join(basedir, img_folder)
        src = os.path.join(basedir, "images")
        names = _list_images(src)
        if not os.path.exists(crop_dir):
            os.makedirs(crop_dir)
            for f in names:
                image = np.asarray(Image.open(os.path.join(src, f)))
                H, W = image.shape[:2]
                ch = crop_size
                cw = int(ch * W / H)
                cropped = image[ch: H - ch, cw: W - cw]
                Image.fromarray(cropped).resize((W, H)).save(
                    os.path.join(crop_dir, f))
        probe = np.asarray(Image.open(os.path.join(src, names[0])))
        H = probe.shape[0]
        crop_ratio = crop_size / H
        focal_crop_factor = (H - 2 * crop_size) / H

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factor, img_folder=img_folder)

    imgdir = os.path.join(basedir, img_folder + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")
    img_names = _list_images(imgdir)
    imgs = np.stack([_imread(os.path.join(imgdir, f)) for f in img_names])

    if load_colmap_poses:
        if poses.shape[-1] != len(img_names):
            raise ValueError(f"Mismatch between imgs {len(img_names)} and "
                             f"poses {poses.shape[-1]}")
        sh = imgs.shape[1:3]
        poses[:2, 4, :] = np.array(sh).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] * 1.0 / (factor or 1)

    return {
        "poses": poses,
        "bds": bds,
        "imgs": imgs.astype(np.float32),
        "img_names": img_names,
        "crop_ratio": crop_ratio,
        "focal_crop_factor": focal_crop_factor,
    }


def _unit(v, axis=-1):
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def _gram_schmidt_frame(forward, up_hint, origin):
    """Right-handed orthonormal camera frame (..., 3, 4) with columns
    [right, up, forward, origin] (LLFF's view-matrix convention)."""
    z = _unit(np.asarray(forward, dtype=np.float64) + 0.0)
    x = _unit(np.cross(up_hint, z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z, np.broadcast_to(origin, z.shape)], axis=-1)


def _rigid_apply_inverse(frame, poses34):
    """Apply the inverse of a rigid frame [R|t] to (N, 3, 4) poses:
    R' = R^T R_i, t' = R^T (t_i - t)."""
    R, t = frame[:3, :3], frame[:3, 3]
    out = np.einsum("ji,njk->nik", R, poses34[:, :3, :4])
    out[:, :3, 3] -= R.T @ t
    return out


def poses_avg(poses):
    """Mean camera frame of an (N, 3, 5) LLFF pose stack (hwf kept)."""
    frame = _gram_schmidt_frame(
        forward=poses[:, :3, 2].sum(0),
        up_hint=poses[:, :3, 1].sum(0),
        origin=poses[:, :3, 3].mean(0),
    )
    return np.concatenate([frame, poses[0, :3, -1:]], 1)


def recenter_poses(poses):
    """Re-express all poses relative to their average camera frame."""
    out = poses.copy()
    out[:, :3, :4] = _rigid_apply_inverse(poses_avg(poses)[:3, :4], poses)
    return out


def _nearest_point_to_rays(origins, dirs):
    """Least-squares point closest to a bundle of unit-direction rays."""
    P = np.eye(3)[None] - dirs[:, :, None] * dirs[:, None, :]
    PtP = np.einsum("nji,njk->nik", P, P).mean(0)
    rhs = np.einsum("nji,njk,nk->i", P, P, origins) / origins.shape[0]
    return np.linalg.solve(PtP, rhs)


def spherify_poses(poses, bds):
    """Spherify an inward-facing capture: re-frame on the point the camera
    z-rays nearly pass through, rescale the cameras to a unit sphere and
    synthesise a 120-frame orbit. Returns (poses, orbit poses, bds)."""
    center = _nearest_point_to_rays(poses[:, :3, 3], poses[:, :3, 2])
    up_axis = (poses[:, :3, 3] - center).mean(0)
    world = _gram_schmidt_frame(up_axis, [0.1, 0.2, 0.3], center)
    poses_reset = _rigid_apply_inverse(world, poses)

    rad = float(np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1))))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc

    zh = poses_reset[:, :3, 3].mean(0)[2]
    radcircle = np.sqrt(1.0 - (zh / 1.0) ** 2)
    th = np.linspace(0.0, 2.0 * np.pi, 120)
    camorigin = np.stack(
        [radcircle * np.cos(th), radcircle * np.sin(th), np.full_like(th, zh)],
        axis=-1,
    )
    z = _unit(camorigin)
    x = _unit(np.cross(z, np.array([0.0, 0.0, -1.0])))
    y = _unit(np.cross(z, x))
    new_poses = np.stack([x, y, z, camorigin], axis=-1)

    hwf = np.broadcast_to(poses[0, :3, -1:], (new_poses.shape[0], 3, 1))
    new_poses = np.concatenate([new_poses, hwf], -1)
    hwf_n = np.broadcast_to(poses[0, :3, -1:], (poses_reset.shape[0], 3, 1))
    poses_reset = np.concatenate([poses_reset[:, :3, :4], hwf_n], -1)
    return poses_reset, new_poses, bds


def load_depths_npz(image_list, datadir, norm=False):
    """DPT depth maps ``depth_<name>.npz``, optionally normalised across
    frames (median / mean absolute deviation)."""
    depths = []
    for image_name in image_list:
        frame_id = image_name.split(".")[0]
        depth = np.load(os.path.join(datadir, f"depth_{frame_id}.npz"))["pred"]
        if depth.ndim == 3 and depth.shape[0] == 1:
            depth = depth[0]
        depths.append(depth)
    depths = np.stack(depths)
    if norm:
        depths_n = []
        t_all = np.median(depths)
        s_all = np.mean(np.abs(depths - t_all))
        for depth in depths:
            t_i = np.median(depth)
            s_i = np.mean(np.abs(depth - t_i))
            depths_n.append(s_all * (depth - t_i) / s_i + t_all)
        depths = np.stack(depths_n)
    return depths.astype(np.float32)


def load_gt_depths(image_list, datadir, crop_ratio=1):
    """16-bit png gt depths in mm -> metres, cropped like the images."""
    depths = []
    for image_name in image_list:
        frame_id = image_name.split(".")[0]
        depth_path = os.path.join(datadir, "depth", f"{frame_id}.png")
        depth = np.asarray(Image.open(depth_path)).astype(np.float32) / 1000
        if crop_ratio != 1:
            h, w = depth.shape
            ch, cw = int(h * crop_ratio), int(w * crop_ratio)
            depth = depth[ch: h - ch, cw: w - cw]
        depths.append(depth)
    return np.stack(depths)
