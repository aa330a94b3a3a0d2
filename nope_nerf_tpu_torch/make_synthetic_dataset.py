"""Synthetic LLFF-layout dataset of the port (``tools/make_synthetic_dataset.py``):

    python -m nope_nerf_tpu_torch.make_synthetic_dataset <out_dir> [--frames 6]
        [--height 60] [--width 80] [--seed 0] [--gt-depth] [--device cuda]
        [--teacher tests/fixtures/teacher_seed3.npz]

Renders the teacher scene of ``utils.synthetic.SyntheticScene`` on
``--device`` (default ``cuda``; with no CUDA device it raises unless
``--device cpu`` is given) and writes the layout ``dataloading.scene``
reads: ``images/NNN.png``, ``dpt/depth_NNN.npz`` (key ``pred``),
``poses_bounds.npy`` and, with ``--gt-depth``, ``depth/NNN.png`` (16-bit
millimetres).

With ``--teacher`` the teacher field is read from that file (the nerf group
in the checkpoint format, ``training.checkpoints``), e.g. the JAX package's
teacher at a seed written by ``tools/torch_teacher_fixture.py``: the frames
are then those of ``tools/make_synthetic_dataset.py`` at that seed.
"""
import argparse
import os

import numpy as np
from PIL import Image

from .training.checkpoints import load_pytree
from .utils.synthetic import SyntheticScene


def write_dataset(scene, scene_dir, gt_depth=False):
    """Write ``scene`` (a ``SyntheticScene``) under ``scene_dir`` in the LLFF
    layout."""
    img_dir = os.path.join(scene_dir, "images")
    dpt_dir = os.path.join(scene_dir, "dpt")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(dpt_dir, exist_ok=True)
    H, W = scene.H, scene.W
    focal_px = 0.8 * W  # SyntheticScene's K
    rows = []
    for i in range(scene.N_imgs):
        name = f"{i:03d}"
        Image.fromarray(
            (np.clip(scene.imgs[i], 0, 1) * 255).astype(np.uint8)
        ).save(os.path.join(img_dir, name + ".png"))
        np.savez(os.path.join(dpt_dir, f"depth_{name}.npz"),
                 pred=scene.dpt_depth[i].astype(np.float32))
        if gt_depth:
            gt_dir = os.path.join(scene_dir, "depth")
            os.makedirs(gt_dir, exist_ok=True)
            # the teacher's rendered depth is the ground truth here, as a
            # 16-bit png in millimetres
            mm = np.clip(scene.dpt_depth[i] * 1000.0, 0, 65535)
            Image.fromarray(mm.astype(np.uint16)).save(
                os.path.join(gt_dir, name + ".png"))

        # the inverse of the loader's column permutation, which maps LLFF
        # columns [old1, -old0, old2, t, hwf] to c2w [right, up, back, t]
        c2w = scene.c2ws[i]
        right, up, back, t = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3]
        m = np.stack([-up, right, back, t], axis=1)  # (3, 4) LLFF columns
        hwf = np.array([H, W, focal_px])[:, None]
        pose35 = np.concatenate([m, hwf], axis=1)  # (3, 5)
        near, far = 0.5, 6.0
        rows.append(np.concatenate([pose35.reshape(-1), [near, far]]))
    np.save(os.path.join(scene_dir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Write a synthetic teacher scene in the LLFF layout.")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gt-depth", action="store_true",
                    help="also write depth/<frame>.png, 16-bit millimetre "
                         "gt depths")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the teacher render (default: "
                         "cuda).")
    ap.add_argument("--teacher", type=str, default=None,
                    help="npz of the teacher's nerf parameters (default: "
                         "the port's own teacher at --seed)")
    args = ap.parse_args(argv)
    teacher = None if args.teacher is None else load_pytree(args.teacher)[0]
    scene = SyntheticScene(n_frames=args.frames,
                           hw=(args.height, args.width), seed=args.seed,
                           num_points=32, teacher=teacher, device=args.device)
    write_dataset(scene, args.out_dir, gt_depth=args.gt_depth)
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
