"""Image-quality evaluation CLI of the port, mirroring the repository's
``evaluation/eval.py``:

    python -m nope_nerf_tpu_torch.eval configs/Tanks/Ignatius.yaml [--depth] [--device cpu]

Restores the field, pose and focal streams from ``training.out_dir``,
optimises the poses of the held-out views (``eval_pose.type_to_eval:
eval``; ``train`` renders the training views at their learned poses),
renders every view, prints the per-image and mean PSNR / SSIM / LPIPS lines
(and with ``--depth`` the depth-error table), and writes ``img_out/``,
``depth_out/``, ``img_gt_out/`` and ``video_out/img.mp4`` under
``<out_dir>/<eval_pose.extraction_dir>/eval/<init_method>`` (or
``eval_trained``). LPIPS (``models.lpips``, on the eval device) reads
``extract_images.lpips_weights`` (default ``models.lpips.DEFAULT_WEIGHTS``,
written by ``python -m nope_nerf_tpu_torch.convert_lpips``) and reports nan
only when that file is missing.

Runs on ``--device`` (default ``cuda``; with no CUDA device it raises
unless ``--device cpu`` is given). Scenes are read with the port's numpy
loader (``dataloading.scene``) and the video is written by its MJPEG muxer
(``utils.mp4``), numpy + PIL only.
"""
import argparse
import os
import time

import numpy as np
import torch

from .config import (
    DEFAULT_CONFIG,
    apply_parity_profile,
    check_supported,
    load_config,
)
from .convert import load_group
from .dataloading.scene import get_scene
from .device import resolve_device
from .evaluation.eval_images import eval_image, resize_like_cv2
from .evaluation.metrics import median_scaled_depth_errors
from .evaluation.pose_opt import init_eval_poses, optimize_eval_poses
from .geometry.rays import camera_mat_from_fxfy
from .models.intrinsics import focal_fxfy
from .models.lpips import load_lpips
from .models.pose import all_poses
from .training.checkpoints import CheckpointIO
from .training.trainer import make_render_cfg
from .utils.logging import MetricsLogger
from .utils.mp4 import write_mjpeg_mp4


def main(cfg, eval_depth=False, device="cuda", train_scene=None,
         eval_scene=None):
    """Evaluate; ``train_scene`` / ``eval_scene`` (the held-out views)
    default to the scene on disk. Returns the means (psnr, ssim, lpips) and
    ms_per_image (host clock around each view's render and scoring)."""
    apply_parity_profile(cfg)
    np.random.seed(0)
    dev = resolve_device(device)

    out_dir = cfg["training"]["out_dir"]
    generation_dir = os.path.join(out_dir, cfg["eval_pose"]["extraction_dir"])
    os.makedirs(generation_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, "logs"))
    if train_scene is None or eval_scene is None:
        train_scene = train_scene or get_scene(cfg, mode="train")
        eval_scene = eval_scene or get_scene(cfg, mode="eval")

    io = CheckpointIO(out_dir)
    xcfg, ecfg, pcfg = cfg["extract_images"], cfg["eval_pose"], cfg["pose"]
    nerf_params = load_group(io, xcfg["model_file"], "nerf", dev)
    init_method = ecfg["init_method"]
    render_cfg = make_render_cfg(cfg, dev)

    if pcfg["learn_focal"]:
        fparams = load_group(io, xcfg["model_file_focal"], "focal", dev)
        fxfy = focal_fxfy(fparams, pcfg["fx_only"], pcfg["focal_order"])
        camera_mat = camera_mat_from_fxfy(fxfy).cpu().numpy()
        print(f"learned fx: {float(fxfy[0]):.2f}, fy: {float(fxfy[1]):.2f}")
    else:
        camera_mat = train_scene.K

    init_c2w_train = (
        torch.as_tensor(train_scene.c2ws, dtype=torch.float32)
        if (pcfg["init_pose"] and train_scene.c2ws is not None) else None)
    if pcfg["learn_pose"]:
        pose_params = load_group(io, xcfg["model_file_pose"], "pose", "cpu")
        learned_c2ws_train = all_poses(pose_params, init_c2w_train).numpy()
    else:
        learned_c2ws_train = train_scene.c2ws

    if ecfg["type_to_eval"] == "train":
        scene = train_scene
        eval_c2ws = learned_c2ws_train
        render_dir = os.path.join(generation_dir, "eval_trained")
    else:
        scene = eval_scene
        render_dir = os.path.join(generation_dir, "eval", init_method)
        init_c2ws = init_eval_poses(
            init_method, eval_scene.c2ws, learned_c2ws_train,
            train_scene.c2ws, train_scene.sample_rate, eval_scene.N_imgs)
        eval_imgs = torch.as_tensor(np.asarray(scene.imgs), device=dev)
        eval_c2ws, _ = optimize_eval_poses(
            nerf_params, camera_mat, cfg, render_cfg, eval_imgs,
            scene.scale_mat, init_c2ws, ecfg["opt_pose_epoch"],
            ecfg["opt_eval_lr"], ecfg["n_points"], logger=logger)
    os.makedirs(render_dir, exist_ok=True)

    # LPIPS on the eval device; only a MISSING weights file reports nan, any
    # other fault of the LPIPS stack surfaces. lpips_weights None reads
    # models.lpips.DEFAULT_WEIGHTS
    lpips_fn = None
    try:
        lpips_fn = load_lpips(xcfg.get("lpips_weights"), dev)
    except FileNotFoundError as e:
        print(f"LPIPS weights not found ({e}); reporting nan — convert them "
              "once with python -m nope_nerf_tpu_torch.convert_lpips")

    resolution = xcfg["resolution"] or (scene.H, scene.W)
    results, ms_per_image = [], []
    depth_gts, depth_preds = [], []
    min_depth, max_depth = 0.1, 20.0
    scene_depth = getattr(scene, "depth", None)
    for i in range(scene.N_imgs):
        world_mat = np.linalg.inv(eval_c2ws[i])
        img_gt = resize_like_cv2(np.asarray(scene.imgs[i]), resolution).numpy()
        dgt = scene_depth[i] if scene_depth is not None else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = eval_image(
            nerf_params, render_cfg, resolution, camera_mat, world_mat,
            scene.scale_mat, img_gt, depth_gt=dgt, lpips_fn=lpips_fn,
            min_depth=min_depth, max_depth=max_depth, render_dir=render_dir,
            img_idx=i)
        ms_per_image.append(1e3 * (time.perf_counter() - t0))
        print(f"{i:4d} img: PSNR: {out['psnr']:.2f}, SSIM: {out['ssim']:.2f}, "
              f"LPIPS {out['lpips']:.2f}")
        results.append(out)
        if dgt is not None:
            depth_gts.append(out["depth_gt"])
            depth_preds.append(out["depth_pred"])

    mean_psnr = float(np.mean([r["psnr"] for r in results]))
    mean_ssim = float(np.mean([r["ssim"] for r in results]))
    mean_lpips = float(np.mean([r["lpips"] for r in results]))
    mean_mse = float(np.mean([r["mse"] for r in results]))
    print("--------------------------")
    print(f"Mean MSE: {mean_mse:.2f}, PSNR: {mean_psnr:.2f}, "
          f"SSIM: {mean_ssim:.2f}, LPIPS {mean_lpips:.2f}")
    print(f"{mean_psnr:.2f} &{mean_ssim:.2f} & {mean_lpips:.2f}")

    if eval_depth and depth_gts:
        mean_errors, _ = median_scaled_depth_errors(depth_gts, depth_preds,
                                                    min_depth, max_depth)
        header = ("{:>8} | " * 7).format("abs_rel", "sq_rel", "rmse",
                                         "rmse_log", "a1", "a2", "a3")
        row = ("&{: 8.3f}  " * 7).format(*mean_errors.tolist()) + "\\\\"
        print("\n  " + header)
        print(row)
        with open(os.path.join(generation_dir, "depth_evaluation.txt"),
                  "a") as f:
            f.write(header + "\n" + row + "\n")

    video_dir = os.path.join(render_dir, "video_out")
    os.makedirs(video_dir, exist_ok=True)
    write_mjpeg_mp4(os.path.join(video_dir, "img.mp4"),
                    np.stack([r["img"] for r in results]), fps=30, quality=85)
    logger.close()
    return {"psnr": mean_psnr, "ssim": mean_ssim, "lpips": mean_lpips,
            "ms_per_image": ms_per_image}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Evaluate images (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--depth", action="store_true",
                        help="evaluate depth metrics")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    args = parser.parse_args()
    cfg = load_config(args.config, DEFAULT_CONFIG)
    check_supported(cfg)
    if args.depth:
        cfg["extract_images"]["eval_depth"] = True
    main(cfg, eval_depth=cfg["extract_images"]["eval_depth"] or args.depth,
         device=args.device)
