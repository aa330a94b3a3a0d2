"""Render traffic: ``ops/rendering.py``'s ``render_image`` at the
configuration's ``extract_images.resolution``, on seeded novel poses along
the scene's camera path, with a seeded field, as the render CLI renders
novel views: each image's rgb and depth are copied to the host before the
next is issued (a closed loop; no image file is written).

Each image is timed from the start of its ``render_image`` call until its
rgb and depth are on the host. After the window, the comparison renders a
seeded sample of the window's images at a seeded sample of their pixels
with the plain reference and compares the program's pixels with them.

Mix keys: ``driver`` "render", ``poses`` (the number of seeded poses the
window cycles through), ``sample_images``, ``sample_pixels``,
``trace_dispatches`` (images profiled in a traced run), ``probe_iters``.
"""
from __future__ import annotations

import copy
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import counts, scene as scenes
from benchmark.drivers.common import WindowOut, release
from benchmark.drivers.train import mlp_inputs
from benchmark.profiling import annotate, device_seconds, profile_slice
from benchmark.reference import nerf as ref


class State:
    pass


def setup(ctx):
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    dev, cfg = ctx.device, copy.deepcopy(ctx.cfg)
    s = State()
    s.cfg = cfg
    s.scene = sc = scenes.Scene(ctx.config["scene"], ctx.seed, dev)
    s.hw = tuple(cfg["extract_images"]["resolution"] or (sc.H, sc.W))
    s.nerf = scenes.field_weights(cfg["model"], ctx.seed, dev)
    s.render_cfg = make_render_cfg(cfg, dev)
    rng = scenes.host_rng(ctx.seed, scenes.STREAM_ORDER)
    t = torch.as_tensor(rng.uniform(0.0, 1.0, ctx.mix["poses"]),
                        dtype=torch.float32, device=dev)
    s.worlds = torch.linalg.inv(sc.novel_c2ws(t))
    s.eye = torch.eye(4, device=dev)
    sample = scenes.host_rng(ctx.seed, scenes.STREAM_SAMPLE)
    s.pixels = np.sort(sample.choice(s.hw[0] * s.hw[1],
                                     ctx.mix["sample_pixels"],
                                     replace=False))
    s.sample_rng = sample
    s.kept = []
    render(s, 0)  # warm: this cell's one image shape
    return s


def render(s, i):
    """One image: (rgb, depth) on the host as numpy."""
    from nope_nerf_tpu_torch.ops.rendering import render_image

    rgb, depth = render_image(s.nerf, s.hw, s.scene.K,
                              s.worlds[i % len(s.worlds)], s.eye,
                              s.render_cfg)
    return rgb.cpu().numpy(), depth.cpu().numpy()


def window(s, ctx, t_start):
    dev = ctx.device
    clock = {"deadline": None}
    run = {"times": [], "timed": 0, "failed": 0}

    def loop(max_images, traced):
        done = 0
        while done < max_images and (
                traced or time.perf_counter() < clock["deadline"]):
            i = len(run["times"])
            with annotate("bench.image", traced):
                a = time.perf_counter()
                rgb, depth = render(s, i)
                run["times"].append(time.perf_counter() - a)
            with annotate("bench.keep_sample", traced):
                if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
                    run["failed"] += 1
                s.kept.append((i, rgb.reshape(-1, 3)[s.pixels].copy(),
                               depth.reshape(-1)[s.pixels].copy()))
            run["timed"] += 0 if traced else 1
            done += 1

    readings = {"phase": "render"}
    if ctx.trace:
        n_tr = ctx.mix["trace_dispatches"]
        readings["slice"] = profile_slice(lambda: loop(n_tr, True), dev)
        readings["slice_steps"] = n_tr
    # the timed window starts after a traced run's profiled slice, whose
    # trace is reduced before the clock starts
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    clock["deadline"] = t0 + ctx.seconds
    loop(float("inf"), False)
    readings["step_wall_s"] = (time.perf_counter() - t0) / run["timed"]
    times_ms = np.array(run["times"]) * 1e3
    print(f"render: {len(times_ms)} images, median "
          f"{statistics.median(times_ms):.4f} ms, p90 "
          f"{np.percentile(times_ms, 90):.4f} ms", flush=True,
          file=sys.stderr)
    readings["model_flops_per_step"] = counts.mlp_flops(
        s.cfg["model"], s.hw[0] * s.hw[1] * s.cfg["rendering"]["num_points"],
        "render")
    e2e = {"render_image_ms_p90": float(np.percentile(times_ms, 90)),
           "setup_s": setup_s}
    return WindowOut(e2e, len(times_ms), run["failed"], readings)


def probe(s, ctx):
    """Kernel A's no-save forward over one ``render_image`` chunk."""
    from nope_nerf_tpu_torch.ops.kernels.mlp_kernel import (
        collect_weights, fused_mlp_composite)

    dev = ctx.device
    rcfg, mcfg = s.cfg["rendering"], s.cfg["model"]
    rays_n = 16384  # render_image's chunk
    o, r, d, z, deltas = mlp_inputs(s, dev, rays_n, noise=False)
    weights = collect_weights(s.nerf)

    def call():
        with torch.no_grad():
            fused_mlp_composite(weights, o, r, d, z, deltas,
                                mcfg["pos_enc_levels"],
                                mcfg["dir_enc_levels"],
                                mcfg["occ_activation"],
                                not rcfg["dist_alpha"], rcfg["dist_alpha"],
                                rcfg["white_background"], z.shape[1])

    secs = device_seconds(call, dev, iters=ctx.mix["probe_iters"])
    least = counts.mlp_least_seconds(mcfg, rays_n, z.shape[1], "render")
    return {"mlp": (least, secs)}


def compare(s, ctx, log):
    dev = ctx.device
    release(dev)
    n = len(s.kept)
    picks = s.sample_rng.choice(n, min(ctx.mix["sample_images"], n),
                                replace=False)
    pix = torch.as_tensor(s.pixels, device=dev)
    rgb_gap = depth_gap = 0.0
    for j in sorted(int(p) for p in picks):
        i, rgb_p, depth_p = s.kept[j]
        rgb_r, depth_r = ref.render_pixels(
            s.nerf, pix, s.hw, s.scene.K, s.worlds[i % len(s.worlds)],
            s.cfg["model"], s.cfg["rendering"], ref.mm_f32)
        rgb_r, depth_r = rgb_r.cpu().numpy(), depth_r.cpu().numpy()
        rgb_gap = max(rgb_gap, rel_l2(rgb_p, rgb_r))
        depth_gap = max(depth_gap, rel_l2(depth_p, depth_r))
    log(f"compared images {sorted(int(p) for p in picks)} of {n}")
    return {"rgb_gap": rgb_gap, "depth_gap": depth_gap}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
