"""Rank bodies of ``tests/test_torch_parallel.py``, importable without JAX.

:func:`start` spawns a two-rank gloo group (``torch.multiprocessing``, a
``file://`` store in the test's directory); each rank runs one function of
this module and pickles what it returns to ``<dir>/<name>_<rank>.pkl``.
The same functions run in the test process with ``mesh=None`` for the
one-process reference.
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 2
JOIN_TIMEOUT = 240.0  # seconds for a whole spawn


def _entry(rank, fn, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        from nope_nerf_tpu_torch.parallel.mesh import make_ray_mesh

        result = fn(make_ray_mesh(WORLD, device="cpu"), *args)
        with open(os.path.join(tmp, f"{fn.__name__}_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def start(fn, tmp, *args):
    """Start ``fn(mesh, *args)`` on each of WORLD ranks; :func:`wait`
    returns their results."""
    tmp = str(tmp)
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, tmp, args), nprocs=WORLD, join=False,
        start_method="spawn")
    return ctx, fn.__name__, tmp, time.monotonic() + JOIN_TIMEOUT


def wait(handle):
    """The ranks' results of :func:`start`; a rank that fails, or is still
    running JOIN_TIMEOUT seconds after the start, fails the call."""
    ctx, name, tmp, deadline = handle
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{name}: ranks still running after "
                               f"{JOIN_TIMEOUT} s")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"{name}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


class ArrayScene:
    """The arrays of a scene (what ``scene_batch_arrays`` reads)."""

    def __init__(self, imgs, dpt_depth, K, scale_mat):
        self.imgs, self.dpt_depth = imgs, dpt_depth
        self.K, self.scale_mat = K, scale_mat
        self.N_imgs = imgs.shape[0]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


SCALARS = {
    "weights": {"rgb_weight": 1.0, "depth_weight": 0.04, "pc_weight": 1.0,
                "rgb_s_weight": 1.0, "depth_consistency_weight": 0.0,
                "weight_dist_1st_loss": 0.1, "weight_dist_2nd_loss": 0.1},
    "w_l1": 1.0, "w_l2": 0.0,
    "lrs": {"nerf": 1e-3, "pose": 1e-3, "focal": 1e-3, "distortion": 1e-3},
}
STATIC = {"render_model": True, "use_ref": True, "use_rgb_s": True}


def train_steps(mesh, setup, configs):
    """One training step per (name, tpu overrides, injected ray_idx or
    None, {"weight_decay": ..., "static": overrides}) of ``configs`` from
    the same parameters: {name: (loss, aux scalars, parameters after Adam,
    the gradients Adam read)}, numpy."""
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.parallel.mesh import shard_train_step
    from nope_nerf_tpu_torch.training.loop import scene_batch_arrays
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_render_cfg,
                                                      make_train_step)

    out = {}
    for name, tpu, ray_idx, opts in configs:
        cfg = dict(setup["cfg"], tpu=dict(setup["cfg"]["tpu"], **tpu),
                   training=dict(setup["cfg"]["training"],
                                 weight_decay=opts.get("weight_decay", 0.0)))
        scene = ArrayScene(**setup["scene"])
        batch = dict(scene_batch_arrays(scene, cfg, "cpu"), idx=0, ref_idx=1)
        if ray_idx is not None:
            batch["ray_idx"] = torch.as_tensor(ray_idx)
        params = params_from_jax(setup["params"])
        init_c2w = (None if setup["init_c2w"] is None
                    else torch.as_tensor(setup["init_c2w"]))
        state = init_train_state(params)
        rcfg = make_render_cfg(cfg, "cpu")
        step = (make_train_step(cfg, rcfg, init_c2w) if mesh is None
                else shard_train_step(cfg, rcfg, init_c2w, mesh))
        state, aux = step(state, batch, SCALARS,
                          dict(STATIC, **opts.get("static", {})),
                          torch.Generator().manual_seed(7))
        leaves = _leaves(state.params)
        out[name] = (
            float(aux["loss"]),
            {k: float(v) for k, v in aux.items() if v.numel() == 1},
            {k: v.detach().numpy().copy() for k, v in leaves.items()},
            {k: v.grad.numpy().copy() for k, v in leaves.items()})
    return out


def chamfer(mesh, clouds):
    """The sharded Chamfer wrappers (Kernels B and D, plain versions on the
    CPU) on ``clouds``: per mode, this rank's rows and indices both ways,
    the loss, and the clouds' gradients averaged over the ranks."""
    from nope_nerf_tpu_torch.ops.kernels.chamfer_band import (
        chamfer_loss_banded_sharded, nearest_idx_banded_sharded)
    from nope_nerf_tpu_torch.ops.kernels.chamfer_kernel import (
        chamfer_loss_exact_sharded, nearest_idx_exact_sharded)
    from nope_nerf_tpu_torch.parallel.mesh import all_reduce_grads

    out = {}
    for mode, c in clouds.items():
        X = torch.tensor(c["X"], requires_grad=True)
        Y = torch.tensor(c["Y"], requires_grad=True)
        if mode == "band":
            sx, sy = torch.tensor(c["sx"]), torch.tensor(c["sy"])
            rx, ix = nearest_idx_banded_sharded(X, Y, sx, mesh, c["k"])
            ry, iy = nearest_idx_banded_sharded(Y, X, sy, mesh, c["k"])
            loss = chamfer_loss_banded_sharded(X, Y, sx, sy, mesh, c["k"])
        else:
            rx, ix, ry, iy = nearest_idx_exact_sharded(X, Y, mesh)
            loss = chamfer_loss_exact_sharded(X, Y, mesh)
        loss.backward()
        all_reduce_grads([X.grad, Y.grad], mesh)
        out[mode] = {"rx": (rx.start, rx.stop), "ix": ix.numpy(),
                     "ry": (ry.start, ry.stop), "iy": iy.numpy(),
                     "loss": float(loss), "gx": X.grad.numpy(),
                     "gy": Y.grad.numpy()}
    return out


def render_images(mesh, routes):
    """``render_image`` of a seeded field under each render config of
    ``routes``: {name: (rgb, depth)}."""
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.rendering import render_image

    model = {"model": {"hidden_dim": 32, "pos_enc_levels": 4,
                       "dir_enc_levels": 2, "occ_activation": "softplus"},
             "rendering": {"white_background": False}}
    params = init_nerf_params(torch.Generator().manual_seed(0), model, "cpu")
    K = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0]))
    out = {}
    for name, rcfg in routes.items():
        rgb, depth = render_image(params, (8, 16), K, torch.eye(4),
                                  torch.eye(4), rcfg, chunk=64, mesh=mesh)
        out[name] = (rgb.numpy(), depth.numpy())
    return out


def dpt(mesh, weights_path, imgs, cli_cfg):
    """``apply_dpt_batched`` on ``imgs`` and, with ``cli_cfg``, the
    ``dpt_depth`` CLI's ``main`` (rank 0 writes)."""
    from nope_nerf_tpu_torch import dpt_depth
    from nope_nerf_tpu_torch.models.dpt import apply_dpt_batched, load_dpt

    params = load_dpt(weights_path, "cpu")
    depth = apply_dpt_batched(params, torch.as_tensor(imgs), mesh=mesh)
    out_dir = dpt_depth.main(cli_cfg, device="cpu", mesh=mesh)
    return depth.numpy(), out_dir


def train_runs(mesh, out_dir):
    """``train()`` with ``tpu.n_devices: 2`` on the synthetic scene (16x20,
    64 rays, 16 samples): 3 epochs with the visualisation and pair dumps
    step by step, a resume for one more and 2 epochs at
    rays_per_step_multiplier 2 on the scan path.
    Returns each run's history and final parameters, and what each refused
    call raised."""
    from nope_nerf_tpu_torch.parallel.mesh import make_ray_mesh
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import (SyntheticScene,
                                                     tiny_config)

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16,
                           device="cpu")

    def cfg_for(sub, epochs_tpu):
        cfg = tiny_config(scene, os.path.join(out_dir, sub),
                          n_training_points=64, num_points=16)
        cfg["training"].update({
            "scheduling_start": 0, "annealing_epochs": 0,
            "auto_scheduler": False, "eval_pose_every": 1,
            "visualize_every": 4, "vis_reprojection_every": 4,
            "vis_resolution": [16, 20], "checkpoint_every": 4,
            "print_every": 1})
        cfg["tpu"].update({"n_devices": 2, **epochs_tpu})
        return cfg

    out = {}
    # the first run steps one by one (its visualisations fall on the JAX
    # non-scan loop's steps 4 and 8); the resume and the k = 2 run take the
    # stock scan path
    for name, sub, epochs, tpu in (("vis", "vis", 3, {"epoch_scan": False}),
                                   ("resume", "vis", 5, {}),
                                   ("k2", "k2", 2,
                                    {"rays_per_step_multiplier": 2})):
        state, _, _, hist = train(cfg_for(sub, tpu), max_epochs=epochs,
                                  scene=scene, device="cpu")
        out[name] = (hist, {k: v.detach().numpy().copy() for k, v in
                            _leaves(state.params).items()})
    refusals = {}
    for name, call in (
            ("world_size", lambda: make_ray_mesh(3, device="cpu")),
            ("mesh_size", lambda: train(
                dict(cfg_for("x", {}), tpu={"n_devices": 4}), max_epochs=1,
                scene=scene, device="cpu", mesh=mesh))):
        try:
            call()
        except ValueError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def everything(mesh, setup, configs, clouds, routes, weights_path, imgs,
               dpt_cfg):
    """:func:`train_steps`, :func:`chamfer` (under a mesh only),
    :func:`render_images` and :func:`dpt` in one process group."""
    out = {"steps": train_steps(mesh, setup, configs),
           "render": render_images(mesh, routes),
           "dpt": dpt(mesh, weights_path, imgs, dpt_cfg)}
    if mesh is not None:
        out["chamfer"] = chamfer(mesh, clouds)
    return out
