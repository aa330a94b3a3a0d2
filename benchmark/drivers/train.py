"""Training traffic: the stock step of ``training/trainer.py``
(``make_epoch_step``), one epoch a dispatch, as ``training/loop.py``
drives it.

Each epoch visits the training frames in a seeded shuffled order, each
step with its ``random_ref`` 1 partner (the next frame; the last frame
pairs backwards), and its mean loss is read one epoch behind. A closed
loop: the next epoch is issued when the previous one has been handed to
the device, and the window ends at the read of the last epoch's loss.

Set-up builds one training step (the parameters and their Adam state, the
captured graphs, the generator) and drives it through one full epoch, the
window's own call: its key's eager first step, the capture of the graph
that the window replays, and the replays. Between its steps set-up copies
Adam's state after the first and the parameters after ``check_steps``.
The window continues the same object. The comparison holds the first
steps' losses, the first gradient (from Adam's first moment after one
step) and the parameters' change after ``check_steps`` steps to the plain
reference, which redoes every draw of the step from the generator's saved
state.

Mix keys: ``driver`` "train", ``check_steps``, ``trace_dispatches`` (the
epochs profiled in a traced run), ``probe_iters``.
"""
from __future__ import annotations

import copy
import time

import torch

from benchmark import counts, scene as scenes
from benchmark.drivers.common import (HostCopy, WindowOut, finite,
                                      first_gradient, idle_host_spans,
                                      leaf_dev, leaf_gap, loss_gap,
                                      moving_leaves, print_quarters,
                                      rel_dev, release, stops_after)
from benchmark.profiling import annotate, device_seconds, profile_slice
from benchmark.reference import nerf as ref

DENSITY_W = "nerf/fc_density/w"
# the step's loss and its terms: the reference's names -> the program's
TERMS = {"loss": "loss", "rgb": "loss_rgb", "depth": "loss_depth",
         "pc": "loss_pc", "rgb_s": "loss_rgb_s"}


def ref_partner(i, n):
    return i - 1 if i == n - 1 else i + 1


def first_weights(tcfg):
    """The loss weights and the rgb loss of the schedule's first phase."""
    names = ("rgb_weight", "depth_weight", "pc_weight", "rgb_s_weight",
             "depth_consistency_weight", "weight_dist_1st_loss",
             "weight_dist_2nd_loss")
    w = {k: float(tcfg[k][0]) for k in names}
    w_l1, w_l2 = ((0.0, 1.0) if tcfg["rgb_loss_type"] == "l2"
                  else (1.0, 0.0))
    return w, w_l1, w_l2


def group_lrs(tcfg):
    return {"nerf": tcfg["learning_rate"], "pose": tcfg["pose_lr"],
            "focal": tcfg["focal_lr"], "distortion": tcfg["distortion_lr"]}


class State:
    pass


def setup(ctx):
    from nope_nerf_tpu_torch.ops.interp import resize_bilinear, resize_nearest
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_epoch_step,
                                                      make_render_cfg)

    dev, cfg = ctx.device, copy.deepcopy(ctx.cfg)
    if int(cfg["tpu"].get("rays_per_step_multiplier", 1) or 1) != 1:
        raise ValueError("the training driver runs one frame a step")
    s = State()
    s.scene = sc = scenes.Scene(ctx.config["scene"], ctx.seed, dev)
    n = sc.n_train
    cfg["_num_cams"] = n
    s.cfg = cfg
    tcfg = cfg["training"]
    ratio = tcfg["pc_ratio"]
    s.small_hw = (int(sc.H / ratio), int(sc.W / ratio))
    batch = {"imgs": sc.train_imgs, "dpts": sc.train_dpts,
             "dpts_small": torch.stack([resize_nearest(d, s.small_hw)
                                        for d in sc.train_dpts]),
             "imgs_small": torch.stack([resize_bilinear(im, s.small_hw)
                                        for im in sc.train_imgs]),
             "camera_mat_gt": sc.K, "scale_mat": torch.eye(4, device=dev)}
    pose, dist = scenes.frame_params(n, ctx.seed, dev)
    params = {"nerf": scenes.field_weights(cfg["model"], ctx.seed, dev),
              "pose": pose, "focal": scenes.focal_params(sc.K),
              "distortion": dist}
    s.leaves = ref.leaves_of(params)
    s.params0 = {k: v.clone() for k, v in s.leaves.items()}
    s.nerf = params["nerf"]
    s.render_cfg = make_render_cfg(cfg, dev)
    s.train_state = init_train_state(params, capturable=dev.type == "cuda")
    s.epoch_fn = make_epoch_step(cfg, s.render_cfg, None, device=dev)
    w, w_l1, w_l2 = first_weights(tcfg)
    s.weights, s.w_l1, s.w_l2 = w, w_l1, w_l2
    s.lrs = group_lrs(tcfg)
    s.scalars = {"weights": w, "w_l1": w_l1, "w_l2": w_l2, "lrs": s.lrs}
    s.static = {"render_model": True, "use_ref": True, "use_rgb_s": True}
    s.batch = batch
    s.gen = scenes.seeded(ctx.seed, scenes.STREAM_STEP, dev)
    s.gen_state = s.gen.get_state()
    s.rng = scenes.host_rng(ctx.seed, scenes.STREAM_ORDER)
    s.n = n
    s.rays_per_step = tcfg["n_training_points"]

    # the first epoch, through the window's own call, key and graph
    order = s.rng.permutation(n)
    k = ctx.mix["check_steps"]
    if not 2 <= k <= n:
        raise ValueError(f"check_steps {k} outside 2..{n}")
    s.check_frames = [(int(i), ref_partner(int(i), n)) for i in order[:k]]
    opt = s.train_state.optimizer
    by_tensor = {id(t): name for name, t in s.leaves.items()}

    def after_first():
        s.moment1 = {by_tensor[id(p)]: st["exp_avg"].detach().clone()
                     for p, st in opt.state.items()}

    def after_check():
        s.params_k = {name: t.detach().clone()
                      for name, t in s.leaves.items()}

    with stops_after({1: after_first, k: after_check}):
        dispatch(s, order).wait()
    steps = {t: s.epoch_fn.steps[v][:k].tolist() for t, v in TERMS.items()}
    s.check_losses = [{t: steps[t][j] for t in TERMS} for j in range(k)]
    return s


def dispatch(s, order):
    """Queue one epoch in ``order``; returns the copy of its mean loss."""
    refs = [ref_partner(int(i), s.n) for i in order]
    _, aux_mean, _ = s.epoch_fn(s.train_state, s.batch, order, refs,
                                s.scalars, s.gen, s.static)
    return HostCopy(aux_mean["loss"])


def window(s, ctx, t_start):
    dev = ctx.device
    clock = {"deadline": None}
    run = {"steps": 0, "timed": 0, "failed": 0, "prev": None, "marks": []}

    def loop(max_dispatches, traced):
        done = 0
        while done < max_dispatches and (
                traced or time.perf_counter() < clock["deadline"]):
            order = s.rng.permutation(s.n)
            with annotate("bench.dispatch", traced):
                cp = dispatch(s, order)
            if run["prev"] is not None:
                with annotate("bench.loss_read", traced):
                    if not finite(float(run["prev"].wait())):
                        run["failed"] += s.n
                if not traced:
                    run["marks"].append((time.perf_counter(), run["timed"]))
            run["prev"] = cp
            run["steps"] += s.n
            run["timed"] += 0 if traced else s.n
            done += 1

    readings = {"phase": "train"}
    if ctx.trace:
        n_tr = ctx.mix["trace_dispatches"]
        readings["slice"] = profile_slice(lambda: loop(n_tr, True), dev)
        readings["slice_steps"] = n_tr * s.n
    # the timed window starts after a traced run's profiled slice, whose
    # trace is reduced before the clock starts
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    clock["deadline"] = t0 + ctx.seconds
    loop(float("inf"), False)
    if not finite(float(run["prev"].wait())):
        run["failed"] += s.n
    wall = time.perf_counter() - t0
    run["marks"].append((t0 + wall, run["timed"]))
    print_quarters(run["marks"], t0, wall, s.rays_per_step)
    readings["step_wall_s"] = wall / run["timed"]
    readings["model_flops_per_step"] = counts.mlp_flops(
        s.cfg["model"], s.rays_per_step * s.cfg["rendering"]["num_points"],
        "train")
    e2e = {"train_rays_per_s": run["timed"] * s.rays_per_step / wall,
           "setup_s": setup_s}
    return WindowOut(e2e, run["steps"], run["failed"], readings)


def mlp_inputs(s, dev, rays_n, noise=True):
    """Rays of the cell's shapes for the Kernel A probes: random pixels of
    a frame at the origin, through the reference's ray set-up."""
    rcfg = s.cfg["rendering"]
    g = scenes.seeded(0, scenes.STREAM_SAMPLE, dev)
    H, W = s.scene.H, s.scene.W
    idx = torch.randint(0, H * W, (rays_n,), generator=g, device=dev)
    prior = torch.ones(rays_n, device=dev)  # the MLP reads no prior
    jitter = (torch.rand((rays_n, rcfg["num_points"]), generator=g,
                         device=dev) if noise else None)
    eye = torch.eye(4, device=dev)
    ray = ref.rays(ref.pixel_coords(idx, H, W), prior, s.scene.K, eye, eye,
                   rcfg, jitter)
    z = ray["z"].contiguous()
    deltas = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full_like(z[:, :1], 1e10)], -1)
    return (ray["origins"].contiguous(), ray["along"].contiguous(),
            ray["view"].contiguous(), z, deltas)


def mlp_call(s, inputs, weights, phase):
    """One call of Kernel A's public function in ``phase``: the forward,
    then for training the full backward of rgb and distance, for pose
    optimisation the backward to the ray inputs only."""
    from nope_nerf_tpu_torch.ops.kernels.mlp_kernel import \
        fused_mlp_composite

    rcfg, mcfg = s.cfg["rendering"], s.cfg["model"]
    o, r, d, z, deltas = inputs
    with torch.set_grad_enabled(phase != "render"):
        rgb, dist, _ = fused_mlp_composite(
            weights, o, r, d, z, deltas, mcfg["pos_enc_levels"],
            mcfg["dir_enc_levels"], mcfg["occ_activation"],
            not rcfg["dist_alpha"], rcfg["dist_alpha"],
            rcfg["white_background"], z.shape[1])
        if phase != "render":
            torch.autograd.backward([rgb, dist], [torch.ones_like(rgb),
                                                  torch.ones_like(dist)])


def mlp_probe(s, dev, rays_n, phase, iters):
    """(least seconds, device seconds) of Kernel A's function on the
    cell's shapes."""
    from nope_nerf_tpu_torch.ops.kernels.mlp_kernel import collect_weights

    nerf = {k: {kk: v.detach().clone().requires_grad_(phase == "train")
                for kk, v in layer.items()}
            for k, layer in s.nerf.items()}
    weights = collect_weights(nerf)
    inputs = mlp_inputs(s, dev, rays_n, noise=phase == "train")
    if phase != "render":  # the step's rays carry the pose's gradient
        inputs = tuple(t.requires_grad_(i < 3) for i, t in enumerate(inputs))
    secs = device_seconds(lambda: mlp_call(s, inputs, weights, phase), dev,
                          iters=iters)
    least = counts.mlp_least_seconds(s.cfg["model"], rays_n,
                                     inputs[3].shape[1], phase)
    return least, secs


def chamfer_probe(s, dev, iters):
    """(least seconds, device seconds) of the banded argmin's two calls on
    the cell's clouds: frames 0 and 1 backprojected at their small priors,
    the first moved by their relative pose."""
    from nope_nerf_tpu_torch.ops.kernels.chamfer_band import \
        nearest_idx_banded

    hs, ws = s.small_hw
    K = s.scene.K
    eye = torch.eye(4, device=dev)
    grid = ref.grid_coords(hs, ws, dev)
    to_world = ref.pixel_to_world(K, eye, eye)
    small = s.batch["dpts_small"]
    pc1 = ref.backproject(grid, small[0].reshape(-1), to_world)
    pc2 = ref.backproject(grid, small[1].reshape(-1), to_world)
    rel = (ref.rigid_inverse(ref.c2w_of(s.params0["pose/r"][1],
                                        s.params0["pose/t"][1]))
           @ ref.c2w_of(s.params0["pose/r"][0], s.params0["pose/t"][0]))
    R, t = rel[:3, :3], rel[:3, 3]
    X = (pc1 @ R.t() + t).contiguous()
    Y = pc2.contiguous()
    tpu = s.cfg["tpu"]
    k = ref.band_tiles((hs, ws), tpu["chamfer_band_rows"],
                       tpu.get("chamfer_band_tiles"))

    def starts(pts):
        xy, _ = ref.project(pts, K)
        return ref.band_starts((xy[:, 1] + 1.0) * 0.5 * (hs - 1), hs * ws,
                               ws, k)

    sx, sy = starts(X), starts((Y - t) @ R)
    pairs = (ref.band_pairs(sx, X.shape[0], Y.shape[0], k)
             + ref.band_pairs(sy, Y.shape[0], X.shape[0], k))

    def call():
        nearest_idx_banded(X, Y, sx, k)
        nearest_idx_banded(Y, X, sy, k)

    return counts.band_least_seconds(pairs), device_seconds(call, dev,
                                                            iters=iters)


def probe(s, ctx):
    dev = ctx.device
    iters = ctx.mix["probe_iters"]
    return {"mlp": mlp_probe(s, dev, s.rays_per_step, "train", iters),
            "chamfer": chamfer_probe(s, dev, iters),
            "host_spans": idle_host_spans(
                lambda: (dispatch(s, s.rng.permutation(s.n)), s.n), dev)}


def reference_frames(s):
    """The reference's own copies of what the step reads: the frames, their
    priors, and its own pc_ratio pyramid."""
    sc = s.scene
    return {"imgs": sc.train_imgs, "dpts": sc.train_dpts, "K": sc.K,
            "dpts_small": torch.stack([ref.resize_nearest(d, s.small_hw)
                                       for d in sc.train_dpts]),
            "imgs_small": torch.stack([ref.resize_bilinear(im, s.small_hw)
                                       for im in sc.train_imgs])}


def program_side(s):
    """The program's readings for the comparison: the first steps' losses,
    the first gradient (Adam's first moment after one step over 1 - beta1)
    and the parameters after the first steps."""
    return (list(s.check_losses), first_gradient(s.moment1, s.params0),
            dict(s.params_k))


def free_program(s, dev):
    for name in ("epoch_fn", "train_state", "batch", "leaves", "nerf"):
        if hasattr(s, name):
            delattr(s, name)
    release(dev)


def reference_side(s, dev, mm=ref.mm_f32, **kw):
    """The reference's readings of the same steps from the same inputs."""
    gen = torch.Generator(device=dev)
    gen.set_state(s.gen_state)
    params = {}
    for name, t in s.params0.items():
        parts = name.split("/")
        node = params.setdefault(parts[0], {})
        if len(parts) == 3:
            node = node.setdefault(parts[1], {})
        node[parts[-1]] = t
    return ref.train_steps(params, reference_frames(s), s.check_frames,
                           s.cfg, s.weights, s.w_l1, s.w_l2, s.lrs, gen, mm,
                           **kw)


def numbers(prog, refr, params0):
    """The numbers compared, or read where the cell's limits say so: the
    step losses' largest relative gap; the worst leaf's gap of the first
    gradient's norm (``grad_gap``) and of its difference (``grad_dev``,
    which sees a sign); the first gradient's deviation at the density
    head's weight, the one leaf whose gradient meets no ReLU mask and no
    L1 kink on its way back, so its deviation grows with the rounding
    itself; the worst leaf's gap of the change's norm after the first
    steps, over the leaves that the reference's gradient moves. PERF.md
    gives the readings and the limits."""
    p_loss, p_grad, p_after = prog
    r_loss, r_grad, r_after = refr
    keep = moving_leaves(r_grad)
    change_p = {k: p_after[k] - params0[k] for k in keep}
    change_r = {k: r_after[k] - params0[k] for k in keep}
    return {"loss_gap": loss_gap([x["loss"] for x in p_loss],
                                 [x["loss"] for x in r_loss]),
            "grad_gap": leaf_gap(p_grad, r_grad),
            "grad_dev": leaf_dev(p_grad, r_grad),
            "density_grad_dev": rel_dev(p_grad[DENSITY_W],
                                        r_grad[DENSITY_W]),
            "change_gap": leaf_gap(change_p, change_r)}


def compare(s, ctx, log):
    dev = ctx.device
    free_program(s, dev)
    prog = program_side(s)
    refr = reference_side(s, dev)
    log(f"losses: program {prog[0]} reference {refr[0]}")
    return numbers(prog, refr, s.params0)
