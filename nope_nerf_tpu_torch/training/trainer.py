"""Training step: render + all losses + the 4-group Adam update (port of
``nope_nerf_tpu/training/trainer.py``).

The parameters are one dict {'nerf', 'pose', 'focal', 'distortion'} of leaf
tensors, differentiated by one backward pass and updated by one
``torch.optim.Adam`` with a param group per top-level key. The frame
indices are host ints (the step-by-step path, which branches on them) or
int tensors on the device (:func:`make_epoch_step`, which selects the
frames by gathers and the frame-order swap and the pinned last scale by
``torch.where``, as the JAX step does on traced scalars). Random draws (ray
indices, stratified jitter) come from an explicit ``torch.Generator`` on
the tensors' device.

:func:`make_epoch_step` is the twin of the JAX ``make_epoch_step``: one
epoch of steps, which on the card are replays of one captured CUDA graph
of the step (``training/capture.py``).

Under a ray mesh (``parallel/mesh.py``) every rank draws and sets up the
whole batch, renders its block of the rays, and reads global loss values; the
step averages the ranks' gradients in one all-reduce before Adam, so the
parameters stay identical on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..geometry.rays import (camera_mat_from_fxfy, pixels_from_flat_idx,
                             rigid_inv)
from ..losses.losses import total_loss
from ..models.distortion import apply_distortion, distortion_scale_shift
from ..models.intrinsics import focal_fxfy
from ..models.pose import pose_c2w, take_rows
from ..ops.interp import resize_bilinear, resize_nearest
from ..ops.kernels.ref_pair import pair_spec, ref_pair
from ..ops.rendering import concat_rays, ray_setup, render_ray_batch
from ..parallel.mesh import (all_reduce_grads, shard_rays,
                             warm_up_collectives)
from .capture import StepGraphs, bound_tensors

GROUPS = ("nerf", "pose", "focal", "distortion")


def group_tensors(group_params):
    """The leaf tensors of one parameter group, in a fixed order."""
    if isinstance(group_params, dict):
        return [t for k in sorted(group_params)
                for t in group_tensors(group_params[k])]
    return [group_params]


class TrainState:
    """Parameters and their Adam optimiser (betas 0.9 / 0.999, eps 1e-8,
    one param group per top-level key; learning rates are set from the
    schedule by :func:`set_lrs`).

    With ``capturable`` (CUDA parameters only) the optimiser is
    ``Adam(capturable=True)``: its step counts live on the device and each
    group's learning rate is a 0-d device tensor, so that a CUDA graph of
    the step replays the update at the rates :func:`set_lrs` writes.
    """

    def __init__(self, params, capturable=False):
        self.params = params
        groups = []
        for g in GROUPS:
            ts = group_tensors(params[g])
            for t in ts:
                t.requires_grad_(True)
            lr = (torch.zeros((), dtype=torch.float32, device=ts[0].device)
                  if capturable else 0.0)
            groups.append({"params": ts, "name": g, "lr": lr})
        extra = {"capturable": True, "foreach": True} if capturable else {}
        self.optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999),
                                          eps=1e-8, **extra)


def init_train_state(params, capturable=False):
    return TrainState(params, capturable=capturable)


def set_lrs(optimizer, lrs):
    """Each param group's learning rate from ``lrs`` {group name: float},
    written into the group's tensor when it has one (a capturable Adam,
    whose graphs read that storage), else set as a float."""
    for group in optimizer.param_groups:
        lr = float(lrs[group["name"]])
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def sample_ray_idx(n_points, hw, fast_sampling, generator, device):
    """``n_points`` flat pixel indices of an (H, W) image: ``randint``
    with ``tpu.fast_ray_sampling``, else distinct pixels (``randperm``)."""
    H, W = hw
    if fast_sampling:
        return torch.randint(0, H * W, (n_points,), generator=generator,
                             device=device)
    return torch.randperm(H * W, generator=generator,
                          device=device)[:n_points]


def _sample_ray_idx(batch, n_points, H, W, fast_sampling, generator):
    dev = batch["imgs"].device
    if "ray_idx" in batch:
        # injected indices (parity harnesses) replace the random draw
        return batch["ray_idx"].to(dev).long()
    return sample_ray_idx(n_points, (H, W), fast_sampling, generator, dev)


def frame_rows(frames, f, flat_idx):
    """Rows ``flat_idx`` of frame ``f`` (a host int or a 0-d int tensor)
    of an (N, H, W[, C]) array, as one gather of ``frames`` viewed as
    (N * H * W[, C]): no frame is copied and no index read on the host."""
    n, h, w = frames.shape[:3]
    flat = frames.reshape((n * h * w,) + tuple(frames.shape[3:]))
    return flat[f * (h * w) + flat_idx]


def compute_loss(params, batch, scalars, *, cfg, static, init_c2w=None,
                 render_cfg, generator=None, mesh=None):
    """The loss of one step and its aux dict (the JAX ``compute_loss``).

    batch: imgs (N, H, W, 3), dpts (N, Hd, Wd), optional dpts_small /
    imgs_small, camera_mat_gt, scale_mat (4, 4) on the device; idx a host
    int, or k host ints with ``tpu.rays_per_step_multiplier`` k (a list or
    an array); ref_idx a host int; optional ray_idx (n,). scalars: weights
    (7 floats), w_l1, w_l2. static: render_model / use_ref / use_rgb_s
    booleans, and ``normal_diff``, which asks for ``rendering.normal_loss``'s
    output (aux ``normal_diff``): no loss reads it, so without the flag the
    render skips it, as XLA drops it from the JAX step.

    With k frames, each frame draws its own rays, pose, distortion and
    prior depths, and the k * n rays go through one render (one Kernel A
    launch on the fused path); frame 0 alone carries the reference-pair
    branch (pc, rgb_s), exactly as at k = 1.

    With ``mesh`` every rank draws the whole batch from its generator (all
    ranks' generators seeded alike), renders its block of the rays
    (:func:`..parallel.mesh.shard_rays`) and runs the Chamfer argmins on its
    query rows; the loss and aux values are global on every rank.
    """
    if torch.is_tensor(batch["idx"]):
        # device indices (the epoch step's): every frame is selected by a
        # gather on the device, and the frame order's swap by torch.where
        frames = batch["idx"].reshape(-1)
    else:
        frames = [int(i) for i in np.ravel(batch["idx"])]
    idx = frames[0]
    ref_idx = batch["ref_idx"]
    imgs, dpts = batch["imgs"], batch["dpts"]
    camera_mat_gt = batch["camera_mat_gt"]
    scale_mat = batch["scale_mat"]
    dev = imgs.device
    H, W = imgs.shape[1:3]
    hd, wd = dpts.shape[1:3]

    tcfg, pcfg, dcfg = cfg["training"], cfg["pose"], cfg["distortion"]
    tpu = cfg.get("tpu", {}) or {}
    n_points = tcfg["n_training_points"]
    num_cams = cfg["_num_cams"]
    learn_dist = dcfg["learn_distortion"]
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    def c2w_of(i):
        return pose_c2w(params["pose"], i, init_c2w, pcfg["learn_R"],
                        pcfg["learn_t"])

    def scale_shift(i):
        if not learn_dist:
            return (torch.ones(1, device=dev), torch.zeros(1, device=dev))
        return distortion_scale_shift(params["distortion"], i, num_cams,
                                      dcfg["fix_scaleN"], dcfg["learn_scale"],
                                      dcfg["learn_shift"])

    # ---- pose / distortion / intrinsics --------------------------------
    if pcfg["learn_pose"]:
        c2w = c2w_of(idx)
        world_mat = rigid_inv(c2w)
    else:
        c2w = world_mat = eye
    scale_input, shift_input = scale_shift(idx)
    aux = {}
    if pcfg["learn_focal"]:
        fxfy = focal_fxfy(params["focal"], fx_only=pcfg["fx_only"],
                          order=pcfg["focal_order"],
                          req_grad=pcfg["update_focal"])
        camera_mat = camera_mat_from_fxfy(fxfy)
        aux["focalx"] = fxfy[0] / camera_mat_gt[0, 0]
        aux["focaly"] = fxfy[1] / camera_mat_gt[1, 1]
    else:
        camera_mat = camera_mat_gt

    # ---- ray sampling + render (per frame) ------------------------------
    out = {}
    rgb_gt = n_rays = None
    if static["render_model"]:
        fast = tpu.get("fast_ray_sampling", True)
        add_noise = tpu.get("render_add_noise", True)
        rgb_gts, setups = [], []
        for j, f in enumerate(frames):
            # an injected ray_idx serves every frame (the JAX step closes
            # over it instead of vmapping it)
            r_idx = _sample_ray_idx(batch, n_points, H, W, fast, generator)
            rgb_gts.append(frame_rows(imgs, f, r_idx))
            p, rr, rc = pixels_from_flat_idx(r_idx, (H, W))
            if (hd, wd) == (H, W):
                didx = r_idx
            else:
                # resize_nearest's f32 index math, gathered at the sampled
                # rays
                drr = torch.floor(rr.to(torch.float32) * torch.tensor(
                    hd / H, dtype=torch.float32)).long()
                drc = torch.floor(rc.to(torch.float32) * torch.tensor(
                    wd / W, dtype=torch.float32)).long()
                didx = drr * wd + drc
            d_rays = frame_rows(dpts, f, didx)
            if j == 0:
                world_f, sc_f, sh_f = world_mat, scale_input, shift_input
            else:
                world_f = rigid_inv(c2w_of(f)) if pcfg["learn_pose"] else eye
                sc_f, sh_f = scale_shift(f)
            if learn_dist:
                d_rays = apply_distortion(d_rays, sc_f, sh_f,
                                          tcfg["shift_first"])
            setups.append(ray_setup(p, d_rays, camera_mat, world_f,
                                    scale_mat, render_cfg, generator=generator,
                                    add_noise=add_noise))
        # k frames' rays render as one batch: one Kernel A launch while
        # k * n * S <= n_max_network_queries (2**21 points by default, so
        # k <= 16 at the stock 1024 rays x 128 samples), chunks of that
        # size above it. The kernels count rows in 32-bit ints and address
        # them with 64-bit offsets, so what bounds k is memory: Kernel A's
        # forward saves ~5 KB per point (eight 256-wide bf16 activations,
        # the features, the encodings; 2.6 GB at k = 4).
        rgb_gt = torch.cat(rgb_gts)
        rays = setups[0] if len(setups) == 1 else concat_rays(setups)
        rcfg = render_cfg
        if rcfg.get("normal_loss", False) and not static.get("normal_diff"):
            rcfg = dict(rcfg, normal_loss=False)
        n_rays = rgb_gt.shape[0]
        if mesh is not None:
            rcfg = dict(rcfg, mesh=mesh)
            rgb_gt = shard_rays(rgb_gt, mesh)
        tracing.section("step.field")
        out = render_ray_batch(params["nerf"], rays, rcfg,
                               generator=generator, eval_mode=False)

    # ---- reference-image branch -------------------------------------------
    loss_kwargs = {}
    if static["use_ref"]:
        # clouds, rgb_s reprojection and band starts: one kernel each way on
        # the card (ops/kernels/ref_pair.py), the plain version on the CPU
        tracing.section("step.pair")
        c2w_ref = c2w_of(ref_idx)
        scale_ref, shift_ref = scale_shift(ref_idx)
        if tcfg["detach_ref_img"]:
            c2w_ref = c2w_ref.detach()
            scale_ref, shift_ref = scale_ref.detach(), shift_ref.detach()
        ratio = tcfg["pc_ratio"]
        sres = (int(hd / ratio), int(wd / ratio))

        def small_maps(key, full, resize):
            """The pair's rows of the scene's small maps, or its two frames
            resized."""
            if key in batch:
                return batch[key], idx, ref_idx
            return torch.stack([resize(take_rows(full, idx), sres),
                                resize(take_rows(full, ref_idx), sres)]), 0, 1

        images = (small_maps("imgs_small", imgs, resize_bilinear)
                  if static["use_rgb_s"] else None)
        loss_kwargs = ref_pair(
            small_maps("dpts_small", dpts, resize_nearest), images, idx,
            c2w, world_mat, c2w_ref, scale_input, shift_input, scale_ref,
            shift_ref, camera_mat,
            pair_spec(cfg, static["use_rgb_s"], sres))

    # ---- assemble -------------------------------------------------------
    tracing.section("step.loss")
    depth_gt = out.get("depth_gt")
    if static["render_model"] and tcfg["detach_gt_depth"]:
        depth_gt = depth_gt.detach()
    loss_dict = total_loss(
        scalars["weights"],
        rgb_pred=out.get("rgb"),
        rgb_gt=rgb_gt,
        depth_pred=out.get("depth_pred"),
        depth_gt=depth_gt,
        depth_valid=out.get("valid_mask"),
        t_list=params["pose"]["t"] if pcfg["learn_pose"] else None,
        w_l1=scalars["w_l1"],
        w_l2=scalars["w_l2"],
        with_ssim=tcfg["with_ssim"],
        depth_loss_type=tcfg["depth_loss_type"],
        use_pallas_chamfer=use_chamfer_kernels(cfg, dev),
        chamfer_mode=tpu.get("chamfer_mode", "exact"),
        chamfer_window=tpu.get("chamfer_window", 512),
        chamfer_auto_costs=(tpu.get("chamfer_auto_exact_ms_per_pair"),
                            tpu.get("chamfer_auto_grid_ms_per_point")),
        with_auto_mask=tcfg.get("with_auto_mask", False),
        mesh=mesh,
        n_rays=n_rays,
        **loss_kwargs,
    )
    aux.update(loss_dict)
    # copies: a view of the distortion parameters would read the values
    # after the optimiser step, where the JAX step reports the ones that
    # the loss used
    aux["scale"] = scale_input[0].clone()
    aux["shift"] = shift_input[0].clone()
    if out.get("normal_diff") is not None:
        aux["normal_diff"] = out["normal_diff"]
    if static.get("pair_images", False) and "rgb_pc1" in loss_kwargs:
        # the reprojection pair of the vis_reprojection_every dumps
        aux["rgb_pc1"] = loss_kwargs["rgb_pc1"]
        aux["rgb_pc1_proj"] = loss_kwargs["rgb_pc1_proj"]
    return loss_dict["loss"], aux


def make_step_body(cfg, render_cfg, init_c2w=None, mesh=None):
    """body(state, batch, scalars, static, generator) -> (loss, aux): one
    loss + backward + Adam update, in place on ``state``, at the learning
    rates the optimiser holds (:func:`set_lrs`). The step of
    :func:`make_train_step` and of :func:`make_epoch_step`.

    Every parameter gets a gradient (zeros where the loss does not reach
    it), so Adam's moments and step counts advance for all of them as
    optax's do; weight decay is added to the nerf gradient only, before
    Adam, as torch's ``weight_decay`` would, on every step when
    ``training.weight_decay`` > 0, as the JAX step does: on a step that does
    not render (``static["render_model"]`` False) the nerf gradient is
    zero and the decay alone moves the nerf parameters.

    With ``mesh`` (``parallel/mesh.py``) each rank computes the loss on its
    rows and the ranks' gradients are averaged in one all-reduce before
    weight decay and Adam, which then leave the parameters identical on
    every rank.

    With ``tpu.debug_nans`` the loss and backward run under
    ``torch.autograd.detect_anomaly(check_nan=True)``, and a loss or
    gradient (after the all-reduce) that is not finite raises
    ``FloatingPointError`` before the update.
    """
    wd = cfg["training"].get("weight_decay", 0.0) or 0.0
    debug_nans = bool((cfg.get("tpu", {}) or {}).get("debug_nans", False))

    def loss_and_grads(state, batch, scalars, static, generator):
        loss, aux = compute_loss(state.params, batch, scalars, cfg=cfg,
                                 static=static, init_c2w=init_c2w,
                                 render_cfg=render_cfg, generator=generator,
                                 mesh=mesh)
        tracing.section("step.backward")
        loss.backward()
        return loss, aux

    def checked_loss_and_grads(state, batch, scalars, static, generator):
        with torch.autograd.detect_anomaly(check_nan=True):
            try:
                return loss_and_grads(state, batch, scalars, static,
                                      generator)
            except RuntimeError as e:
                if "nan values" not in str(e):
                    raise
                raise FloatingPointError(str(e)) from e

    def check_finite(loss, opt):
        bad = [] if torch.isfinite(loss) else ["loss"]
        for group in opt.param_groups:
            bad += [f"{group['name']} gradient" for p in group["params"]
                    if not torch.isfinite(p.grad).all()]
        if bad:
            raise FloatingPointError("not finite: " + ", ".join(
                dict.fromkeys(bad)))

    run = checked_loss_and_grads if debug_nans else loss_and_grads

    def body(state, batch, scalars, static, generator=None):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, aux = run(state, batch, scalars, static, generator)
        tracing.section("step.update")
        with torch.no_grad():
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            all_reduce_grads([p.grad for g in opt.param_groups
                              for p in g["params"]], mesh)
            if debug_nans:
                check_finite(loss, opt)
            if wd > 0.0:
                # wd is a config value every rank shares, so the ranks
                # stay equal
                for group in opt.param_groups:
                    if group["name"] == "nerf":
                        for p in group["params"]:
                            p.grad.add_(p, alpha=wd)
        opt.step()
        return loss, {k: v.detach() if torch.is_tensor(v) else v
                      for k, v in aux.items()}

    return body


def make_train_step(cfg, render_cfg, init_c2w=None, mesh=None):
    """step(state, batch, scalars, static, generator) -> (state, aux): the
    learning rates of ``scalars["lrs"]``, then one step of
    :func:`make_step_body`."""
    body = make_step_body(cfg, render_cfg, init_c2w, mesh)

    def step(state, batch, scalars, static, generator=None):
        set_lrs(state.optimizer, scalars["lrs"])
        _, aux = body(state, batch, scalars, static, generator)
        return state, aux

    return step


def scan_route(cfg, device, mesh=None):
    """(route, why) of :func:`make_epoch_step` on ``device``: ("cuda
    graph", None), or ("eager", the reason no graph is captured)."""
    if torch.device(device).type != "cuda":
        return "eager", "CPU tensors"
    if (cfg.get("tpu", {}) or {}).get("debug_nans", False):
        return "eager", "tpu.debug_nans: anomaly mode cannot be captured"
    if mesh is not None and mesh.backend != "nccl":
        return "eager", f"{mesh.backend} collectives cannot be captured"
    return "cuda graph", None


def upload_ints(dst, array):
    """Copy the host int ``array`` into the int64 buffer ``dst`` without
    waiting for the device (a pinned staging copy on CUDA)."""
    src = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class EpochStep:
    """One epoch of steps of :func:`make_step_body` (the JAX
    ``make_epoch_step``'s ``lax.scan``); made by :func:`make_epoch_step`.

    ``route`` is "cuda graph" (each step of the epoch is a replay of the
    step captured for its key by :class:`.capture.StepGraphs`, the key's
    first step being its eager warm-up) or "eager" (the same body run
    ``n`` times; ``why`` says why). The step reads its frames, reference
    frames, loss weights and rgb weights from device buffers filled once
    per epoch, outside the graph, and its learning rates from the
    optimiser's tensors (:func:`set_lrs`); a device counter, which the step
    advances, selects row i of the epoch's (n, k) frame indices and writes
    the step's aux scalars into row i of an (n, n_aux) buffer. One buffer
    set per (static flags, n, k), as the JAX package traces per ``static``.
    ``steps`` holds the last epoch's per-step aux values. A graph replays
    on the state, scene arrays and generator of its capture: a call with
    others raises.

    Each call is one ``tracing`` dispatch of phase "train" (its record in
    ``last_dispatch``: the call's device time without waiting for it),
    with the host spans ``dispatch.upload``, ``dispatch.scalars``,
    ``dispatch.replay`` (one per replay) and ``dispatch.snapshot``; the
    step marks the sections ``step.rays``, ``step.field``, ``step.pair``,
    ``step.loss``, ``step.backward`` (with ``step.backward.field`` inside:
    Kernel A's backward), ``step.update`` and ``step.aux``.
    """

    def __init__(self, cfg, render_cfg, init_c2w, mesh, device, eager):
        self.body = make_step_body(cfg, render_cfg, init_c2w, mesh)
        self.device = torch.device(device)
        self.route, self.why = scan_route(cfg, self.device, mesh)
        if eager and self.route != "eager":
            self.route, self.why = "eager", "eager=True"
        if self.route == "cuda graph":
            warm_up_collectives(mesh)
        self.graphs = StepGraphs(self.device, eager=self.route == "eager",
                                 phase="train")
        self.bufs = {}
        self.scalars = None
        self.counter = None
        self.steps = None
        self.last_dispatch = None

    def _fill_scalars(self, scalars, dev):
        """The loss weights and rgb weights as 0-d device tensors (made once,
        then written in place)."""
        if self.scalars is None:
            def zero():
                return torch.zeros((), dtype=torch.float32, device=dev)

            self.scalars = {"weights": {k: zero() for k in scalars["weights"]},
                            "w_l1": zero(), "w_l2": zero()}
            self.counter = torch.zeros((), dtype=torch.long, device=dev)
        for k, t in self.scalars["weights"].items():
            t.fill_(float(scalars["weights"][k]))
        self.scalars["w_l1"].fill_(float(scalars["w_l1"]))
        self.scalars["w_l2"].fill_(float(scalars["w_l2"]))
        return self.scalars

    def __call__(self, state, scene_arrays, idxs, ref_idxs, scalars,
                 generator, static):
        idxs, ref_idxs = np.asarray(idxs), np.asarray(ref_idxs)
        n = idxs.shape[0]
        k = 1 if idxs.ndim == 1 else idxs.shape[1]
        dev = scene_arrays["imgs"].device
        if not same_device(dev, self.device):
            raise ValueError(f"an epoch step made for {self.device} given "
                             f"scene arrays on {dev}")
        key = (tuple(sorted(static.items())), n, k)
        with tracing.dispatch("train", n, dev) as rec:
            aux_mean, aux_last = self._epoch(key, state, scene_arrays, idxs,
                                             ref_idxs, scalars, generator,
                                             static)
        self.last_dispatch = rec
        return state, aux_mean, aux_last

    def _epoch(self, key, state, scene_arrays, idxs, ref_idxs, scalars,
               generator, static):
        n, dev = idxs.shape[0], scene_arrays["imgs"].device
        with tracing.span("dispatch.upload"):
            buf = self.bufs.get(key)
            if buf is None:
                buf = self.bufs[key] = {
                    "idxs": torch.zeros(idxs.shape, dtype=torch.long,
                                        device=dev),
                    "refs": torch.zeros((n,), dtype=torch.long, device=dev)}
            upload_ints(buf["idxs"], idxs)
            upload_ints(buf["refs"], ref_idxs)
        with tracing.span("dispatch.scalars"):
            sc = self._fill_scalars(scalars, dev)
            set_lrs(state.optimizer, scalars["lrs"])
            counter = self.counter
            counter.zero_()

        def one():
            tracing.section("step.rays")
            i = counter.reshape(1)
            batch = dict(scene_arrays,
                         idx=buf["idxs"].index_select(0, i)[0],
                         ref_idx=buf["refs"].index_select(0, i)[0])
            _, aux = self.body(state, batch, sc, static, generator)
            tracing.section("step.aux")
            if "aux" not in buf:  # the key's first step, never captured
                buf["keys"] = [a for a in sorted(aux) if torch.is_tensor(
                    aux[a]) and aux[a].dim() == 0]
                buf["aux"] = torch.zeros((n, len(buf["keys"])),
                                         dtype=torch.float32, device=dev)
            row = torch.stack([aux[a].float() for a in buf["keys"]])
            buf["aux"].index_copy_(0, i, row[None])
            counter.add_(1)

        self.graphs.run(
            key, one, n, () if generator is None else (generator,),
            lambda: bound_tensors(state.params, state.optimizer,
                                  scene_arrays))
        # copies made on the device after the epoch's steps and before any
        # later epoch's: a caller may read them while the next epoch runs
        with tracing.span("dispatch.snapshot"):
            snap = buf["aux"].clone()
            cols = {a: j for j, a in enumerate(buf["keys"])}
            mean = snap.mean(0)
            aux_mean = {a: mean[j] for a, j in cols.items()}
            aux_last = {a: snap[-1, j] for a, j in cols.items()}
            aux_last["scale_steps"] = snap[:, cols["scale"]]
            aux_last["shift_steps"] = snap[:, cols["shift"]]
            self.steps = {a: snap[:, j] for a, j in cols.items()}
        return aux_mean, aux_last


def same_device(a, b):
    """Whether devices ``a`` and ``b`` are one (a CUDA device without an
    index is the current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def make_epoch_step(cfg, render_cfg, init_c2w=None, mesh=None, device=None,
                    eager=False):
    """The twin of the JAX ``make_epoch_step``: run(state, scene_arrays,
    idxs, ref_idxs, scalars, generator, static) -> (state, aux_mean,
    aux_last), one epoch of steps in place on ``state``.

    idxs (n,) or (n, k) and ref_idxs (n,) are the epoch's frame order and
    reference frames (host arrays); scalars the epoch's weights, w_l1, w_l2
    and lrs. aux_mean holds the mean over the epoch of each scalar aux
    value, aux_last the last step's and ``scale_steps`` / ``shift_steps``
    (n,). All are device tensors computed after the epoch's steps, so they
    can be read while the next epoch runs. Weight decay applies on every
    step, as in :func:`make_train_step`.

    ``device`` is the device of the scene arrays and the state (the mesh's
    when there is one; a call on another raises). On a CUDA device each
    step is a replay of one captured graph of the step
    (:class:`EpochStep`), unless ``tpu.debug_nans`` or a gloo mesh asks for
    eager steps (:func:`scan_route`) or ``eager`` does (the reference
    route); ``.route`` says which. The state must then have a capturable
    Adam (``init_train_state(params, capturable=True)``).
    """
    if device is None:
        if mesh is None:
            raise ValueError("make_epoch_step needs the device of the scene "
                             "arrays and the state")
        device = mesh.device
    return EpochStep(cfg, render_cfg, init_c2w, mesh, device, eager)


def use_chamfer_kernels(cfg, device):
    """Kernels B / D run the pc loss's argmins on CUDA unless
    ``tpu.use_pallas: False`` opts out to their plain versions."""
    return (bool((cfg.get("tpu", {}) or {}).get("use_pallas", True))
            and torch.device(device).type == "cuda")


def describe_routes(cfg, render_cfg, device, n_pc, mesh=None):
    """One line naming the Chamfer mode and the MLP route a run resolves
    to, for clouds of ``n_pc`` points each, and the mesh when there is
    one."""
    from ..ops.chamfer import resolve_chamfer_mode

    tpu = cfg.get("tpu", {}) or {}
    on_cuda = torch.device(device).type == "cuda"
    asked = tpu.get("chamfer_mode", "exact")
    mode = resolve_chamfer_mode(
        asked, n_pc, n_pc, n_devices=mesh.size if mesh is not None else 1,
        sharded_exact=use_chamfer_kernels(cfg, device) and mesh is not None,
        hints_available=asked in ("band", "auto"),
        exact_ms_per_pair=tpu.get("chamfer_auto_exact_ms_per_pair"),
        grid_ms_per_point=tpu.get("chamfer_auto_grid_ms_per_point"))
    if mode == "grid":
        chamfer = "plain PyTorch Morton windows"
    else:
        kernel = {"band": "Kernel B", "exact": "Kernel D"}[mode]
        chamfer = (kernel if use_chamfer_kernels(cfg, device) else
                   f"plain version of {kernel} ("
                   + ("tpu.use_pallas: False" if on_cuda else "CPU") + ")")
    if render_cfg.get("use_pallas_mlp", False):
        kernel = ("Kernel A (MLP + compositing)"
                  if render_cfg.get("fuse_compositing", False) else
                  "Kernel C (per-point MLP) + plain compositing")
        mlp = kernel if on_cuda else f"plain version of {kernel} (CPU)"
    else:
        mlp = ("plain torch.matmul MLP, "
               + ("bf16 operands" if render_cfg.get("mlp_bf16") else "f32"))
    line = (f"chamfer_mode {asked} -> {mode} on {n_pc}-point clouds: "
            f"{chamfer}; MLP: {mlp}")
    if mesh is not None:
        line += (f"; rays sharded over {mesh.size} ranks ({mesh.backend}, "
                 f"axis {mesh.axis_name!r})")
    return line


def make_render_cfg(cfg, device):
    """Merge the rendering + model groups for ``render_rays``.

    ``tpu.use_pallas_mlp`` (Kernel A, or Kernel C with
    ``tpu.fuse_compositing: False``) and ``tpu.mlp_bf16`` default to True
    for CUDA tensors and False for CPU ones; ``tpu.n_max_network_queries``
    defaults to 2**21 points.
    """
    tpu = cfg.get("tpu", {}) or {}
    on_cuda = torch.device(device).type == "cuda"
    rc = dict(cfg["rendering"])
    rc.update({
        "occ_activation": cfg["model"]["occ_activation"],
        "pos_enc_levels": cfg["model"]["pos_enc_levels"],
        "dir_enc_levels": cfg["model"]["dir_enc_levels"],
        "hidden_dim": cfg["model"]["hidden_dim"],
        "n_max_network_queries": tpu.get("n_max_network_queries", 2 ** 21),
        "mlp_bf16": tpu.get("mlp_bf16", on_cuda),
        "use_pallas_mlp": tpu.get("use_pallas_mlp", on_cuda),
        "fuse_compositing": tpu.get("fuse_compositing", True),
    })
    return rc
