"""Test-time pose optimisation traffic: ``evaluation/pose_opt.py``'s
``PoseOptBlock`` over the held-out views of a frozen, seeded field, in
blocks of ``block_epochs`` epochs at the schedule of ``opt_pose_epoch``
epochs (MultiStepLR, gamma 0.5 at fifths) from ``opt_eval_lr``. When the
schedule ends it restarts on fresh poses and a fresh Adam state. Each
block's losses are read one block behind (a closed loop).

Set-up builds one block (the pose table, its Adam, the captured step, the
generator) and drives it through the window's first block: its eager
first step, the capture of the graph that the window replays, and the
replays. After its first epoch, one visit of each view at its initial
pose, set-up copies the table and Adam's first moment, from
which each view's first gradient follows. The table and Adam then restart
for the window. The comparison holds those steps' losses, the views'
first gradients (the output of Kernel A's input-only backward, carried to
r and t) and the table's change to the plain reference.

Mix keys: ``driver`` "pose_opt", ``block_epochs``, ``trace_dispatches``,
``probe_iters``.
"""
from __future__ import annotations

import bisect
import copy
import time

import numpy as np
import torch

from benchmark import counts, scene as scenes
from benchmark.drivers.common import (HostCopy, WindowOut, finite,
                                      gap_spread, idle_host_spans,
                                      leaf_dev, leaf_gap, print_quarters,
                                      release, rms_gap, stops_after)
from benchmark.drivers.train import mlp_probe
from benchmark.profiling import annotate, profile_slice
from benchmark.reference import nerf as ref


def lr_schedule(num_epoch, lr):
    """The per-epoch rate of MultiStepLR(milestones=range(0, E, E // 5),
    gamma=0.5), stepped once per epoch."""
    milestones = list(range(0, int(num_epoch), max(int(num_epoch / 5), 1)))
    return np.array([lr * 0.5 ** bisect.bisect_right(milestones, e)
                     for e in range(num_epoch)], np.float32)


class State:
    pass


def setup(ctx):
    from nope_nerf_tpu_torch.evaluation.pose_opt import (PoseOptBlock,
                                                         pose_optimizer)
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    dev, cfg = ctx.device, copy.deepcopy(ctx.cfg)
    s = State()
    s.cfg = cfg
    s.scene = sc = scenes.Scene(ctx.config["scene"], ctx.seed, dev)
    ecfg = cfg["eval_pose"]
    s.n_points = ecfg["n_points"]
    s.rays_per_step = s.n_points
    s.nerf = scenes.field_weights(cfg["model"], ctx.seed, dev)
    s.init_c2w = sc.eval_c2ws
    s.render_cfg = make_render_cfg(cfg, dev)
    s.eye = torch.eye(4, device=dev)  # the scale matrix the graph binds
    s.pose = {"r": torch.zeros((sc.n_eval, 3), device=dev),
              "t": torch.zeros((sc.n_eval, 3), device=dev)}
    for t in s.pose.values():
        t.requires_grad_(True)
    s.opt = pose_optimizer(s.pose, dev.type == "cuda")
    s.block = PoseOptBlock(cfg, s.render_cfg, s.init_c2w, s.n_points,
                           (sc.H, sc.W), dev)
    s.gen = scenes.seeded(ctx.seed, scenes.STREAM_STEP, dev)
    s.gen_state = s.gen.get_state()
    s.lrs_epoch = lr_schedule(ecfg["opt_pose_epoch"], ecfg["opt_eval_lr"])
    s.epochs = ecfg["opt_pose_epoch"]
    s.block_epochs = ctx.mix["block_epochs"]
    s.epoch_at = 0

    k = sc.n_eval  # one visit of each view
    frames = np.tile(np.arange(sc.n_eval), s.block_epochs)
    lrs = np.repeat(s.lrs_epoch[:s.block_epochs], sc.n_eval)
    s.check_steps = [(int(f), float(lr)) for f, lr in zip(frames[:k],
                                                          lrs[:k])]

    def after_check():
        s.pose_k = {n: t.detach().clone() for n, t in s.pose.items()}
        # a leaf that Adam never stepped reads NaN
        s.moment1 = {n: s.opt.state[t].get(
            "exp_avg", torch.full_like(t, float("nan"))).detach().clone()
            for n, t in s.pose.items()}

    with stops_after({k: after_check}):
        losses = s.block(s.nerf, s.pose, s.opt, sc.eval_imgs, sc.K, s.eye,
                         lrs, frames, s.gen)
    s.check_losses = losses[:k].tolist()
    restart(s)
    return s


def restart(s):
    """Fresh poses and a fresh Adam state, in place (the captured step
    reads these tensors)."""
    with torch.no_grad():
        for t in s.pose.values():
            t.zero_()
        for st in s.opt.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()
    s.epoch_at = 0


def dispatch(s, epochs=None):
    """Queue one block of the schedule (of ``epochs`` epochs, the mix's
    block when None); returns the copy of its losses and its steps."""
    if s.epoch_at >= s.epochs:
        restart(s)
    b0 = s.epoch_at
    b1 = min(b0 + (epochs or s.block_epochs), s.epochs)
    sc = s.scene
    losses = s.block(s.nerf, s.pose, s.opt, sc.eval_imgs, sc.K, s.eye,
                     np.repeat(s.lrs_epoch[b0:b1], sc.n_eval),
                     np.tile(np.arange(sc.n_eval), b1 - b0), s.gen)
    s.epoch_at = b1
    return HostCopy(losses), (b1 - b0) * sc.n_eval


def window(s, ctx, t_start):
    dev = ctx.device
    clock = {"deadline": None}
    run = {"steps": 0, "timed": 0, "failed": 0, "prev": None, "marks": []}

    def read_prev():
        cp, n = run["prev"]
        if not all(finite(float(x)) for x in cp.wait()):
            run["failed"] += n

    def loop(max_dispatches, traced):
        done = 0
        while done < max_dispatches and (
                traced or time.perf_counter() < clock["deadline"]):
            with annotate("bench.dispatch", traced):
                cp, n = dispatch(s)
            if run["prev"] is not None:
                with annotate("bench.loss_read", traced):
                    read_prev()
                if not traced:
                    run["marks"].append((time.perf_counter(), run["timed"]))
            run["prev"] = (cp, n)
            run["steps"] += n
            run["timed"] += 0 if traced else n
            done += 1

    readings = {"phase": "pose_opt"}
    if ctx.trace:
        n_tr = ctx.mix["trace_dispatches"]
        before = run["steps"]
        readings["slice"] = profile_slice(lambda: loop(n_tr, True), dev)
        readings["slice_steps"] = run["steps"] - before
    # the timed window starts after a traced run's profiled slice, whose
    # trace is reduced before the clock starts
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    clock["deadline"] = t0 + ctx.seconds
    loop(float("inf"), False)
    read_prev()
    wall = time.perf_counter() - t0
    run["marks"].append((t0 + wall, run["timed"]))
    print_quarters(run["marks"], t0, wall, s.rays_per_step)
    readings["step_wall_s"] = wall / run["timed"]
    readings["model_flops_per_step"] = counts.mlp_flops(
        s.cfg["model"], s.rays_per_step * s.cfg["rendering"]["num_points"],
        "pose_opt")
    e2e = {"pose_opt_rays_per_s": run["timed"] * s.rays_per_step / wall,
           "setup_s": setup_s}
    return WindowOut(e2e, run["steps"], run["failed"], readings)


def probe(s, ctx):
    return {"mlp": mlp_probe(s, ctx.device, s.n_points, "pose_opt",
                             ctx.mix["probe_iters"]),
            # one epoch a call: a whole block's launches would fill the
            # device's queue and wait for room even from an idle start
            "host_spans": idle_host_spans(lambda: dispatch(s, 1),
                                          ctx.device)}


def reference_side(s, dev, mm=ref.mm_f32, **kw):
    gen = torch.Generator(device=dev)
    gen.set_state(s.gen_state)
    sc = s.scene
    zero = {k: torch.zeros_like(v) for k, v in s.pose_k.items()}
    return ref.pose_steps(s.nerf, zero, s.init_c2w, sc.eval_imgs, sc.K,
                          s.check_steps, s.cfg, s.n_points, gen, mm, **kw)


def first_gradients(s):
    """Each view's first gradient, from Adam's first moment after the check
    steps: a view visited once, at step j of k, holds 0.1 g 0.9^(k-1-j),
    as its gradient is nought at the other steps."""
    k = len(s.check_steps)
    scale = torch.ones(s.scene.n_eval, dtype=torch.float64)
    for j, (f, _) in enumerate(s.check_steps):
        scale[f] = 0.1 * 0.9 ** (k - 1 - j)
    return {n: (m.double() / scale.to(m.device)[:, None]).float()
            for n, m in s.moment1.items()}


def numbers(prog, refr):
    """The numbers compared: over the first steps' losses, the root mean
    square of their relative gaps (``loss_rms_gap``) and the spread of
    those gaps about their mean (``loss_spread``, the population standard
    deviation: the field's weights rounded to bf16 shift every view's loss
    alike, by a seed's own amount, and the spread leaves that offset out);
    over the views' first gradients, the worst of r and t by the gap of
    their norms (``grad_gap``) and by their difference (``grad_dev``,
    which sees a sign); and the worst leaf's gap of the table's change."""
    p_loss, p_grad, p_after = prog
    r_loss, r_grad, r_after = refr
    return {"loss_rms_gap": rms_gap(p_loss, r_loss),
            "loss_spread": gap_spread(p_loss, r_loss),
            "grad_gap": leaf_gap(p_grad, r_grad),
            "grad_dev": leaf_dev(p_grad, r_grad),
            "change_gap": leaf_gap(p_after, r_after)}


def compare(s, ctx, log):
    dev = ctx.device
    for name in ("block", "opt", "pose"):
        if hasattr(s, name):
            delattr(s, name)
    release(dev)
    prog = (list(s.check_losses), first_gradients(s), dict(s.pose_k))
    refr = reference_side(s, dev)
    log(f"losses: program {prog[0]} reference {refr[0]}")
    return numbers(prog, refr)
