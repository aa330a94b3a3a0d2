#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nope_nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --gate-control   # the PSNR gate's control only
    python3 chip_smoke.py --recovery-control   # the ATE gate's control only
    python3 chip_smoke.py --fwd-turns OTHER.cu   # the fused forward against another source
    python3 chip_smoke.py --input-bwd   # the input-only backward's phase only

Builds the port's CUDA kernels from ``nope_nerf_tpu_torch/csrc``, holds each
of the six kernels against its plain PyTorch version at the shapes of the
training step (A: fused MLP + compositing, fwd and bwd; B: banded Chamfer;
C: per-point fused MLP, fwd and bwd; D: exact Chamfer). A-fwd and C-fwd are
one launch each of ``csrc/mlp_fused_fwd.cu``: their outputs against the
plain version, and the 13 tensors a saving forward stores for the backward
against the plain chain's within SAVES_RELL2 (tests/_mlp_saves.py; at the
stock shapes, and for A also on the raw route of an S that does not tile
128 points, where ``composite_fwd`` runs after it); each forward is timed
beside the plain version (CUDA events and the profiler's device time) at
the stock shapes, without saves, at k = 4 frames and at the recovery
scripts' width (hidden 128, 64 samples). B's split-band kernel must return
the plain version's indices bit for bit, on the stock pair and at every
recorded call of the training phases, and is timed beside it (events and
device time); D's device time stands beside its events time. A-bwd and
C-bwd run ten passes of ``csrc/mlp_fused_bwd.cu`` (each layer's input and
weight gradient in one pass): at the same three shapes their gradients are
held against the plain version (GRAD_RELL2), a rerun must be bitwise, and
each backward is timed beside the plain version with the kernels it
launches per call and its memory floor. Then it runs the fused backward
pass phase (each pass of the backward at M = 131,072 against
``gemm_dwgrad_reference``, bitwise rerun, device time beside the plain
version and the memory bound), the input-only backward phase
(``check_input_bwd``: one launch of ``csrc/mlp_input_bwd.cu`` at the pose
step's shape and the recovery width on a fused forward's saves, its three
encoding cotangents bit for bit those of the ten-pass input-only chain, a
rerun bitwise, timed in turns with the ten passes beside its bound and the
plain version; ``--input-bwd`` runs this phase alone), the compositing /
encoding backward phase
(Kernel A's ``composite_bwd`` and ``encode_bwd`` at the stock shapes, k = 4
and the recovery width, on the inputs a full and an input-only backward
give them: a rerun bit for bit, within A_BWD_PLAIN_RELL2 of their plain
versions, each timed alone beside its plain version and its bound; the
whole A-bwd, full and input-only, timed, its launches counted and its
device time split by kernel), the reference pair phase
(``check_ref_pair``: ``csrc/ref_pair.cu`` against its plain version at
Tanks' and LLFF's cloud grids in every PAIR_CASES case, outputs, start
tiles and every input gradient within PAIR_BARS, a rerun bitwise, forward
+ backward timed in turns with the plain version, the step's tensor code it
replaced), then trains six configurations at full width for two epochs of eight
steps each on an in-memory 8-frame 540x960 scene with random weights and a
smooth camera trajectory, through ``train()``, the first five on the stock
config's scan path (``tpu.epoch_scan``: each epoch's steps replays of one
captured CUDA graph of the step after its eager warm-up step):

* stock ``configs/default.yaml`` (1024 rays x 128 samples, 8 x 256 MLP,
  pc + rgb_s losses, banded Chamfer): Kernels A and B, and Kernel C's
  forward for the surface colour of the Phong preview that the stock
  ``visualize_every`` draws at the end of the first epoch;
* stock with ``tpu.fuse_compositing: False, chamfer_mode: exact``: Kernels
  C and D;
* ``tpu.parity: True`` (f32 unfused MLP on torch.matmul, exact Chamfer,
  randperm ray sampling): Kernel D;
* stock with ``tpu.rays_per_step_multiplier: 4``: four frames' 4,096 rays
  per step through one Kernel A launch each way, whose last eager
  training call (the warm-up step's inputs, and the cotangents its loss
  gave it) is held against the plain version;
* stock with ``training.with_ssim`` and ``rendering.normal_loss``: then one
  more step's normal_diff and SSIM-map gradient against float64 on the
  card, and the step timed without and with the normal term (which no loss
  reads, so the trainer skips it);
* the multiplier run with ``tpu.epoch_scan: False``: the loop's per-step
  path (host-int frame indices, per-step triggers), Kernel A's last
  training call held against the plain version likewise;

and checks that each run went through every kernel it should reach
(launches run: eager calls plus each captured graph's launches times its
replays; the
fused forward once per forward of A or C, the fused backward pass 10 times
per backward, the launches that serve only the weight gradients twice (A)
or once (C) per backward that needs them; Kernel A once each way, its
compositing and encoding backward once each, and Kernel B twice in every
training step of the runs on Kernel A) and prints the last epoch's
ms/step (wall on the host clock, and device) and rays/s of stock,
multiplier, ssim_normal and multiplier_per_step side by side.

The scan phase (:func:`run_scan`) holds ``make_epoch_step``'s captured
route to its eager route (the same step body, step by step) in the five
training configurations: 2 epochs of 8 steps each from the same
parameters, Adam state and generator state, the per-step losses, the
parameters and Adam's moments after them bit for bit, one graph per run
with Kernel A once each way and B twice (C once each way and D twice; D
twice under parity) per replay; the multigpu phase adds the
stock run under a one-rank NCCL mesh, its all-reduces captured. It times
each route's wall and device ms per
step; holds the pose-optimisation block captured against eager over 5 pose
epochs and times a 50-step block by each route; and runs the bench entry
at ``bench.py``'s layout (2 + 3 dispatches of 192 steps) for k = 1 and 4.

The stock run writes its checkpoints and per-epoch pose metrics; the eval phase
then restores them into fresh tensors (bit for bit), runs the eval CLI's
``main`` on the held-out view (test-time pose optimisation on Kernel A's
input-only backward, the 540x960 render through Kernel A's forward, PSNR /
SSIM, PNGs and video), checks its launch counts (Kernel A both ways, no
weight-gradient launch, no other kernel), renders a 135x240 view through
Kernel A and through its plain version, holds the input-only backward
bitwise to the full one, and times the render (through the fused forward)
and a pose-optimisation step with each backward. The eval scores LPIPS
with seeded VGG16 and head weights in the published layouts, converted by
``python -m nope_nerf_tpu_torch.convert_lpips`` (finite; one 540x960 pair held to
float64 on the card within LPIPS_REL, which the same pair with TF32 on must
exceed, and timed), and the stock run's parameters, written as
the reference's four ``.pt`` streams and converted by ``python -m
nope_nerf_tpu_torch.convert_reference``, must come back bit for bit.

The DPT phase writes a 4-frame 540x960 scene in the LLFF layout, converts
a seeded checkpoint with the published DPT-hybrid keys and shapes with
``python -m nope_nerf_tpu_torch.convert_dpt``, runs ``python -m
nope_nerf_tpu_torch.dpt_depth`` on it (4 priors of 384x672, finite and
positive, and 4 PNGs), holds frame 0's depth from ``dpt_depth.depth_batch``
(the CLI's batch function, which the benchmark's depth-prior cell times)
against the network in float64 on the card (relL2 DPT_RELL2, which the
same run with TF32 on must exceed), times a batch of ``depth_batch`` a
frame and reads the peak memory, then loads the scene with
the port's ``get_scene`` (the priors feed it) and trains the stock config
on it for 2 epochs, checking Kernels A and B launched and holding Kernel
B's last two eager calls (clouds from the 384x672 priors) and Kernel C's
forward at the first epoch's visualisation against their plain versions at
those inputs.

The multigpu phase (``tpu.n_devices > 1``, ``nope_nerf_tpu_torch/parallel``)
runs the stock step under a mesh of one rank over NCCL, which must equal the
unsharded step bit for bit, then two ranks in two worker processes (NCCL on
two cards when there are two, else both on card 0 over gloo): each rank's
rgb and depth rows, its loss and its averaged gradients against the
one-process step at the same global batch, the ranks' parameters bitwise
equal after MG_STEPS steps, Kernel A once each way on 512 rays and Kernel B
twice per step on each rank, both held against their plain versions at each
rank's inputs; one step on the route of Kernels C and D (MG_UNFUSED) held
to the one-process step likewise, C once each way and D twice per rank, C's
forward and D's sweeps against their plain versions; a two-rank
``train()`` (rank 0 writing the visualisation, the pair dump and the
checkpoints) and ``dpt_depth`` on two ranks against one device (the DPT
phase's converted weights, on MG_DPT_FRAMES frames).

The synthetic phase then writes the teacher scene of
``utils/synthetic.py`` to disk with the port's dataset writer, trains the
stock widths on it through ``train()`` (the scene read back by
``get_scene``, gt poses fixed) with the visualisation and the
reprojection-pair dumps on, and requires the last epoch's PSNR to beat the
first's by SYN_PSNR_GAIN dB and its last SYN_TAIL epochs to average
SYN_PSNR_TAIL dB; checks the
``rendering/`` tree and the launch counts (Kernel A both ways, the Chamfer
kernel ``auto`` resolves to, and Kernel C's forward, which the Phong
preview's surface colour runs as the JAX package's fused MLP does); runs
the render CLI (interp, SYN_NOVEL views, the geo pass: Kernel A's forward
once per view at least), the ``vis_poses`` and ``eval_poses --vis`` CLIs
and two short runs of the bench entry (k = 1 and k = 4 frames per
step), whose JSON lines it parses; holds the
Chamfer kernel against its plain version at the clouds of the training's
last step (identical indices), and Kernel C's forward at the surface points
of the render CLI's last view and of the visualisation's view (at Kernel
C's bars); and times a ``render_visdata`` call (its render and its Phong
part) and a novel view.

The recovery phase then recovers poses from scratch: the whole schedule
of ``scripts/torch_reproduce_synthetic.sh``'s training (the JAX
package's teacher at seed 3 from ``tests/fixtures/teacher_seed3.npz``, 20
frames of 96x128 on disk, its scene.yaml: hidden 128, 64 samples, poses
from identity, the auto-scheduler) through ``train()``; the mean ATE of
the last REC_TAIL epochs must fall under REC_ATE_FRACTION of the first
epoch's; Kernel A once each way per step and Kernel B twice per step
that builds the reference pair (the schedule anneals its losses to 0
late in the run), both held against their plain versions at the last
step's inputs.

Prints, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the fused backward pass phase's lines, one line
per epoch, the
training runs' checks, the scan phase's lines, the eval phase's, the DPT
phase's, the multigpu phase's, the synthetic phase's, the recovery phase's,
the JSON lines of the training runs, the compositing / encoding backward
phase, the scan, eval, DPT, multigpu,
synthetic and recovery phases, a JSON line with every
kernel's errors, launches (each phase's share too), times and bound (and
the library call's time
where one exists), and last ``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs a CUDA device and the
repository beside it; it imports nothing of JAX. With ``--gate-control``
it runs only the synthetic phase, with the field's weight-matrix gradients
zeroed (:func:`gate_control`), and exits 0 when the PSNR gate rejects it;
with ``--recovery-control`` only the recovery phase, with the pose learning
rate at 0 (:func:`recovery_control`), and exits 0 when the ATE gate rejects
it. With ``--fwd-turns OTHER.cu`` it runs only :func:`fwd_source_turns`:
the package's fused forward and another version of
``csrc/mlp_fused_fwd.cu`` (e.g. a parent commit's), each built with
``-Xptxas -v``, held to the plain version (outputs, saves), compared bit for
bit with each other and timed in turns against the bound: Kernel A at the
eval render's chunk without saves and at the stock step with them, Kernel C
on the stock step's points.
"""
import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# stock shapes of Kernel A (configs/default.yaml) and of the bench workload
N_RAYS, N_SAMPLES = 1024, 128
H, W, N_FRAMES = 540, 960, 8
EPOCHS = 2
# the eval phase: test-time pose optimisation epochs on the held-out view
# (the stock configs run 1000), its rays per step, and the side of the view
# that is rendered through Kernel A and its plain version
EVAL_POSE_EPOCHS, EVAL_POINTS = 5, 1024
SMALL_VIEW = (135, 240)
# the synthetic phase: the teacher scene (6 frames of 60x80 on disk, of which
# the loader holds frame 4 out: 5 training views), trained at the stock
# widths with gt poses fixed for SYN_EPOCHS epochs (200 steps); the
# visualisation and the pair dumps fire at the ends of the epochs that cross
# a multiple of SYN_VIS_EVERY steps (it 4 and 104: fired_steps); the render
# CLI renders SYN_NOVEL views; the bench runs short
SYN_FRAMES, SYN_HW, SYN_EPOCHS, SYN_VIS_EVERY = 6, (60, 80), 40, 100
SYN_NOVEL = 8
SYN_PSNR_GAIN = 1.0  # dB, tests/test_training.py::test_vanilla_nerf_converges
# The teacher's frames are nearly uniform (the first epoch reads ~32.7 dB),
# so a gain of 1 dB proves little: the mean PSNR of the last SYN_TAIL
# epochs must also reach SYN_PSNR_TAIL. On an H100 (700 W) the sound run
# reads 58.08 dB there (57.03-59.04; a dip to 52.2 dB mid-run), and a run
# with the field's weight-matrix gradients zeroed, which fits the biases
# alone, reads 51.48 (50.85-51.84): see PERF.md and ``--gate-control``.
SYN_TAIL, SYN_PSNR_TAIL = 10, 55.0
BENCH_SHORT = (16, 1, 2)  # steps per dispatch, warm-up and timed dispatches
# the DPT phase: a 4-frame 540x960 scene on disk (the transform makes it
# 384x672), seeded weights with the published checkpoint's keys and shapes
# (N(0, 0.05), as tests/test_dpt_convert.py draws them, and a head bias of
# 400 that puts the inverse depth at the published model's magnitude, so
# every pixel passes the head's ReLU; tests/test_torch_dpt.py), and 2 epochs
# x 4 steps of the stock training on the priors it writes. DPT_RELL2 holds a
# frame's depth against the same function in float64 on the card; a run
# with TF32 on must exceed it, or the bar would not show that the forward
# ran in full f32.
DPT_FRAMES, DPT_EPOCHS, DPT_HEAD_BIAS = 4, 2, 400.0
DPT_OUT_HW = (384, 672)
DPT_RELL2 = 1e-4
# LPIPS at 540x960 against float64 on the card. A run with TF32 on must
# exceed the bar, so that it shows the metric ran in full f32: on an H100
# (700 W) the f32 run reads rel 2.9e-8 and the TF32 run 1.29e-5 (PERF.md).
LPIPS_REL = 1e-6
# where the DPT phase and the reference-checkpoint check put their scene,
# weights and checkpoints (~1 GB; removed when they end, never returned)
WORK = os.path.join(ROOT, "build", "chip_smoke")


def dpt_checkpoint_shapes():
    """{key: shape} of every tensor of the published
    dpt_hybrid-midas-501f0c75.pt (torch layouts); a CPU test holds it equal
    to tests/test_dpt_convert.py::synth_state_dict."""
    s = {}
    bb = "pretrained.model.patch_embed.backbone."
    s[bb + "stem.conv.weight"] = (64, 3, 7, 7)
    s[bb + "stem.norm.weight"] = s[bb + "stem.norm.bias"] = (64,)
    cin = 64
    for si, (n, cout) in enumerate(zip((3, 4, 9), (256, 512, 1024))):
        cmid = cout // 4
        for bi in range(n):
            pre = f"{bb}stages.{si}.blocks.{bi}."
            c_in = cin if bi == 0 else cout
            for c, (o, i, k) in enumerate(((cmid, c_in, 1), (cmid, cmid, 3),
                                           (cout, cmid, 1)), 1):
                s[pre + f"conv{c}.weight"] = (o, i, k, k)
                s[pre + f"norm{c}.weight"] = s[pre + f"norm{c}.bias"] = (o,)
            if bi == 0:
                s[pre + "downsample.conv.weight"] = (cout, c_in, 1, 1)
                s[pre + "downsample.norm.weight"] = (cout,)
                s[pre + "downsample.norm.bias"] = (cout,)
        cin = cout
    vm = "pretrained.model."
    s[vm + "patch_embed.proj.weight"] = (768, 1024, 1, 1)
    s[vm + "patch_embed.proj.bias"] = (768,)
    s[vm + "cls_token"] = (1, 1, 768)
    s[vm + "pos_embed"] = (1, 577, 768)
    for i in range(12):
        pre = f"{vm}blocks.{i}."
        for name, (o, i_) in (("attn.qkv", (2304, 768)),
                              ("attn.proj", (768, 768)),
                              ("mlp.fc1", (3072, 768)),
                              ("mlp.fc2", (768, 3072))):
            s[pre + name + ".weight"], s[pre + name + ".bias"] = (o, i_), (o,)
        for n in ("norm1", "norm2"):
            s[pre + n + ".weight"] = s[pre + n + ".bias"] = (768,)
    s[vm + "norm.weight"] = s[vm + "norm.bias"] = (768,)
    pp = "pretrained.act_postprocess"
    for h in (3, 4):
        s[f"{pp}{h}.0.project.0.weight"] = (768, 1536)
        s[f"{pp}{h}.0.project.0.bias"] = (768,)
    for name, k in (("3.3", 1), ("4.3", 1), ("4.4", 3)):
        s[f"{pp}{name}.weight"], s[f"{pp}{name}.bias"] = (768, 768, k, k), (768,)
    for i, c in enumerate((256, 512, 768, 768), 1):
        s[f"scratch.layer{i}_rn.weight"] = (256, c, 3, 3)
    for r in (1, 2, 3, 4):
        pre = f"scratch.refinenet{r}."
        for u in (1, 2):
            for c in (1, 2):
                s[pre + f"resConfUnit{u}.conv{c}.weight"] = (256, 256, 3, 3)
                s[pre + f"resConfUnit{u}.conv{c}.bias"] = (256,)
        s[pre + "out_conv.weight"], s[pre + "out_conv.bias"] = (
            (256, 256, 1, 1), (256,))
    for i, (o, c, k) in zip((0, 2, 4), ((128, 256, 3), (32, 128, 3),
                                        (1, 32, 1))):
        s[f"scratch.output_conv.{i}.weight"] = (o, c, k, k)
        s[f"scratch.output_conv.{i}.bias"] = (o,)
    return s


def lpips_checkpoint_shapes():
    """({key: shape} of torchvision's vgg16().features, of the lpips
    package's VGG heads); a CPU test holds them equal to
    tests/test_lpips_convert.py::synth_dicts."""
    vgg, cin = {}, 3
    convs = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                         convs):
        vgg[f"{idx}.weight"], vgg[f"{idx}.bias"] = (cout, cin, 3, 3), (cout,)
        cin = cout
    lin = {f"lin{i}.model.1.weight": (1, c, 1, 1)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


def seeded_state(shapes, gen, std):
    """A state dict of N(0, std) f32 tensors of ``shapes`` from ``gen``."""
    import torch

    return {k: torch.randn(shape, generator=gen) * std
            for k, shape in shapes.items()}


def run_module(*args):
    """``python -m <args>`` from the repository root, as a user runs a CLI;
    raises when it fails. Returns its standard output."""
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"python -m {' '.join(args)} exited "
                           f"{out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    return out.stdout

# Kernel A's bars against its plain version. tests/test_pallas.py holds the
# TPU kernel to rgb atol 0.03, density rtol 0.08 / atol 0.05 and gradients
# to relL2 0.02 (l.101-102, 163). Kernel and plain version here round the
# same operands the same way and differ only in f32 summation order;
# measured on an H100 (700 W) at these shapes and seeds: rgb 2.8e-5, dist
# 1.9e-6, alpha 5.7e-5, gradients relL2 <= 4.1e-3 (d_rays). The bars are
# tightened to leave a margin of 2.4x or more over those.
RGB_ATOL, DIST_ATOL, ALPHA_ATOL, GRAD_RELL2 = 1e-3, 1e-3, 1e-3, 1e-2
# rendering.normal_loss's normal_diff against float64 on the card, at the
# ssim_normal run's 1,024 rays. Its f32 error is set by its few points
# whose density gradient nearly vanishes, where normalising amplifies the
# round-off: on the CPU at the stock width, random weights, relL2 1.25e-5
# over 1,024 random points but 9.5e-4 over 4,096; on an H100 (700 W) this
# run reads 1.43e-5. The SSIM map's gradient in f32 errs by 7e-7 on the CPU
# (135x240, float64 reference) and 1.1e-6 on the card; TF32 in its
# convolutions would give ~1e-3.
NORMAL_RELL2, SSIM_GRAD_RELL2 = 1e-4, 1e-5
# Kernel C runs Kernel A's GEMM chain with the same rounding points, so it is
# held to the same bars (rgb and density max|err| RGB_ATOL / ALPHA_ATOL,
# gradients relL2 GRAD_RELL2) under the training step's cotangents: those of
# rgb and depth carried back through the plain compositing. Kernel C + the
# plain compositing against Kernel A: the JAX package holds its two paths to
# atol 2e-5 on rgb and alpha and 2e-4 on depth (tests/test_pallas.py:298-311).
C_VS_A_ATOL, C_VS_A_DIST_ATOL = 2e-5, 2e-4
# A fused backward pass's bf16 input gradient against
# gemm_dwgrad_reference (the same bf16 operands, f32 sums in another order):
# at most one bf16 ulp, judged at the magnitude of max(|ref|, |out|,
# max|ref| / 256) -- below that, a value is a cancellation whose f32 order
# error is set by the terms, not by the value.
GEMM_ULPS = 1.0

# the card's peaks (H100 SXM datasheet, at 700 W):
# dense bf16 tensor-core FLOP/s, memory bytes/s, FP32 lane instructions/s
BF16_FLOPS, HBM_BYTES, FP32_INSTR = 989e12, 3.35e12, 33.5e12
# FP32 instructions per point pair of the Chamfer argmins (3 sub, 3 mul,
# 2 add, compare and select; no FMA by design): Kernel D's
PAIR_INSTR = 10
# Kernel B's split-band design keeps a chunk's running minimum with one
# fminf a pair: 3 sub, 3 mul, 2 add and one min
BAND_PAIR_INSTR = 9


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10, warmup=2):
    """Device time of ``fn`` in ms: the kernels' summed device time under
    ``torch.profiler`` over ``iters`` calls, after ``warmup`` calls. Unlike
    :func:`cuda_ms` it leaves out the host's gaps between launches, which on
    a host-bound call of ~50 us kernels are most of the events' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # CUPTI now and then hands the profiler no device events for a window
    # (seen in smoke runs on torch.mm and on a split-K weight gradient);
    # profile the window again, and after three empty windows time it with
    # CUDA events, which count the host's gaps too
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    print("device_ms: torch.profiler recorded no device time in three "
          "windows; CUDA events time this one")
    return cuda_ms(fn, iters=iters, warmup=0)


def bound(flops=0.0, nbytes=0.0, instr=0.0):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` (each input read once, each output written once) over
    the memory rate and the operations over their peak (bf16 tensor-core
    FLOPs, FP32 lane instructions)."""
    t_ops = max(flops / BF16_FLOPS, instr / FP32_INSTR)
    t_mem = nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def mlp_bounds(weights, m, io, div):
    """Bounds of the fused MLP on ``m`` points: (a saving forward, a
    forward that saves nothing, a full backward). 2 m sum(K N) FLOPs
    forward, twice that backward (input- and weight-gradient GEMMs); bytes:
    the weights and ``io``, the function's other inputs and outputs (the
    backward also writes a gradient per weight). A saving forward also
    writes what the backward reads: per point the 8 trunk outputs, feat
    (D each), hr (H2) and the position encoding (its true width) in bf16
    and raw (4 f32), and the direction encoding once per ``div`` points
    (S in Kernel A, 1 in C)."""
    D, H2, n_pos, n_dir = (weights[0].shape[1], weights[20].shape[1],
                           weights[0].shape[0], weights[20].shape[0]
                           - weights[0].shape[1])
    flops = 2.0 * m * sum(w.numel() for w in weights[0::2])
    wb = nbytes(*weights)
    saved = m * (2.0 * (9 * D + H2 + n_pos) + 16.0) + 2.0 * n_dir * m / div
    return (bound(flops, wb + io + saved), bound(flops, wb + io),
            bound(2 * flops, 2 * wb + io))


def mlp_bwd_floor(m, D, H2, n_pos, n_dir, div, weight_grads=True):
    """The fused MLP backward's memory floor on ``m`` points, ms at the
    memory rate: each of its launches reads its inputs once and writes its
    outputs once, with the compositing or head-activation backward (raw,
    the cotangents in, g_raw out) and the encoding backward (its f32
    cotangents in); the weights, the split partials and the (m / div)-row
    3-vectors are left out. With ``weight_grads`` the chain is
    ``_chain_bwd``'s passes (bf16 cotangents and saved activations, f32
    g_raw and encoding cotangents): the heads' pass reads g_raw and hr once
    for g_hr, fc_rgb's weight gradient and the heads' biases; each layer's
    pass reads its cotangent and its saved input once for both its input
    and its weight gradient (the input only where a mask needs it);
    Kernel A's per-ray direction half reads g_hr again. Without, it is one
    launch of the input-only backward (``input_bwd_bound``'s bytes: the
    saves that mask it and g_raw in, the encodings' f32 cotangents out).
    ``div`` is the points per direction-encoding row (S in Kernel A, 1 in
    C)."""
    bf, f4 = 2.0, 4.0
    per_row = (3 * 4 * f4                           # raw, cotangents, g_raw
               + (2 * n_pos + n_dir) * f4)          # encoding backward
    if not weight_grads:
        return 1e3 * m * per_row / HBM_BYTES + input_bwd_bound(
            m, D, H2, n_pos, n_dir, 0.0)[0]
    per_row += (
        4 * f4 + 2 * H2 * bf                        # heads -> g_hr
        + H2 * bf + D * bf + n_dir * f4             # rgb_layer -> g_feat, g_denc
        + 3 * D * bf + f4                           # fc_feature + fc_density
        + 7 * 3 * D * bf                            # masked trunk layers
        + n_pos * f4 + (D * bf + n_pos * f4)        # trunk1_0's enc, trunk0_0
        + D * bf                                    # rgb_layer reads feat
        + (n_dir * bf if div == 1 else H2 * bf + n_dir * bf / div)
        + 2 * n_pos * bf)                           # trunk1_0, trunk0_0 read enc
    return 1e3 * m * per_row / HBM_BYTES


def rel_l2(a, b):
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp_min(torch.linalg.vector_norm(b), 1e-12))


def stock_cfg():
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    return load_config(DEFAULT_CONFIG)


def stock_mlp_inputs(dev, N=N_RAYS, S=N_SAMPLES, hidden=None):
    """Random weights (seed SEED) and a batch of N rays x S samples, by
    default the stock step's 1024 x 128 at the stock width: (cfg, weights,
    origins, rays, dirs, z, deltas, the numpy generator for the cotangents,
    a host-to-device helper)."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = stock_cfg()
    if hidden is not None:
        cfg["model"]["hidden_dim"] = hidden
    near, far = cfg["rendering"]["depth_range"]
    rng = np.random.default_rng(SEED)
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    weights = [t.requires_grad_() for t in mk.collect_weights(params)]
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    zb = near + (far - near) * np.linspace(0.0, 1.0, S)
    z = np.sort(zb[None] + rng.uniform(0, (far - near) / S, size=(N, S)), 1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)

    def t(a, grad=False):
        x = torch.tensor(np.asarray(a, np.float32), device=dev)
        return x.requires_grad_() if grad else x

    origins = t(np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3)), True)
    return (cfg, weights, origins, t(rays, True), t(-rays, True), t(z),
            t(deltas), rng, t)


def kernel_turns(call, plain, iters=10):
    """A kernel timed in this call, on this card: the kernel, its plain
    version and the kernel again (CUDA events; ``ms`` the mean of the
    kernel's two turns), then the kernel's device time by the profiler.
    ``call`` and ``plain`` run the function through the public wrapper and
    through the plain version."""
    f1 = cuda_ms(call, iters)
    p = cuda_ms(plain, iters=3, warmup=1)
    f2 = cuda_ms(call, iters)
    return {"ms": (f1 + f2) / 2, "plain_ms": p,
            "device_ms": device_ms(call, iters)}


def turns_line(t):
    line = (f"fused {t['ms']:.4f} ms (device {t['device_ms']:.4f}"
            + (f", {t['launches_per_call']} launches"
               if "launches_per_call" in t else "")
            + f"), plain {t['plain_ms']:.3f} ms")
    return line


def kernel_launches(fn):
    """The kernels one call of ``fn`` launches on the card, counted by the
    profiler (memory copies and sets left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset")))
        if n:
            return n
    raise RuntimeError("kernel_launches: the profiler recorded no kernel")


def check_bwd_rerun(label, grads):
    """The fused backward (``grads``: gradients of one graph under fixed
    cotangents) against a rerun, bit for bit."""
    import torch

    g1, g2 = grads(), grads()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(g1, g2))
    print(f"{label}: fused backward rerun bitwise {bitwise}")
    if not bitwise:
        raise AssertionError(f"{label}: the fused backward's rerun differs")


def check_fwd_saves(label, fused, kernel, args, weights, first):
    """The saving fused forward (``fused``: ``mlp_kernel._composite_fwd``
    for ``kernel`` "A" or ``_point_fwd`` for "C") against the plain
    version on the same inputs: the outputs within RGB_ATOL and the 13
    tensors the backward reads (the encodings at their true widths) within
    SAVES_RELL2 of the plain chain's, in its shapes, dtypes and strides
    (tests/_mlp_saves.py); ``first`` is the index of enc in the saved
    tuple. Returns the worst save's relL2."""
    import torch

    from _mlp_saves import SAVES_RELL2, plain_forward, saves_rel_l2

    out, dims, saved = fused(*args, weights, save=True)
    out_p, plain = plain_forward(weights, args, kernel)
    err = max(float(torch.max(torch.abs(x - y))) for x, y in zip(out, out_p))
    rels = saves_rel_l2(saved, plain, first, dims)
    worst = max(rels, key=rels.get)
    print(f"{label}: saving fused forward against the plain version: "
          f"outputs max|err| {err:.3e}, the 13 saved tensors relL2 max "
          f"{rels[worst]:.3e} ({worst}) against the plain chain's "
          f"(bar {SAVES_RELL2})")
    if not (err <= RGB_ATOL and rels[worst] <= SAVES_RELL2):
        raise AssertionError(f"{label}: the fused forward's outputs "
                             f"({err:.3e}) or saves ({rels}) are off the "
                             "plain version")
    return rels[worst]


def check_kernel_a(dev, card):
    """Kernel A (the fused forward of csrc/mlp_fused_fwd.cu, the backward of
    csrc/mlp_fused_bwd.cu + mlp_composite.cu) against its plain version at
    the stock step's shapes: forward errors, backward relL2; the saving
    forward's saves against the plain chain's, at the stock shapes and on
    the raw route (S = 96); the forward timed beside the plain version at
    the stock shapes, without saves, at k = 4 frames (4,096 rays) and at the
    recovery scripts' width (hidden 128, 1024 rays x 64 samples); the
    backward timed likewise."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    N, S = N_RAYS, N_SAMPLES
    # cotangents as the training loss gives them: rgb and depth are read,
    # alpha is not. (A random alpha cotangent on all 131k samples makes the
    # backward chaotic: two runs of the plain version whose matmul outputs
    # differ by 1e-7 relative then differ by 5e-3 relL2 in the trunk.)
    cots = (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N, 1)) / N),
            torch.zeros((N, S), device=dev))
    static = (cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"],
              cfg["model"]["occ_activation"], True, False, False, S)
    inputs = [origins, rays_t, dirs] + weights

    def fwd(fn):
        return fn(weights, origins, rays_t, dirs, z_t, deltas_t, *static)

    def grads(outs):
        return torch.autograd.grad(outs, inputs, cots, retain_graph=True)

    fused0 = mk.MLP_FUSED_FWD_LAUNCHES.count
    out_k, out_r = fwd(mk.fused_mlp_composite), fwd(
        mk.fused_mlp_composite_reference)
    if mk.MLP_FUSED_FWD_LAUNCHES.count != fused0 + 1:
        raise AssertionError("kernel A: the forward did not run as one fused "
                             "launch")
    g_k, g_r = grads(out_k), grads(out_r)
    torch.cuda.synchronize()

    o_k = [o.detach() for o in out_k]
    o_r = [o.detach() for o in out_r]
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "dist", "alpha"), o_k, o_r)}
    alpha_bad = int(torch.sum(torch.abs(o_k[2] - o_r[2]) > ALPHA_ATOL))
    names = ["d_origins", "d_rays", "d_dirs"] + [
        f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    bwd_abs = max(float(torch.max(torch.abs(a - b))) for a, b in zip(g_k, g_r))
    finite = all(bool(torch.isfinite(x).all()) for x in (*o_k, *g_k))
    geo = [x.detach().contiguous() for x in (origins, rays_t, dirs)]
    saves_rel = check_fwd_saves(f"kernel A [{card}] N={N} S={S}",
                                mk._composite_fwd, "A",
                                (*geo, z_t, deltas_t, static), weights, 5)

    def nosave():
        with torch.no_grad():
            fwd(mk.fused_mlp_composite)

    def nosave_plain():
        with torch.no_grad():
            fwd(mk.fused_mlp_composite_reference)

    t_save = kernel_turns(lambda: fwd(mk.fused_mlp_composite),
                       lambda: fwd(mk.fused_mlp_composite_reference))
    t_nosave = kernel_turns(nosave, nosave_plain)
    check_bwd_rerun(f"kernel A bwd [{card}] N={N} S={S}",
                    lambda: grads(out_k))
    t_bwd = kernel_turns(lambda: grads(out_k), lambda: grads(out_r))
    t_bwd["launches_per_call"] = kernel_launches(lambda: grads(out_k))
    widths = _mlp_widths(weights, static)
    floor = mlp_bwd_floor(N * S, *widths, div=S)
    io = nbytes(origins, rays_t, dirs, z_t, deltas_t, *o_k)
    (b_save, by_save), (b_ns, by_ns), (b_bwd, by_bwd) = mlp_bounds(
        weights, N * S, io, S)
    print(f"kernel A fwd [{card}] N={N} S={S} D={cfg['model']['hidden_dim']}:"
          f" max|err| rgb={err['rgb']:.3e} dist={err['dist']:.3e}"
          f" alpha={err['alpha']:.3e} (alpha entries over bar: {alpha_bad});"
          f" saving: {turns_line(t_save)}, bound {b_save:.4f} ms ({by_save})"
          f"; without saves: {turns_line(t_nosave)}, bound {b_ns:.4f} ms "
          f"({by_ns})")
    worst = max(rels, key=rels.get)
    print(f"kernel A bwd [{card}]: relL2 max {rels[worst]:.3e} ({worst}); "
          + " ".join(f"{n}={v:.2e}" for n, v in rels.items())
          + f"; {turns_line(t_bwd)}; bound {b_bwd:.4f} ms ({by_bwd}); "
          f"memory floor {floor:.3f} ms")
    fails = []
    if not finite:
        fails.append("non-finite kernel output")
    if err["rgb"] > RGB_ATOL:
        fails.append(f"rgb max|err| {err['rgb']:.3e} > {RGB_ATOL}")
    if err["dist"] > DIST_ATOL:
        fails.append(f"dist max|err| {err['dist']:.3e} > {DIST_ATOL}")
    if alpha_bad:
        fails.append(f"{alpha_bad} alpha entries outside atol {ALPHA_ATOL}")
    fails += [f"{n} relL2 {v:.3e} >= {GRAD_RELL2}"
              for n, v in rels.items() if not v < GRAD_RELL2]
    if fails:
        raise AssertionError("kernel A disagrees with its plain version: "
                             + "; ".join(fails))
    shapes = {"k4": fwd_shape_turns(dev, card, 4 * N_RAYS, N_SAMPLES, None),
              "recovery": fwd_shape_turns(dev, card, N_RAYS, 64, 128)}
    bwd_shapes = {"k4": bwd_shape_turns(dev, card, 4 * N_RAYS, N_SAMPLES,
                                        None),
                  "recovery": bwd_shape_turns(dev, card, N_RAYS, 64, 128)}
    raw_route = check_raw_route(dev, card)
    fwd_rec = {"name": "mlp_composite_fwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_fused_fwd.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:668",
               "max_abs_err": max(err.values()),
               "saves_max_rel_l2_to_plain": saves_rel, **t_save,
               "bound_ms": b_save, "bound_by": by_save, "library_ms": None,
               "nosave": {**t_nosave, "bound_ms": b_ns, "bound_by": by_ns},
               **shapes, "raw_route": raw_route,
               "routes": "one fused launch when 128 % S == 0 (compositing "
                         "in the kernel); else the raw route: the fused "
                         "kernel writes raw and composite_fwd "
                         "(csrc/mlp_composite.cu) runs after it"}
    bwd_rec = {"name": "mlp_composite_bwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_fused_bwd.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_composite.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
               "max_abs_err": bwd_abs, "max_rel_l2": rels[worst],
               "rerun_bitwise": True, **t_bwd,
               "bound_ms": b_bwd, "bound_by": by_bwd, "library_ms": None,
               "floor_ms": floor, **bwd_shapes}
    return fwd_rec, bwd_rec


# (kernel, rays of 128 samples, save) of fwd_source_turns: Kernel A at the
# eval render's chunk (ops/rendering.py::render_image) without saves and at
# the stock step with them, Kernel C on the stock step's points with them
FWD_SOURCE_CASES = (("render_chunk", "A", 16384, False),
                    ("stock_step", "A", N_RAYS, True),
                    ("stock_points", "C", N_RAYS, True))


def fwd_source_turns(dev, card, other):
    """Kernels A's and C's fused forward built from the package's source
    and from ``other`` (another version of csrc/mlp_fused_fwd.cu with the same C
    interface, e.g. a parent commit's), each compiled with ``-Xptxas -v``
    (registers and spills printed; tools/torch_fused_fwd_probe.py's
    build_variants): at each FWD_SOURCE_CASES case both held to the plain
    version (outputs within RGB_ATOL, and with saves the 13 saved tensors
    within SAVES_RELL2 of the plain chain's; tests/_mlp_saves.py), the
    other's outputs and saves compared bit for bit with the package's (and
    the answer recorded), then timed in turns (package, other, other,
    package; profiler device ms) beside the bound (:func:`mlp_bounds`).
    Returns the record and prints it as one JSON line
    ``{"fwd_turns": ...}``."""
    import importlib.util

    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    from _mlp_saves import SAVES_RELL2, plain_forward, saves_rel_l2

    spec = importlib.util.spec_from_file_location(
        "fused_fwd_probe", os.path.join(ROOT, "tools",
                                        "torch_fused_fwd_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    fns = probe.build_variants(["package=", f"other={other}:"])
    real = mk.c_function

    def use(name):
        mk.c_function = (lambda n, s, f=fns[name]:
                         f if n == "nnt_mlp_fused_fwd" else real(n, s))

    rec = {"card": card, "other": other, "cases": {}}
    try:
        for case, kernel, N, save in FWD_SOURCE_CASES:
            (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, _,
             _) = stock_mlp_inputs(dev, N, N_SAMPLES)
            l_pos, l_dir = (cfg["model"]["pos_enc_levels"],
                            cfg["model"]["dir_enc_levels"])
            act = cfg["model"]["occ_activation"]
            geo = [x.detach().contiguous() for x in (origins, rays_t, dirs)]
            ws = [w.detach() for w in weights]
            if kernel == "A":
                args = (*geo, z_t, deltas_t,
                        (l_pos, l_dir, act, True, False, False, N_SAMPLES))
                fwd, first = mk._composite_fwd, 5
                io = nbytes(*geo, z_t, deltas_t) + 4.0 * N * (4 + N_SAMPLES)
            else:
                pts = (geo[0][:, None, :] + geo[1][:, None, :]
                       * z_t[..., None]).reshape(-1, 3)
                pdirs = geo[2][:, None, :].expand(N, N_SAMPLES, 3).reshape(
                    -1, 3).contiguous()
                args = (pts, pdirs, (l_pos, l_dir, act, True))
                fwd, first = mk._point_fwd, 2
                io = nbytes(pts, pdirs) + 16.0 * N * N_SAMPLES
            out_p, plain = plain_forward(ws, args, kernel)
            runs = {}
            for name in fns:
                use(name)
                out, dims, saved = fwd(*args, ws, save)
                err = max(float(torch.max(torch.abs(a - b)))
                          for a, b in zip(out, out_p))
                rel = (max(saves_rel_l2(saved, plain, first, dims).values())
                       if save else 0.0)
                if not (err <= RGB_ATOL and rel <= SAVES_RELL2):
                    raise AssertionError(f"fwd turns {case}: the {name} "
                                         f"kernel is off the plain version: "
                                         f"outputs {err:.3e}, saves {rel:.3e}")
                kept = [*out, *(saved[first + 2:first + 13] if save else ())]
                runs[name] = ([t.clone() for t in kept], err, rel)
            same = all(torch.equal(a, b) for a, b in
                       zip(runs["package"][0], runs["other"][0]))

            def call():
                fwd(*args, ws, save)

            times = {name: [] for name in fns}
            for name in ("package", "other", "other", "package"):
                use(name)
                times[name].append(device_ms(call, iters=10))
            (b_save, by_save), (b_ns, by_ns), _ = mlp_bounds(
                weights, N * N_SAMPLES, io, N_SAMPLES if kernel == "A" else 1)
            b, by = (b_save, by_save) if save else (b_ns, by_ns)
            ms = {name: sum(v) / len(v) for name, v in times.items()}
            rec["cases"][case] = {
                "kernel": kernel, "rays": N, "samples": N_SAMPLES,
                "save": save, "other_bitwise_to_package": same,
                "max_abs_err_to_plain": {n: v[1] for n, v in runs.items()},
                "saves_max_rel_l2_to_plain": {n: v[2]
                                              for n, v in runs.items()},
                "device_ms": times,
                "bound_ms": b, "bound_by": by,
                "share_of_bound": {n: b / v for n, v in ms.items()}}
            print(f"fused fwd turns [{card}] {kernel} {case} {N} x "
                  f"{N_SAMPLES} save="
                  f"{save}: other bitwise to package {same}; package "
                  f"{ms['package']:.4f} ms, other "
                  f"{ms['other']:.4f} ms, bound {b:.4f} ms ({by}); "
                  f"bound / time {b / ms['package']:.3f} against "
                  f"{b / ms['other']:.3f}", flush=True)
    finally:
        mk.c_function = real
    print(json.dumps({"fwd_turns": rec}), flush=True)
    return rec


def fwd_shape_turns(dev, card, N, S, hidden, kernel="A"):
    """Kernel A's forward at N rays x S samples (width ``hidden``, default
    the stock 256), or Kernel C's at the same N x S points, against its
    plain version (RGB_ATOL) and timed beside it (:func:`kernel_turns`)
    saving, as a training step calls it."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, _,
     _) = stock_mlp_inputs(dev, N, S, hidden)
    l_pos, l_dir = cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"]
    act = cfg["model"]["occ_activation"]
    if kernel == "A":
        static = (l_pos, l_dir, act, True, False, False, S)
        args = (origins, rays_t, dirs, z_t, deltas_t)
        io = nbytes(*args) + 4.0 * N * (4 + S)
        fns = (mk.fused_mlp_composite, mk.fused_mlp_composite_reference)
    else:
        static = (l_pos, l_dir, act, True)
        args = [(origins[:, None, :] + rays_t[:, None, :] * z_t[..., None])
                .reshape(-1, 3).detach().requires_grad_(),
                dirs[:, None, :].expand(N, S, 3).reshape(-1, 3).detach()
                .contiguous().requires_grad_()]
        io = nbytes(*args) + 16.0 * N * S
        fns = (mk.fused_mlp, mk.fused_mlp_reference)

    def fwd(fn):
        return fn(weights, *args, *static)

    err = max(float(torch.max(torch.abs(a.detach() - b.detach())))
              for a, b in zip(fwd(fns[0]), fwd(fns[1])))
    t = kernel_turns(lambda: fwd(fns[0]), lambda: fwd(fns[1]))
    (b_save, by_save), _, _ = mlp_bounds(weights, N * S, io,
                                         S if kernel == "A" else 1)
    D = cfg["model"]["hidden_dim"]
    print(f"kernel {kernel} fwd [{card}] {N} x {S} points D={D}: max|err| "
          f"{err:.3e}; saving: {turns_line(t)}, bound {b_save:.4f} ms "
          f"({by_save})")
    if not err <= RGB_ATOL:
        raise AssertionError(f"kernel {kernel} at {N} x {S} D={D}: max|err| "
                             f"{err:.3e} > {RGB_ATOL}")
    return {"rays": N, "samples": S, "hidden": D, "max_abs_err": err, **t,
            "bound_ms": b_save, "bound_by": by_save}


def bwd_shape_turns(dev, card, N, S, hidden, kernel="A"):
    """Kernel A's backward at N rays x S samples (width ``hidden``, default
    the stock 256), or Kernel C's at the same N x S points, under the
    training step's cotangents: against its plain version (GRAD_RELL2) and
    a rerun (:func:`check_bwd_rerun`), and timed beside the plain version
    (:func:`kernel_turns`)."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev, N, S, hidden)
    l_pos, l_dir = cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"]
    act = cfg["model"]["occ_activation"]
    if kernel == "A":
        static = (l_pos, l_dir, act, True, False, False, S)
        args = (origins, rays_t, dirs, z_t, deltas_t)
        cots = (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N, 1)) / N),
                torch.zeros((N, S), device=dev))
        inputs = [origins, rays_t, dirs] + weights
        fns = (mk.fused_mlp_composite, mk.fused_mlp_composite_reference)
        names = ["d_origins", "d_rays", "d_dirs"]
    else:
        static = (l_pos, l_dir, act, True)
        args = [(origins[:, None, :] + rays_t[:, None, :] * z_t[..., None])
                .reshape(-1, 3).detach().requires_grad_(),
                dirs[:, None, :].expand(N, S, 3).reshape(-1, 3).detach()
                .contiguous().requires_grad_()]
        M = N * S
        cots = (t(rng.normal(size=(M, 3)) / M), t(rng.normal(size=(M, 1)) / M))
        inputs = list(args) + weights
        fns = (mk.fused_mlp, mk.fused_mlp_reference)
        names = ["d_pts", "d_dirs"]
    names += [f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    outs = [fn(weights, *args, *static) for fn in fns]

    def grads(o):
        return torch.autograd.grad(o, inputs, cots, retain_graph=True)

    g_k, g_r = grads(outs[0]), grads(outs[1])
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    worst = max(rels, key=rels.get)
    D = cfg["model"]["hidden_dim"]
    label = f"kernel {kernel} bwd [{card}] {N} x {S} points D={D}"
    check_bwd_rerun(label, lambda: grads(outs[0]))
    tt = kernel_turns(lambda: grads(outs[0]), lambda: grads(outs[1]))
    tt["launches_per_call"] = kernel_launches(lambda: grads(outs[0]))
    div = S if kernel == "A" else 1
    widths = _mlp_widths(weights, static)
    io = nbytes(*args) + 4.0 * N * (4 + S) if kernel == "A" else \
        nbytes(*args) + 16.0 * N * S
    _, _, (b_bwd, by_bwd) = mlp_bounds(weights, N * S, io, div)
    floor = mlp_bwd_floor(N * S, *widths, div=div)
    print(f"{label}: relL2 max {rels[worst]:.3e} ({worst}) against the plain "
          f"version; {turns_line(tt)}; bound {b_bwd:.4f} ms ({by_bwd}); "
          f"memory floor {floor:.3f} ms")
    if not (rels[worst] < GRAD_RELL2
            and all(bool(torch.isfinite(g).all()) for g in g_k)):
        raise AssertionError(f"{label}: against its plain version {rels}")
    return {"rays": N, "samples": S, "hidden": D, "max_rel_l2": rels[worst],
            **tt, "bound_ms": b_bwd, "bound_by": by_bwd, "floor_ms": floor}


def check_raw_route(dev, card):
    """Kernel A at 1024 rays x 96 samples, an S that does not tile 128
    points: the fused kernel writes raw and composite_fwd runs after it
    (one launch each), against the plain version (RGB_ATOL) and, saving,
    its saves against the plain chain's (:func:`check_fwd_saves`)."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    S = 96
    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, _,
     _) = stock_mlp_inputs(dev, N_RAYS, S)
    static = (cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"],
              cfg["model"]["occ_activation"], True, False, False, S)
    counters = (mk.MLP_FUSED_FWD_LAUNCHES, mk.COMPOSITE_AFTER_LAUNCHES)
    n0 = [c.count for c in counters]
    with torch.no_grad():
        out = mk.fused_mlp_composite(weights, origins, rays_t, dirs, z_t,
                                     deltas_t, *static)
    launches = [c.count - n for c, n in zip(counters, n0)]
    ref = mk.fused_mlp_composite_reference(weights, origins, rays_t, dirs,
                                           z_t, deltas_t, *static)
    err = max(float(torch.max(torch.abs(a - b.detach())))
              for a, b in zip(out, ref))
    geo = [x.detach().contiguous() for x in (origins, rays_t, dirs)]
    saves_rel = check_fwd_saves(f"kernel A raw route [{card}] S={S}",
                                mk._composite_fwd, "A",
                                (*geo, z_t, deltas_t, static), weights, 5)
    print(f"kernel A raw route [{card}] N={N_RAYS} S={S}: launches fused "
          f"{launches[0]}, composite_fwd after it {launches[1]}; max|err| "
          f"{err:.3e}")
    if launches != [1, 1] or not err <= RGB_ATOL:
        raise AssertionError(f"kernel A raw route: launches {launches}, "
                             f"max|err| {err:.3e}")
    return {"samples": S, "launches": launches, "max_abs_err": err,
            "saves_max_rel_l2_to_plain": saves_rel}


def _mlp_widths(weights, static):
    """(D, H2, n_pos, n_dir) of the fused MLP's weights, ``static`` starting
    with the two encodings' levels."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    n_pos, n_dir, D, H2 = mk._dims(weights, static[0], static[1])
    return D, H2, n_pos, n_dir


def depth_pair(dev, hs, ws, seed):
    """Two noisy (hs x ws) depth maps of one smooth surface, backprojected
    and the first warped by a small rigid motion, as the pc loss pairs its
    clouds: (X, Y, camera matrix)."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.geometry.rays import (arange_pixels,
                                                   transform_to_world)
    from nope_nerf_tpu_torch.geometry.so3 import make_c2w

    rng = np.random.default_rng(seed)
    cam = torch.tensor([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                        [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    _, pix = arange_pixels((hs, ws), device=dev)
    yy, xx = np.meshgrid(np.linspace(0, 1, hs), np.linspace(0, 1, ws),
                         indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
    d1 = depth + 0.01 * rng.normal(size=depth.shape)
    d2 = depth + 0.01 * rng.normal(size=depth.shape)
    td = lambda a: torch.tensor(a.reshape(-1), dtype=torch.float32, device=dev)  # noqa: E731
    pc1 = transform_to_world(pix, td(d1), cam)
    pc2 = transform_to_world(pix, td(d2), cam)
    rel = make_c2w(torch.tensor([0.01, -0.02, 0.005], device=dev),
                   torch.tensor([0.02, 0.01, -0.03], device=dev))
    return pc1 @ rel[:3, :3].t() + rel[:3, 3], pc2, cam


def check_kernel_b(dev, card):
    """Kernel B (banded Chamfer argmin) on a 135x240 depth-map pair warped
    by a small rigid motion: bit for bit the plain version's indices; then
    the kernel timed beside the plain version (:func:`kernel_turns`: events
    and device time)."""
    import torch

    from nope_nerf_tpu_torch.geometry.rays import project_to_cam
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    cfg = stock_cfg()
    ratio = cfg["training"]["pc_ratio"]
    hs, ws = int(H / ratio), int(W / ratio)
    X, Y, cam = depth_pair(dev, hs, ws, SEED + 1)
    k = max(2, round(cfg["tpu"]["chamfer_band_rows"] * ws / cb.TILE))
    n = hs * ws
    starts = cb.rows_to_start_tiles(X, n, (hs, ws), cam, project_to_cam, k)
    idx_k = cb.nearest_idx_banded(X, Y, starts, k)
    idx_r = cb.nearest_idx_banded_reference(X, Y, starts, k)
    torch.cuda.synchronize()
    mism = int(torch.sum(idx_k != idx_r))
    dk = torch.linalg.vector_norm(X - Y[idx_k.long()], dim=-1)
    dr = torch.linalg.vector_norm(X - Y[idx_r.long()], dim=-1)
    max_abs = float(torch.max(torch.abs(dk - dr)))
    turns = kernel_turns(lambda: cb.nearest_idx_banded(X, Y, starts, k),
                      lambda: cb.nearest_idx_banded_reference(X, Y, starts,
                                                              k),
                      iters=50)
    # every query group scans k_tiles (at most Y's tiles) of TILE rows
    pairs = n * min(k, -(-n // cb.TILE)) * cb.TILE
    b_ms, b_by = bound(instr=BAND_PAIR_INSTR * pairs,
                       nbytes=nbytes(X, Y, starts, idx_k))
    print(f"kernel B [{card}] {n} x {n} points, k_tiles={k}: {mism} index "
          f"mismatches against the plain version, max|err| of the matched "
          f"distance {max_abs:.3e}; kernel {turns['ms']:.4f} ms by events, "
          f"device {turns['device_ms']:.4f}; plain {turns['plain_ms']:.3f} "
          f"ms; bound {b_ms:.4f} ms ({b_by})")
    if mism:
        raise AssertionError(f"kernel B: {mism} indices differ from its "
                             "plain version")
    return {"name": "chamfer_band", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/chamfer_band.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/chamfer_band.py:90",
            "max_abs_err": max_abs, "index_mismatches": mism,
            "ms": turns["ms"], "device_ms": turns["device_ms"],
            "plain_ms": turns["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_kernel_c(dev, card):
    """Kernel C (per-point fused MLP: the fused forward of
    csrc/mlp_fused_fwd.cu) against its plain version at the stock step's
    131,072 points, under the training step's cotangents; the saving
    forward's saves against the plain chain's; the forward and the backward
    timed as Kernel A's (stock, without saves, k = 4, the recovery width);
    then Kernel C + the plain compositing against Kernel A on the same
    rays."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.rendering import composite

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    N, S = N_RAYS, N_SAMPLES
    l_pos, l_dir = cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"]
    act = cfg["model"]["occ_activation"]
    # the points and directions as the unfused renderer forms them
    pts = (origins[:, None, :] + rays_t[:, None, :] * z_t[..., None]).reshape(
        -1, 3).detach().requires_grad_()
    pdirs = dirs[:, None, :].expand(N, S, 3).reshape(-1, 3).detach(
    ).requires_grad_()
    inputs = [pts, pdirs] + weights

    def fwd(fn):
        return fn(weights, pts, pdirs, l_pos, l_dir, act, True)

    def render(out):
        rgbv, dist, _ = composite(out[0].reshape(N, S, 3),
                                  out[1].reshape(N, S), z_t)
        return rgbv, dist

    out_k, out_r = fwd(mk.fused_mlp), fwd(mk.fused_mlp_reference)
    # per-point cotangents of a loss that reads rgb and depth per ray
    cots = torch.autograd.grad(
        render(out_r), out_r,
        (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N,)) / N)),
        retain_graph=True)

    def grads(outs):
        return torch.autograd.grad(outs, inputs, cots, retain_graph=True)

    g_k, g_r = grads(out_k), grads(out_r)
    torch.cuda.synchronize()
    o_k = [o.detach() for o in out_k]
    o_r = [o.detach() for o in out_r]
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "density"), o_k, o_r)}
    names = ["d_pts", "d_dirs"] + [
        f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    bwd_abs = max(float(torch.max(torch.abs(a - b))) for a, b in zip(g_k, g_r))
    finite = all(bool(torch.isfinite(x).all()) for x in (*o_k, *g_k))

    saves_rel = check_fwd_saves(
        f"kernel C [{card}] M={N * S}", mk._point_fwd, "C",
        (pts.detach(), pdirs.detach().contiguous(),
         (l_pos, l_dir, act, True)), weights, 2)

    def nosave():
        with torch.no_grad():
            fwd(mk.fused_mlp)

    def nosave_plain():
        with torch.no_grad():
            fwd(mk.fused_mlp_reference)

    t_save = kernel_turns(lambda: fwd(mk.fused_mlp),
                       lambda: fwd(mk.fused_mlp_reference))
    t_nosave = kernel_turns(nosave, nosave_plain)
    check_bwd_rerun(f"kernel C bwd [{card}] M={N * S}", lambda: grads(out_k))
    t_bwd = kernel_turns(lambda: grads(out_k), lambda: grads(out_r))
    t_bwd["launches_per_call"] = kernel_launches(lambda: grads(out_k))
    widths = _mlp_widths(weights, (l_pos, l_dir))
    floor = mlp_bwd_floor(N * S, *widths, div=1)

    # Kernel C + plain compositing against Kernel A at the same inputs
    with torch.no_grad():
        rgbv_a, dist_a, alpha_a = mk.fused_mlp_composite(
            weights, origins, rays_t, dirs, z_t, deltas_t, l_pos, l_dir,
            act, True, False, False, S)
        rgbv_c, dist_c = render(o_k)
    vs_a = {"rgb": float(torch.max(torch.abs(rgbv_c - rgbv_a))),
            "alpha": float(torch.max(torch.abs(o_k[1].reshape(N, S)
                                               - alpha_a))),
            "dist": float(torch.max(torch.abs(dist_c - dist_a[:, 0])))}

    (b_save, by_save), (b_ns, by_ns), (b_bwd, by_bwd) = mlp_bounds(
        weights, N * S, nbytes(pts, pdirs, *o_k), 1)
    print(f"kernel C fwd [{card}] M={N * S} D={cfg['model']['hidden_dim']}:"
          f" max|err| rgb={err['rgb']:.3e} density={err['density']:.3e};"
          f" saving: {turns_line(t_save)}, bound {b_save:.4f} ms ({by_save})"
          f"; without saves: {turns_line(t_nosave)}, bound {b_ns:.4f} ms "
          f"({by_ns})")
    worst = max(rels, key=rels.get)
    print(f"kernel C bwd [{card}]: relL2 max {rels[worst]:.3e} ({worst}); "
          + " ".join(f"{n}={v:.2e}" for n, v in rels.items())
          + f"; {turns_line(t_bwd)}; bound {b_bwd:.4f} ms ({by_bwd}); "
          f"memory floor {floor:.3f} ms")
    print(f"kernel C + plain compositing vs kernel A [{card}]: max|err| "
          + " ".join(f"{n}={v:.3e}" for n, v in vs_a.items()))
    fails = []
    if not finite:
        fails.append("non-finite kernel output")
    if err["rgb"] > RGB_ATOL:
        fails.append(f"rgb max|err| {err['rgb']:.3e} > {RGB_ATOL}")
    if err["density"] > ALPHA_ATOL:
        fails.append(f"density max|err| {err['density']:.3e} > {ALPHA_ATOL}")
    fails += [f"{n} relL2 {v:.3e} >= {GRAD_RELL2}"
              for n, v in rels.items() if not v < GRAD_RELL2]
    for n, bar in (("rgb", C_VS_A_ATOL), ("alpha", C_VS_A_ATOL),
                   ("dist", C_VS_A_DIST_ATOL)):
        if not vs_a[n] <= bar:
            fails.append(f"{n} against kernel A {vs_a[n]:.3e} > {bar}")
    if fails:
        raise AssertionError("kernel C disagrees: " + "; ".join(fails))
    shapes = {"k4": fwd_shape_turns(dev, card, 4 * N_RAYS, N_SAMPLES, None,
                                    "C"),
              "recovery": fwd_shape_turns(dev, card, N_RAYS, 64, 128, "C")}
    bwd_shapes = {"k4": bwd_shape_turns(dev, card, 4 * N_RAYS, N_SAMPLES,
                                        None, "C"),
                  "recovery": bwd_shape_turns(dev, card, N_RAYS, 64, 128,
                                              "C")}
    fwd_rec = {"name": "mlp_point_fwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_fused_fwd.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:244",
               "max_abs_err": max(err.values()),
               "max_abs_err_vs_kernel_a": max(vs_a.values()),
               "saves_max_rel_l2_to_plain": saves_rel, **t_save,
               "bound_ms": b_save, "bound_by": by_save, "library_ms": None,
               "nosave": {**t_nosave, "bound_ms": b_ns, "bound_by": by_ns},
               **shapes}
    bwd_rec = {"name": "mlp_point_bwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_fused_bwd.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_composite.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:258",
               "max_abs_err": bwd_abs, "max_rel_l2": rels[worst],
               "rerun_bitwise": True, **t_bwd,
               "bound_ms": b_bwd, "bound_by": by_bwd, "library_ms": None,
               "floor_ms": floor, **bwd_shapes}
    return fwd_rec, bwd_rec


def check_kernel_d(dev, card):
    """Kernel D (exact Chamfer argmin, both directions) against its plain
    version on warped depth-map pairs of 135x240 (the stock pc_ratio) and
    270x480 points: identical indices required. Times the kernel, the plain
    version and the grid mode at both sizes, and prints the cost laws of
    ``chamfer_mode: auto`` they give."""
    import torch

    from nope_nerf_tpu_torch.ops import chamfer as ch
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    ratio = stock_cfg()["training"]["pc_ratio"]
    rows = []
    for r in (ratio, ratio / 2):
        hs, ws = int(H / r), int(W / r)
        n = hs * ws
        X, Y, _ = depth_pair(dev, hs, ws, SEED + 2)
        idx_k = ck.nearest_idx_exact(X, Y)
        idx_r = ck.nearest_idx_exact_reference(X, Y)
        loss_k = ck.chamfer_loss_exact(X, Y)
        loss_r = ch.chamfer_loss(X, Y)
        torch.cuda.synchronize()
        mism = sum(int(torch.sum(a != b)) for a, b in zip(idx_k, idx_r))
        loss_err = float(torch.abs(loss_k - loss_r))
        ms = cuda_ms(lambda: ck.nearest_idx_exact(X, Y), iters=10)
        dms = device_ms(lambda: ck.nearest_idx_exact(X, Y), iters=10)
        ms_plain = cuda_ms(lambda: ck.nearest_idx_exact_reference(X, Y),
                           iters=2, warmup=1)
        ms_grid = cuda_ms(lambda: ch.nearest_idx_window(X, Y), iters=5)
        print(f"kernel D [{card}] {n} x {n} points: {mism} index mismatches,"
              f" |loss err| {loss_err:.3e}; kernel {ms:.3f} ms (device "
              f"{dms:.4f}), plain {ms_plain:.3f} ms; grid mode {ms_grid:.3f} "
              "ms")
        if mism:
            raise AssertionError(f"kernel D: {mism} indices differ from its "
                                 f"plain version at {n} points")
        rows.append((n, mism, loss_err, ms, ms_plain, ms_grid,
                     nbytes(X, Y, *idx_k), dms))
    per_pair = sum(row[3] / row[0] ** 2 for row in rows) / len(rows)
    per_point = sum(row[5] / (2 * row[0]) for row in rows) / len(rows)
    print(f"chamfer auto cost laws [{card}]: exact {per_pair:.3e} ms/pair, "
          f"grid {per_point:.3e} ms/point; equal clouds cross over at "
          f"{2 * per_point / per_pair:.0f} points")
    # both directions scan every pair
    (b_ms, b_by), (b_large, _) = (bound(instr=PAIR_INSTR * 2 * row[0] ** 2,
                                        nbytes=row[6]) for row in rows)
    n, mism, loss_err, ms, ms_plain, ms_grid, _, dms = rows[0]
    return {"name": "chamfer_exact", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/chamfer_exact.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/chamfer_kernel.py:87",
            "max_abs_err": loss_err, "index_mismatches": mism, "ms": ms,
            "device_ms": dms, "plain_ms": ms_plain, "grid_ms": ms_grid,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "large": {"points": rows[1][0], "ms": rows[1][3],
                      "device_ms": rows[1][7], "plain_ms": rows[1][4],
                      "grid_ms": rows[1][5], "bound_ms": b_large}}


# the reference pair (ops/kernels/ref_pair.py) at the two configs' cloud
# grids: Tanks' 135x240 and LLFF's 189x252 (47,628 points: a last band
# group of 524); cases that between them swap the pair both ways, detach the
# reference and rgb_s's depths or not, give camera_mat a gradient or not,
# take band starts or none (chamfer_mode exact), shift first or scale first,
# distort or not, drop rgb_s, and read the indices on the device or the host
PAIR_SHAPES = ((135, 240), (189, 252))
PAIR_CASES = {
    "stock": dict(swap=False, detach_ref=True, detach_rgbs=False,
                  cam_grad=False, band=True, shift_first=False,
                  learn_dist=True, scale_pcs=True, rgb=True,
                  auto_mask=False, host_idx=False),
    "swap": dict(swap=True, detach_ref=False, detach_rgbs=True,
                 cam_grad=True, band=True, shift_first=True,
                 learn_dist=True, scale_pcs=True, rgb=True,
                 auto_mask=False, host_idx=False),
    "exact": dict(swap=False, detach_ref=False, detach_rgbs=True,
                  cam_grad=True, band=False, shift_first=False,
                  learn_dist=True, scale_pcs=False, rgb=True,
                  auto_mask=True, host_idx=True),
    "swap_no_rgb": dict(swap=True, detach_ref=True, detach_rgbs=False,
                        cam_grad=False, band=True, shift_first=False,
                        learn_dist=False, scale_pcs=True, rgb=False,
                        auto_mask=False, host_idx=True),
}


def ref_pair_case(dev, hs, ws, case, seed=SEED):
    """The inputs of one :data:`PAIR_CASES` pair on an (hs, ws) grid: a
    4-frame table of noisy depth maps of one smooth surface with a corner
    patch of near depths (some below the near limit, some behind the later
    camera once moved), smooth images, seeded poses, distortion scalars and
    the stock camera matrix's form. Returns (make, spec, cotangents): each
    ``make()`` gives fresh leaves as ``ref_pair``'s positional arguments."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.geometry.rays import rigid_inv
    from nope_nerf_tpu_torch.geometry.so3 import make_c2w
    from nope_nerf_tpu_torch.ops.kernels.ref_pair import PairSpec

    c = PAIR_CASES[case]
    rng = np.random.default_rng(seed)
    frames = 4
    yy, xx = np.meshgrid(np.linspace(0, 1, hs), np.linspace(0, 1, ws),
                         indexing="ij")
    dtab = (2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
            + 0.02 * rng.normal(size=(frames, hs, ws)))
    dtab[:, :hs // 8, :ws // 8] = rng.uniform(-0.02, 0.06,
                                              (frames, hs // 8, ws // 8))
    freq = rng.uniform(2, 6, (frames, 1, 1, 3))
    phase = rng.uniform(0, 6, (frames, 1, 1, 3))
    itab = 0.5 + 0.4 * np.sin(freq * xx[None, ..., None]
                              + 0.7 * freq * yy[None, ..., None] + phase)
    c2ws = [make_c2w(torch.tensor(rng.normal(0, 0.06, 3), dtype=torch.float32),
                     torch.tensor(rng.normal(0, 0.15, 3), dtype=torch.float32))
            for _ in range(frames)]
    idx, ref = (frames - 1, 1) if c["swap"] else (1, 2)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    dtab, itab = t(dtab), t(itab)
    cam = t([[1.6, 0, 0, 0], [0, -2.844, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]])
    c2w, c2w_ref = c2ws[idx].to(dev), c2ws[ref].to(dev)
    scalars = [t([v]) for v in (1.05, 0.02, 0.95, -0.03)]
    if c["host_idx"]:
        rows = (idx, idx, ref)
    else:
        rows = tuple(torch.tensor(v, dtype=torch.int64, device=dev)
                     for v in (idx, idx, ref))
    spec = PairSpec(num_cams=frames, nearest_limit=0.01,
                    shift_first=c["shift_first"], learn_dist=c["learn_dist"],
                    scale_pcs=c["scale_pcs"], use_rgb_s=c["rgb"],
                    detach_rgbs_scale=c["detach_rgbs"],
                    auto_mask=c["auto_mask"],
                    band_tiles=max(2, round(32 * ws / 1024)) if c["band"]
                    else None)
    n = hs * ws
    gen = torch.Generator(device=dev).manual_seed(seed)
    cots = [torch.randn(s, generator=gen, device=dev) / n
            for s in ((n, 3), (n, 3), (hs, ws, 3))]

    def make():
        grads = (True, True, not c["detach_ref"], True, True,
                 not c["detach_ref"], not c["detach_ref"], c["cam_grad"])
        mats = [m.clone().requires_grad_(g) for m, g in zip(
            (c2w, rigid_inv(c2w), c2w_ref, *scalars, cam), grads)]
        return ((dtab, rows[1], rows[2]),
                (itab, rows[1], rows[2]) if c["rgb"] else None, rows[0],
                *mats)

    return make, spec, cots


PAIR_GRADS = ("c2w", "world_mat", "c2w_ref", "scale_cur", "shift_cur",
              "scale_ref", "shift_ref", "camera_mat")


def run_pair(fn, args, spec, cots):
    """``fn`` (``ref_pair`` or its plain version) on ``args``: its outputs
    and the gradients of <outputs, cotangents> to every leaf that takes one
    ({name: gradient})."""
    import torch

    out = fn(*args, spec)
    outs = [out["X"], out["Y"]]
    if spec.use_rgb_s:
        outs.append(out["rgb_pc1_proj"])
    names = [n for n, a in zip(PAIR_GRADS, args[3:]) if a.requires_grad]
    leaves = [a for a in args[3:] if a.requires_grad]
    # a leaf the route does not reach (world_mat when the pair keeps its
    # order on the host) gets zeros, as the kernel gives it
    grads = torch.autograd.grad(outs, leaves, cots[:len(outs)],
                                allow_unused=True, materialize_grads=True)
    return out, dict(zip(names, grads))


def pair_start_margins(out, args, spec):
    """Per band group and direction, how many grid rows the plain route's
    median row hint lies from the nearest rounding boundary of its start
    tile (hints recomputed from its outputs, within a few ulps)."""
    import torch

    from nope_nerf_tpu_torch.geometry.rays import project_to_cam, rigid_inv
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    (dtab, _, _), _, idx, c2w, world, c2w_ref, sc_cur, _, sc_ref, _, cam = \
        args
    hs, ws = dtab.shape[1:3]
    swap = bool(idx >= spec.num_cams - 1)
    rt = (world @ c2w_ref if swap else rigid_inv(c2w_ref) @ c2w).detach()
    s2 = (sc_cur if swap else sc_ref).detach() if spec.scale_pcs else 1.0
    X, Y = out["X"].detach() * s2, out["Y"].detach() * s2
    q21 = (Y - rt[:3, 3]) @ rt[:3, :3]
    margins = []
    for pts in (X, q21):
        xy, _ = project_to_cam(pts, cam.detach())
        row = (xy[:, 1] + 1.0) * 0.5 * (hs - 1)
        n = row.shape[0]
        pad = torch.full((-(-n // cb.QB) * cb.QB - n,), float("nan"),
                         device=row.device)
        groups = torch.cat([row, pad]).reshape(-1, cb.QB)
        finite = torch.isfinite(groups)
        srt = torch.sort(torch.where(finite, groups, 3.4e38), dim=1).values
        n_fin = finite.sum(1)
        med = torch.gather(srt, 1, torch.clamp((n_fin - 1) // 2, 0)[:, None])
        tiles = med[:, 0] * ws / cb.TILE
        margins.append(torch.abs(tiles - torch.floor(tiles) - 0.5)
                       * cb.TILE / ws)
    return margins


def ref_pair_readings(dev, hs, ws, case):
    """The kernel route against the plain version on one case: each
    output's largest difference (X and Y relative to their largest value,
    rgb_pc1_proj absolute), the masks' and start tiles' mismatches (with the
    largest boundary margin among the mismatched groups), each gradient's
    largest difference relative to its largest value, whether a rerun is
    bitwise, and how many points the case clamps or projects outside."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import ref_pair as rp

    make, spec, cots = ref_pair_case(dev, hs, ws, case)
    kernel = run_pair(rp.ref_pair, make(), spec, cots)
    again = run_pair(rp.ref_pair, make(), spec, cots)
    args = make()
    plain = run_pair(rp.ref_pair_reference, args, spec, cots)
    (ko, kg), (po, pg) = kernel, plain

    def rel(a, b):
        a, b = a.detach(), b.detach()
        return float(torch.max(torch.abs(a - b))
                     / torch.clamp_min(torch.max(torch.abs(b)), 1e-30))

    r = {"X": rel(ko["X"], po["X"]), "Y": rel(ko["Y"], po["Y"]),
         "grads": {k: rel(kg[k], pg[k]) for k in pg},
         "grad_names": sorted(kg) == sorted(pg)}
    if spec.use_rgb_s:
        r["rgb_abs"] = float(torch.max(torch.abs(ko["rgb_pc1_proj"]
                                                 - po["rgb_pc1_proj"])))
        r["valid_mismatches"] = int(torch.sum(ko["valid_points"]
                                              != po["valid_points"]))
        r["outside"] = int(torch.sum(po["valid_points"] == 0))
        r["images_equal"] = all(
            torch.equal(ko[k], po[k]) for k in ("rgb_pc1", "rgb_pc1_ori")
            if k in po)
    if spec.band_tiles is not None:
        margins = pair_start_margins(po, args, spec)
        mism = [ks != ps for ks, ps in zip(ko["chamfer_starts"],
                                           po["chamfer_starts"])]
        r["start_mismatches"] = int(sum(int(m.sum()) for m in mism))
        r["start_margin_of_mismatch"] = max(
            [float(mg[m].max()) for mg, m in zip(margins, mism) if m.any()],
            default=0.0)
        r["start_groups"] = int(po["chamfer_starts"][0].numel())
    else:
        r["no_starts"] = "chamfer_starts" not in ko
    ao, ag = again
    r["bitwise_rerun"] = (
        all(torch.equal(ko[k], ao[k]) for k in ("X", "Y", "rgb_pc1_proj",
                                                "valid_points") if k in ko)
        and all(torch.equal(a, b) for a, b in zip(
            ko.get("chamfer_starts", ()), ao.get("chamfer_starts", ())))
        and all(torch.equal(kg[k], ag[k]) for k in kg))
    return r


# the kernel route against the plain version (ref_pair_readings), on an
# H100 at 700 W (PERF.md): X and Y within 1e-6 of their largest coordinate
# (read: 1.9e-7; the rotation's three-term sums are FMA chains in index
# order, cuBLAS's order may differ in the last bit); rgb_pc1_proj within
# 2e-4 (read: 5.4e-5; a point near the later camera's centre, the corner
# patch, magnifies that last bit through the projection's division); each
# gradient within 1e-4 of its largest entry (read: 2.1e-5; f32 sums over the
# cloud in another order); the masks and the rgb_s images equal; a start tile
# may differ only in a group whose median row hint lies within 1e-3 rows of
# its rounding boundary; a rerun bitwise
PAIR_BARS = {"X": 1e-6, "Y": 1e-6, "rgb_abs": 2e-4, "grad": 1e-4,
             "start_margin": 1e-3}


def ref_pair_faults(r):
    """What in one :func:`ref_pair_readings` breaks :data:`PAIR_BARS`."""
    bad = [f"{k} {r[k]:.3e}" for k in ("X", "Y", "rgb_abs")
           if k in r and not r[k] <= PAIR_BARS[k]]
    bad += [f"d/d{k} {v:.3e}" for k, v in r["grads"].items()
            if not v <= PAIR_BARS["grad"]]
    if not r["grad_names"]:
        bad.append("gradients to other leaves")
    if r.get("valid_mismatches") or r.get("images_equal") is False:
        bad.append(f"masks {r.get('valid_mismatches')} mismatches, images "
                   f"equal {r.get('images_equal')}")
    if r.get("start_margin_of_mismatch", 0.0) > PAIR_BARS["start_margin"]:
        bad.append(f"{r['start_mismatches']} start tiles, one "
                   f"{r['start_margin_of_mismatch']:.3e} rows from its "
                   "boundary")
    if r.get("no_starts") is False:
        bad.append("band starts without band")
    if not r["bitwise_rerun"]:
        bad.append("a rerun differs")
    return bad


def check_ref_pair(dev, card):
    """The reference pair's kernels (csrc/ref_pair.cu) against the plain
    version at both configs' cloud grids (PAIR_SHAPES), every PAIR_CASES
    case, forward and backward, held to PAIR_BARS; then at each grid the
    stock case's forward + backward timed in turns against the plain
    version (the step's tensor code before the kernel), with each one's
    launches, beside the bytes' bound. No single PyTorch call computes the
    pair (``library_ms`` None)."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import ref_pair as rp

    readings, timings = {}, {}
    for hs, ws in PAIR_SHAPES:
        for case in PAIR_CASES:
            r = ref_pair_readings(dev, hs, ws, case)
            readings[f"{hs}x{ws} {case}"] = r
            bad = ref_pair_faults(r)
            if bad:
                raise AssertionError(f"ref_pair {hs}x{ws} {case}: "
                                     + "; ".join(bad))
        make, spec, cots = ref_pair_case(dev, hs, ws, "stock")
        args = make()

        def call(fn, args=args, spec=spec, cots=cots):
            return lambda: run_pair(fn, args, spec, cots)

        new, old = call(rp.ref_pair), call(rp.ref_pair_reference)
        t = pair_turns(new, old)
        out = rp.ref_pair(*args, spec)
        io = [args[0][0][0], args[0][0][0], args[1][0][0], args[1][0][0],
              *(v for v in out.values() if torch.is_tensor(v)), *cots,
              *out["chamfer_starts"]]
        b_ms, b_by = bound(nbytes=nbytes(*io))
        timings[f"{hs}x{ws}"] = {
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["earlier_ms"],
            "plain_device_ms": t["earlier_device_ms"],
            "launches": kernel_launches(new),
            "plain_launches": kernel_launches(old), "bound_ms": b_ms,
            "bound_by": b_by}
    worst = {k: max(r.get(k, 0.0) for r in readings.values())
             for k in ("X", "Y", "rgb_abs")}
    worst["grad"] = max(v for r in readings.values()
                        for v in r["grads"].values())
    print(f"ref_pair [{card}] {len(readings)} cases at {PAIR_SHAPES}: "
          f"worst {worst} (bars {PAIR_BARS}), start tiles mismatched "
          f"{sum(r.get('start_mismatches', 0) for r in readings.values())},"
          f" reruns bitwise; forward + backward: " + "; ".join(
              f"{k} kernel {v['ms']:.4f} ms (device {v['device_ms']:.4f}, "
              f"{v['launches']} launches), plain {v['plain_ms']:.4f} "
              f"(device {v['plain_device_ms']:.4f}, {v['plain_launches']} "
              f"launches), bound {v['bound_ms']:.5f} ({v['bound_by']})"
              for k, v in timings.items()))
    stock = timings["135x240"]
    return {"name": "ref_pair", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/ref_pair.cu",
            "replaces": "none (training/trainer.py compute_loss's pair)",
            "worst": worst, "ms": stock["ms"],
            "device_ms": stock["device_ms"], "plain_ms": stock["plain_ms"],
            "plain_device_ms": stock["plain_device_ms"],
            "bound_ms": stock["bound_ms"], "bound_by": stock["bound_by"],
            "library_ms": None, "shapes": timings}


def gemm_ulps(out, ref):
    """max |out - ref| in bf16 ulps of max(|ref|, |out|, max|ref| / 256)
    (see GEMM_ULPS)."""
    import torch

    out, ref = out.float(), ref.float()
    mag = torch.maximum(torch.maximum(ref.abs(), out.abs()),
                        ref.abs().max() / 256)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.max((out - ref).abs() / ulp))


# the fused backward pass (csrc/mlp_fused_bwd.cu) at each pass of the
# backward: (pass, width of the input's first group, of its second (0:
# none), N, masked, rank-1 term); the first group's output is f32 where it
# is an encoding's (63 wide)
FUSED_BWD_CASES = (
    ("rgb_layer [feat | denc]", 256, 27, 128, False, False),
    ("fc_feature + fc_density", 256, 0, 256, True, True),
    ("trunk", 256, 0, 256, True, False),
    ("trunk1_0 [a03 | enc]", 256, 63, 256, True, False),
    ("trunk0_0", 63, 0, 256, False, False),
)


def check_fused_bwd(dev, card):
    """The fused backward pass at each pass of Kernel A's and C's backward
    at M = 131,072: its input gradients (bf16 in ulps, f32 in relL2), column
    sums and weight gradients (fc_density's too) against
    ``gemm_dwgrad_reference``, a bitwise rerun, and its device time (the
    split reduction included) beside the plain version and the memory
    bound."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    M = N_RAYS * N_SAMPLES
    bf, f32 = torch.bfloat16, torch.float32

    def rows(k, scale=1.0):
        """bf16 (M, k) normal values with NaN in the row padding."""
        buf = torch.full((M, mk._pad8(k)), float("nan"), dtype=bf, device=dev)
        buf[:, :k] = torch.randn((M, k), generator=gen, device=dev) * scale
        return buf[:, :k]

    def out_buf(k, dtype):
        return torch.empty((M, mk._pad8(k)), dtype=dtype, device=dev)[:, :k]

    table, worst_err = {}, 0.0
    for name, K0, K1, N, masked, rank1 in FUSED_BWD_CASES:
        g = rows(N, 1e-2)
        xs = [rows(k) if k else None for k in (K0, K1)]
        w = mk._padded(torch.randn((K0 + K1, N), generator=gen, device=dev)
                       * N ** -0.5)
        ws = (w[:K0], w[K0:])
        g_raw = torch.randn((M, 4), generator=gen, device=dev) * 1e-2
        wd = torch.randn((K0,), generator=gen, device=dev).to(bf)
        rank = dict(gsig=g_raw[:, 0], wd=wd) if rank1 else {}
        dt0 = f32 if K0 % 64 else bf

        def groups():
            dw = torch.empty((K0 + K1, N), device=dev)
            gs = [mk.DwGroup(ws[0], out_buf(K0, dt0), x=xs[0], mask=masked,
                             colsum=(torch.empty(K0, device=dev)
                                     if dt0 == bf else None), dw=dw[:K0])]
            if K1:
                gs.append(mk.DwGroup(ws[1], out_buf(K1, f32), x=xs[1],
                                     dw=dw[K0:]))
            return gs

        def new(gs=None):
            gs = groups() if gs is None else gs
            dwd = torch.empty((K0, 1), device=dev) if rank1 else None
            mk.gemm_dwgrad(g, gs, dwd=dwd, **rank)
            return gs, dwd

        def plain():
            return [mk.gemm_dwgrad_reference(
                g.float(), ws[i].float(), xs[i].float(),
                xs[i].float() if masked and i == 0 else None,
                g_raw[:, 0] if rank1 and i == 0 else None,
                wd.float() if rank1 and i == 0 else None)
                for i in range(2 if K1 else 1)]

        (got, dwd), (again, dwd2) = new(), new()
        ref = plain()
        torch.cuda.synchronize()
        errs, bitwise = {}, True
        for i, (grp, (y, dw_ref)) in enumerate(zip(got, ref)):
            bitwise &= torch.equal(grp.out, again[i].out) and torch.equal(
                grp.dw, again[i].dw)
            errs[f"out{i}"] = (gemm_ulps(grp.out, y.to(bf)) if grp.out.dtype
                               == bf else rel_l2(grp.out, y))
            errs[f"dw{i}"] = rel_l2(grp.dw, dw_ref)
            if grp.colsum is not None:
                bitwise &= torch.equal(grp.colsum, again[i].colsum)
                errs["colsum"] = rel_l2(grp.colsum, y.sum(0))
        if rank1:
            bitwise &= torch.equal(dwd, dwd2)
            errs["fc_density dw"] = rel_l2(dwd, mk.gemm_wgrad_reference(
                xs[0].float(), g_raw[:, :1]))
        finite = all(bool(torch.isfinite(grp.out.float()).all())
                     and bool(torch.isfinite(grp.dw).all()) for grp in got)
        ms = device_ms(new, iters=20)
        ms_plain = device_ms(plain, iters=3, warmup=1)
        K = K0 + K1
        moved = (2.0 * M * N + 2.0 * M * K
                 + M * (K0 * (2 if dt0 == bf else 4) + 4 * K1)
                 + 2.0 * K * N + 4.0 * K * N + (4.0 * M if rank1 else 0.0))
        b_ms, b_by = bound(2.0 * 2 * M * K * N, moved)
        ulps = [v for k, v in errs.items() if k.startswith("out")
                and got[int(k[3:])].out.dtype == bf]
        rels = [v for k, v in errs.items() if k not in
                [f"out{i}" for i, grp in enumerate(got)
                 if grp.out.dtype == bf]]
        rec = {"K": [K0, K1], "N": N, "mask": masked, "rank1": rank1,
               "errors": errs, "bitwise_rerun": bitwise, "ms": ms,
               "plain_ms": ms_plain, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by,
               "gb_per_s": moved / ms / 1e6,
               "max_abs_err": max(float(torch.max(torch.abs(
                   grp.out.float() - y))) for grp, (y, _) in zip(got, ref))}
        table[name] = rec
        worst_err = max(worst_err, rec["max_abs_err"])
        print(f"fused bwd pass {name} [{card}] M={M} K={K0}+{K1} N={N}: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (bf16 outputs in ulps, the rest relL2); bitwise rerun "
              f"{bitwise}; {ms:.4f} ms device, plain {ms_plain:.3f} ms; "
              f"{rec['gb_per_s']:.0f} GB/s, bound {b_ms:.4f} ms ({b_by})")
        if not (finite and bitwise and all(u <= GEMM_ULPS for u in ulps)
                and all(r <= 1e-5 for r in rels)):
            raise AssertionError(f"fused bwd pass {name}: {errs}, bitwise "
                                 f"{bitwise}, finite {finite}")
    head = table["trunk"]
    return {"name": "mlp_fused_bwd", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/mlp_fused_bwd.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
            "also_serves": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:258",
            "shape": "one 256x256 trunk layer at M=131072, weight gradient "
                     "included",
            "max_abs_err": worst_err, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "library_ms": None,
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "shapes": table}


# the input-only backward (csrc/mlp_input_bwd.cu): the pose step's shape
# (stock rays x samples, D = 256) and the recovery scripts' (D = 128, 64
# samples); the first is the kernel table's row
INPUT_BWD_SHAPES = (("pose", N_RAYS, N_SAMPLES, None),
                    ("recovery", N_RAYS, 64, 128))


def input_bwd_bound(m, D, H2, n_pos, n_dir, flops):
    """(bound ms, what sets it, bytes) of the input-only backward on ``m``
    rows: each input read once (the 8 trunk outputs and hr, bf16, for the
    masks; g_raw f32), each output written once (the three f32 encoding
    cotangents); the weights (~1.2 MB, read from L2 by every tile) left
    out; ``flops`` the forward's products (the backward computes their input
    gradients)."""
    moved = m * (2.0 * (8 * D + H2) + 16.0 + 4.0 * (2 * n_pos + n_dir))
    ms, by = bound(flops, moved)
    return ms, by, moved


def check_input_bwd(dev, card):
    """The input-only backward (one launch of csrc/mlp_input_bwd.cu) at
    INPUT_BWD_SHAPES on the saves of a fused forward and the g_raw of its
    compositing backward: its three encoding cotangents bit for bit those
    of the ten-pass input-only chain (``_chain_bwd(..., weight_grads=
    False)``: heads_bwd_fused and ten launches of csrc/mlp_fused_bwd.cu), a
    rerun bit for bit, one launch and its tiles counted, the plain version
    (``input_bwd_reference`` on the card: the same roundings, its f32 sums
    in torch's order, so bf16 flips carry down the chain) within
    GRAD_RELL2; then timed in turns with the ten passes (events, profiler
    device time), the plain version once, beside its bound."""
    import torch

    from nope_nerf_tpu_torch import tracing
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    table = {}
    for label, N, S, hidden in INPUT_BWD_SHAPES:
        (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
         t) = stock_mlp_inputs(dev, N, S, hidden)
        static = (cfg["model"]["pos_enc_levels"],
                  cfg["model"]["dir_enc_levels"],
                  cfg["model"]["occ_activation"], True, False, False, S)
        frozen = [w.detach() for w in weights]
        with torch.no_grad():
            _, dims, saved = mk._composite_fwd(
                *(x.detach().contiguous() for x in (origins, rays_t, dirs)),
                z_t, deltas_t, static, frozen, save=True)
        enc, denc, feat, hr, raw = saved[5:10]
        acts = list(saved[10:18])
        Wb, Wh = mk._weight_dicts(saved[18:])
        M = N * S
        g_raw = mk.composite_bwd(
            raw, z_t, deltas_t, t(rng.normal(size=(N, 3)) / N),
            t(rng.normal(size=(N, 1)) / N), torch.zeros((N, S), device=dev),
            (static[2] == "softplus", True, False, False))

        def new():
            return mk.input_bwd(Wb, Wh, g_raw, hr, acts, dims)

        def ten():
            return mk._chain_bwd(Wb, Wh, g_raw, enc, denc, S, feat, hr, acts,
                                 M, dims, weight_grads=False)

        def plain():
            return mk.input_bwd_reference(Wb, Wh, g_raw, hr, acts, dims)

        counters = (mk.MLP_INPUT_BWD_LAUNCHES, mk.MLP_FUSED_BWD_LAUNCHES)
        n0 = [c.count for c in counters]
        tiles0 = tracing.counters().get("mlp.input_bwd_tiles", 0)
        (g1, g2), g3 = new()
        launches = [c.count - n for c, n in zip(counters, n0)]
        tiles = tracing.counters()["mlp.input_bwd_tiles"] - tiles0
        (r1, r2), r3 = new()
        _, (p1, p2), p3 = ten()
        (q1, q2), q3 = plain()
        torch.cuda.synchronize()
        got, again, passes = (g1, g2, g3), (r1, r2, r3), (p1, p2, p3)
        names = ("g_enc_skip", "g_enc", "g_denc")
        bitwise = {n: torch.equal(a, b) for n, a, b in zip(names, got, passes)}
        rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, got, (q1, q2, q3))}
        if not all(bitwise.values()):
            gaps = {n: float(torch.max(torch.abs(a - b)))
                    for n, a, b in zip(names, got, passes)}
            print(f"input-only bwd {label}: max |kernel - ten passes| {gaps}")
        turns = pair_turns(new, ten, plain, iters=20)
        n_pos, n_dir, D, H2 = dims
        flops = 2.0 * M * sum(w.numel() for w in weights[0::2])
        b_ms, b_by, moved = input_bwd_bound(M, D, H2, n_pos, n_dir, flops)
        rec = dict(turns, rows=M, hidden=D, bitwise_vs_passes=bitwise,
                   max_abs_err=max(float(torch.max(torch.abs(a - b)))
                                   for a, b in zip(got, (q1, q2, q3))),
                   rerun_bitwise=rerun, plain_rel_l2=errs,
                   launches=launches, tiles=tiles, bound_ms=b_ms,
                   bound_by=b_by, ops_bound_ms=1e3 * flops / BF16_FLOPS,
                   bytes_bound_ms=1e3 * moved / HBM_BYTES,
                   roofline_pct=100.0 * b_ms / turns["device_ms"])
        table[label] = rec
        print(f"input-only bwd {label} [{card}] M={M} D={D}: bitwise vs the "
              f"ten passes {bitwise}, rerun {rerun}, plain relL2 "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; launches (input_bwd, fused passes) {launches}, tiles "
              f"{tiles}; device {turns['device_ms']:.4f} ms (events "
              f"{turns['ms']:.4f}) against the ten passes' "
              f"{turns['earlier_device_ms']:.4f} ({turns['earlier_ms']:.4f})"
              f", plain {turns['plain_ms']:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}; bytes {rec['bytes_bound_ms']:.4f}, operations "
              f"{rec['ops_bound_ms']:.4f}), {rec['roofline_pct']:.1f}%")
        if not (all(bitwise.values()) and rerun
                and launches == [1, 0] and tiles == -(-M // 128)
                and all(v <= GRAD_RELL2 for v in errs.values())):
            raise AssertionError(f"input-only bwd {label}: bitwise {bitwise}"
                                 f", rerun {rerun}, launches {launches}, "
                                 f"tiles {tiles}, plain relL2 {errs}")
    head = table["pose"]
    return {"name": "mlp_input_bwd", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/mlp_input_bwd.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
            "also_serves": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:258",
            "shape": "Kernel A's input-only backward chain at the pose step's "
                     "1024 rays x 128 samples, D = 256",
            "max_abs_err": head["max_abs_err"], "ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "library_ms": None,
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "shapes": table}


def kernel_split(fn, iters=10):
    """{kernel name: device ms per call} of ``fn`` by the profiler, the
    kernels' own time summed by name (warmed up once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {e.key: e.self_device_time_total / iters / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0}
        if split:
            return split
    raise RuntimeError("kernel_split: the profiler recorded no kernel")


def pair_turns(new, old, plain=None, iters=20):
    """Two versions of one function timed in turns in this call: new, old,
    old, new by CUDA events (``ms``, ``earlier_ms``: the means of their two
    turns), then each's device time by the profiler, and the plain
    version's events time where one is given."""
    n1, o1 = cuda_ms(new, iters), cuda_ms(old, iters)
    o2, n2 = cuda_ms(old, iters), cuda_ms(new, iters)
    out = {"ms": (n1 + n2) / 2, "earlier_ms": (o1 + o2) / 2,
           "device_ms": device_ms(new, iters),
           "earlier_device_ms": device_ms(old, iters)}
    if plain is not None:
        out["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
    return out


# Kernel A's compositing and encoding backward: the stock step's shapes, the
# k = 4 step's and the recovery scripts' (hidden 128, 64 samples)
A_BWD_SHAPES = (("stock", N_RAYS, N_SAMPLES, None),
                ("k4", 4 * N_RAYS, N_SAMPLES, None),
                ("recovery", N_RAYS, 64, 128))
# their plain versions on the card against the kernels: relL2 of g_raw and
# of each of d_origins, d_rays, d_dirs (f32, the same steps; the kernels
# contract some products into FMAs and call CUDA's sincosf, torch its sin
# and cos)
A_BWD_PLAIN_RELL2 = 1e-5


def check_composite_encode_bwd(dev, card):
    """Kernel A's compositing backward (``composite_bwd``) and encoding
    backward (``encode_bwd``) at A_BWD_SHAPES, on the inputs a full
    backward gives them (recorded on the path) and that an input-only one
    gives them (which must be the same tensors' values, bit for bit): each
    kernel's outputs against a rerun, bit for bit, and against its plain
    version (A_BWD_PLAIN_RELL2); each kernel alone timed beside its plain
    version (:func:`kernel_turns`: events and profiler device time) and its
    bound (bytes: each input read once at its true width, each output
    written once); the whole A-bwd, full and input-only: events and device
    time, launches per call, and the profiler's split of its device time by
    kernel; then Kernel C's backward at the stock step's points split
    likewise. Returns the two kernels' records and every shape's
    numbers."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    shapes = {}
    for label, N, S, hidden in A_BWD_SHAPES:
        (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
         t) = stock_mlp_inputs(dev, N, S, hidden)
        model = cfg["model"]
        static = (model["pos_enc_levels"], model["dir_enc_levels"],
                  model["occ_activation"], True, False, False, S)
        cots = (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N, 1)) / N),
                torch.zeros((N, S), device=dev))
        geo = [origins, rays_t, dirs]
        out = mk.fused_mlp_composite(weights, *geo, z_t, deltas_t, *static)
        frozen = [w.detach() for w in weights]
        out_io = mk.fused_mlp_composite(frozen, *geo, z_t, deltas_t, *static)

        def full():
            return torch.autograd.grad(out, geo + weights, cots,
                                       retain_graph=True)

        def input_only():
            return torch.autograd.grad(out_io, geo, cots, retain_graph=True)

        calls = {}
        for route, fn in (("full", full), ("input_only", input_only)):
            with recording(mk, "composite_bwd") as c_call, \
                    recording(mk, "encode_bwd") as e_call:
                fn()
            calls[route] = (c_call[-1][0], e_call[-1][0])
        same_inputs = all(
            torch.equal(a, b) if torch.is_tensor(a) else a == b
            for x, y in zip(calls["full"], calls["input_only"])
            for a, b in zip(x, y))
        c_args, e_args = calls["full"]
        torch.cuda.synchronize()
        got_c, again_c = mk.composite_bwd(*c_args), mk.composite_bwd(*c_args)
        got_e, again_e = mk.encode_bwd(*e_args), mk.encode_bwd(*e_args)
        ref_c = mk.composite_bwd_reference(*c_args)
        ref_e = mk.encode_bwd_reference(*e_args)
        torch.cuda.synchronize()
        rerun = {"g_raw": torch.equal(got_c, again_c),
                 **{n: torch.equal(a, b) for n, a, b in
                    zip(("d_o", "d_r", "d_d"), got_e, again_e)}}
        rel = {"g_raw": rel_l2(got_c, ref_c),
               **{n: rel_l2(a, b) for n, a, b in
                  zip(("d_o", "d_r", "d_d"), got_e, ref_e)}}
        err_c = float(torch.max(torch.abs(got_c - ref_c)))
        err_e = max(float(torch.max(torch.abs(a - b)))
                    for a, b in zip(got_e, ref_e))
        finite = bool(torch.isfinite(got_c).all()) and all(
            bool(torch.isfinite(a).all()) for a in got_e)

        t_c = kernel_turns(lambda: mk.composite_bwd(*c_args),
                        lambda: mk.composite_bwd_reference(*c_args), iters=20)
        t_e = kernel_turns(lambda: mk.encode_bwd(*e_args),
                        lambda: mk.encode_bwd_reference(*e_args), iters=20)
        t_full = {"ms": cuda_ms(full), "device_ms": device_ms(full)}
        t_io = {"ms": cuda_ms(input_only), "device_ms": device_ms(input_only)}
        launches = {"full": kernel_launches(full),
                    "input_only": kernel_launches(input_only)}
        split = {"full": kernel_split(full),
                 "input_only": kernel_split(input_only)}
        M = N * S
        n_pos, n_dir = (3 * (2 * static[0] + 1), 3 * (2 * static[1] + 1))
        b_c = bound(nbytes=nbytes(*c_args[:6]) + nbytes(got_c))
        b_e = bound(nbytes=4.0 * M * (2 * n_pos + n_dir + 1)
                    + nbytes(*e_args[:3]) + nbytes(*got_e))
        rec = {"rays": N, "samples": S, "hidden": model["hidden_dim"],
               "rerun_bitwise": rerun,
               "input_only_inputs_equal_full": same_inputs,
               "rel_l2_to_plain": rel, "composite_max_abs_err": err_c,
               "encode_max_abs_err": err_e,
               "composite_bwd": {**t_c, "bound_ms": b_c[0],
                                 "bound_by": b_c[1]},
               "encode_bwd": {**t_e, "bound_ms": b_e[0], "bound_by": b_e[1]},
               "a_bwd_full": t_full, "a_bwd_input_only": t_io,
               "a_bwd_launches_per_call": launches,
               "a_bwd_device_ms_by_kernel": split}
        shapes[label] = rec
        print(f"kernel A compositing / encoding backward [{card}] {label} "
              f"{N} x {S} D={model['hidden_dim']}: reruns bitwise {rerun}, "
              f"the input-only backward's inputs equal {same_inputs}; "
              "relL2 to plain " + " ".join(f"{k}={v:.2e}" for k, v in
                                            rel.items())
              + f"; composite_bwd {t_c['ms']:.4f} ms (device "
              f"{t_c['device_ms']:.4f}), plain {t_c['plain_ms']:.3f}, bound "
              f"{b_c[0]:.4f} ({b_c[1]}); encode_bwd {t_e['ms']:.4f} ms "
              f"(device {t_e['device_ms']:.4f}), plain {t_e['plain_ms']:.3f}"
              f", bound {b_e[0]:.4f} ({b_e[1]}); A-bwd full device "
              f"{t_full['device_ms']:.4f}, input-only "
              f"{t_io['device_ms']:.4f}; launches {launches}")
        print(f"kernel A bwd device ms by kernel [{card}] {label}: "
              + json.dumps(split))
        fails = [f"{k} rerun" for k, v in rerun.items() if not v]
        fails += [f"{k} relL2 {v:.3e}" for k, v in rel.items()
                  if not v < A_BWD_PLAIN_RELL2]
        if not same_inputs:
            fails.append("the input-only backward's kernel inputs differ")
        if not finite:
            fails.append("non-finite outputs")
        if fails:
            raise AssertionError(f"kernel A compositing / encoding backward "
                                 f"{label}: {fails}")
    # Kernel C's backward at the stock step's points, split by kernel: the
    # per-point kernels (head_act_bwd, encode_points_bwd) it runs beside its
    # passes
    (cfg, weights, origins, rays_t, dirs, z_t, _, rng,
     t) = stock_mlp_inputs(dev)
    model = cfg["model"]
    pts = (origins[:, None, :] + rays_t[:, None, :] * z_t[..., None]).reshape(
        -1, 3).detach().requires_grad_()
    view = dirs[:, None, :].expand(N_RAYS, N_SAMPLES, 3).reshape(-1, 3) \
        .detach().contiguous().requires_grad_()
    M = pts.shape[0]
    cots = (t(rng.normal(size=(M, 3)) / M), t(rng.normal(size=(M, 1)) / M))
    out = mk.fused_mlp(weights, pts, view, model["pos_enc_levels"],
                       model["dir_enc_levels"], model["occ_activation"], True)
    c_split = kernel_split(
        lambda: torch.autograd.grad(out, [pts, view] + weights, cots,
                                    retain_graph=True))
    print(f"kernel C bwd device ms by kernel [{card}] {M} points: "
          + json.dumps(c_split))
    stock = shapes["stock"]
    records = []
    for name, line, err, part in (
            ("composite_bwd", 637, "composite_max_abs_err",
             "_composite_bwd (l.637) + _act_bwd (l.228)"),
            ("encode_bwd", 134, "encode_max_abs_err",
             "_encode_bwd (l.134) with the ray sums (l.764, l.786-792)")):
        t = stock[name]
        records.append({
            "name": name, "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
            "replaces_part": f"nope_nerf_tpu/ops/pallas/mlp_kernel.py:{line}",
            "part": part,
            "max_abs_err": stock[err], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"], "rerun_bitwise": True,
            "shapes": {k: v[name] for k, v in shapes.items()}})
    return records, dict(shapes, c_bwd_device_ms_by_kernel=c_split)


def kernel_counters():
    """The launch counters of the six kernels, the fused forward and the
    compositing after it (Kernel A's raw route), the fused backward pass,
    the input-only backward, the launches that serve only the weight
    gradients, Kernel A's
    compositing and encoding backward, and the reference pair's forward and
    backward."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.kernels import ref_pair as rp

    return (mk.FWD_LAUNCHES, mk.BWD_LAUNCHES, cb.LAUNCHES,
            mk.FWD_POINT_LAUNCHES, mk.BWD_POINT_LAUNCHES, ck.LAUNCHES,
            mk.MLP_FUSED_FWD_LAUNCHES, mk.COMPOSITE_AFTER_LAUNCHES,
            mk.MLP_FUSED_BWD_LAUNCHES, mk.MLP_INPUT_BWD_LAUNCHES,
            mk.WGRAD_LAUNCHES,
            mk.COMPOSITE_BWD_LAUNCHES, mk.ENCODE_BWD_LAUNCHES, rp.LAUNCHES,
            rp.BWD_LAUNCHES)


def check_gemm_counts(label, counts, weight_grads=True):
    """Every forward of Kernels A and C ran as one launch of the fused
    forward (csrc/mlp_fused_fwd.cu; every S on these paths tiles 128
    points, so no compositing after it); with ``weight_grads`` every
    backward ran its ten fused passes (csrc/mlp_fused_bwd.cu) and the
    launches that serve only the weight gradients (A: the per-ray direction
    half and the split reduction, 2; C: the split reduction, 1), without
    them one launch of the input-only backward (csrc/mlp_input_bwd.cu) and
    neither; every backward of A ran its compositing and its encoding
    backward once each (csrc/mlp_composite.cu's group and staged
    kernels)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    fwd = counts["mlp_composite_fwd"] + counts["mlp_point_fwd"]
    a_bwd, c_bwd = counts["mlp_composite_bwd"], counts["mlp_point_bwd"]
    per = mk.WGRAD_PER_BWD
    want = {"mlp_fused_fwd": fwd, "mlp_composite_after_fused": 0,
            "mlp_fused_bwd": (mk.FUSED_BWD_PER_BWD * (a_bwd + c_bwd)
                              if weight_grads else 0),
            "mlp_input_bwd": 0 if weight_grads else a_bwd + c_bwd,
            "mlp_weight_grad_gemm": (per["A"] * a_bwd + per["C"] * c_bwd
                                     if weight_grads else 0),
            "composite_bwd": a_bwd, "encode_bwd": a_bwd}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: GEMM launches {got} for {fwd} "
                             f"forwards and {a_bwd} + {c_bwd} backwards, "
                             f"expected {want}")


# the training runs: (label, overrides {group: {key: value}}, kernels the
# run must launch; every other kernel must stay idle). The stock config
# visualises at the first epoch's end (it crosses visualize_every 10000;
# vis_geo): the Phong preview's
# surface colour runs Kernel C's forward wherever use_pallas_mlp is on, as
# the JAX package's fused MLP does. ``multiplier`` renders 4 frames' 4,096
# rays per step through one Kernel A launch each way; ``ssim_normal`` adds
# the SSIM map to rgb_s and turns on the normal term, which no loss reads
MLP_GEMMS = ("mlp_fused_fwd", "mlp_fused_bwd", "mlp_weight_grad_gemm")
# every training step that builds the reference pair runs it one way each
PAIR_KERNELS = ("ref_pair", "ref_pair_bwd")
STOCK_KERNELS = ("mlp_composite_fwd", "mlp_composite_bwd", "chamfer_band",
                 "mlp_point_fwd", *MLP_GEMMS, *PAIR_KERNELS)
K_FRAMES = 4
RUNS = (
    ("stock", {}, STOCK_KERNELS),
    ("unfused_exact", {"tpu": {"fuse_compositing": False,
                               "chamfer_mode": "exact"}},
     ("mlp_point_fwd", "mlp_point_bwd", "chamfer_exact", *MLP_GEMMS,
      *PAIR_KERNELS)),
    ("parity", {"tpu": {"parity": True}}, ("chamfer_exact", *PAIR_KERNELS)),
    ("multiplier", {"tpu": {"rays_per_step_multiplier": K_FRAMES}},
     STOCK_KERNELS),
    ("ssim_normal", {"training": {"with_ssim": True},
                     "rendering": {"normal_loss": True}}, STOCK_KERNELS),
    ("multiplier_per_step", {"tpu": {"rays_per_step_multiplier": K_FRAMES,
                                     "epoch_scan": False}}, STOCK_KERNELS),
)
# the runs whose Kernel A training call is held against its plain version:
# the scan path's (its warm-up step) and the per-step path's, both at k = 4
KERNEL_A_RUNS = ("multiplier", "multiplier_per_step")
# the launches of every step of these runs: Kernel A once each way (at k = 4
# too: the point of rendering the frames as one batch), its forward one
# fused launch, Kernel B twice (the pc loss's two directions), the reference
# pair once each way
PER_STEP = {"mlp_composite_fwd": 1, "mlp_composite_bwd": 1,
            "mlp_fused_fwd": 1, "chamfer_band": 2, "composite_bwd": 1,
            "encode_bwd": 1, "ref_pair": 1, "ref_pair_bwd": 1}
# the kernels every backward of Kernel A launches once besides its passes
A_BWD_KERNELS = ("composite_bwd", "encode_bwd")


def run_training(dev, card, label, overrides, expect):
    """Train the stock configuration with ``overrides`` for EPOCHS epochs
    through the port's ``train`` in a fresh ``out_dir`` (a run there would
    otherwise resume from the last one's checkpoints); return the launch
    counts of that run, its state, its config, its history and each step's
    launches."""
    import math

    import torch

    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import train

    cfg = stock_cfg()
    for group, values in overrides.items():
        cfg[group].update(values)
    # the stock run's directory comes back (the eval phase reads it); the
    # others stay under build/ and go when their checks pass, so that what
    # the run returns stays small
    cfg["training"]["out_dir"] = (
        os.path.join(ROOT, "chiprun_out", "chip_smoke", label)
        if label == "stock" else os.path.join(WORK, "runs", label))
    cfg["training"]["seed"] = SEED
    shutil.rmtree(cfg["training"]["out_dir"], ignore_errors=True)
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    torch.cuda.empty_cache()  # every run starts from the same allocator state
    counters = reset_counts()
    with per_step_launches() as step_counts:
        state, _, _, history = train(cfg, max_epochs=EPOCHS, scene=scene,
                                     device=dev)
    counts = executed(counters)
    for h in history:
        print(f"{label} epoch {h['epoch']} [{card}]: {h['steps']} steps, "
              f"loss {h['loss']:.6f}, {h['ms_per_step']:.3f} ms/step wall "
              f"({h['device_ms_per_step']:.3f} device), "
              f"{h['rays_per_sec']:.1f} rays/s; ATE {h['ate_trans']:.5f}, "
              f"RPE trans {h['rpe_trans']:.5f}, rot {h['rpe_rot']:.5f} deg")
    steps = sum(h["steps"] for h in history)
    if steps != EPOCHS * N_FRAMES:
        raise AssertionError(f"{label}: {steps} training steps, expected "
                             f"{EPOCHS * N_FRAMES}")
    bad = [h for h in history for v in h["step_losses"] if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite training loss")
    check_launches(label, counts, expect)
    ckpts = sorted(f for f in os.listdir(cfg["training"]["out_dir"])
                   if f.endswith(".npz"))
    if "model.npz" not in ckpts or "model_pose.npz" not in ckpts:
        raise AssertionError(f"{label}: checkpoints not written: {ckpts}")
    print(f"{label} training launches: {counts}; checkpoints {ckpts}")
    if label != "stock":
        shutil.rmtree(cfg["training"]["out_dir"])
    return counts, state, cfg, history, step_counts


@contextlib.contextmanager
def per_step_launches():
    """Inside the block, each call of a step body that
    ``training.trainer.make_step_body`` makes (the per-step path's and the
    epoch step's) appends its kernels' launch counts to the yielded list:
    an eager step's launches, or those a capture records into its graph,
    which every replay of the graph runs again; and under ``use_ref``
    whether that step builds the reference pair (its static flag), whose
    point clouds the Chamfer kernels match."""
    from nope_nerf_tpu_torch.training import trainer as module

    real = module.make_step_body
    steps = []

    def make(*args, **kwargs):
        body = real(*args, **kwargs)

        def counted(*step_args, **step_kwargs):
            counters = kernel_counters()
            before = [c.count + c.captured for c in counters]
            out = body(*step_args, **step_kwargs)
            static = (step_args[3] if len(step_args) > 3
                      else step_kwargs["static"])
            steps.append({c.name: c.count + c.captured - b
                          for c, b in zip(counters, before)})
            steps[-1]["use_ref"] = bool(static["use_ref"])
            return out
        return counted

    module.make_step_body = make
    try:
        yield steps
    finally:
        module.make_step_body = real


def check_per_step(label, step_counts):
    """Each step launched the kernels of PER_STEP exactly that often; Kernel
    B and the pair's kernels only in a step that builds the reference pair
    (the stock schedule's steps all do; a run through the whole
    auto-schedule anneals the pair's losses to 0 and its later steps build
    none)."""
    def want(c):
        return dict(PER_STEP, **{k: PER_STEP[k] if c["use_ref"] else 0
                                 for k in ("chamfer_band", *PAIR_KERNELS)})

    bad = [(i, {n: c[n] for n in PER_STEP}) for i, c in enumerate(step_counts)
           if any(c[n] != v for n, v in want(c).items())]
    if not step_counts or bad:
        raise AssertionError(f"{label}: per-step launches {bad[:3]} of "
                             f"{len(step_counts)} steps, expected {PER_STEP}")


# the scan phase: training.trainer.make_epoch_step's captured route (each
# step a replay of one CUDA graph of the step) against its eager route (the
# same step body run step by step), from the same parameters, Adam state and
# generator state, at the stock scene and widths, in each training config
# (label, overrides, the kernel launches of one replay): EPOCHS epochs compared,
# then SCAN_TIMED_EPOCHS more timed on each route; the pose-optimisation
# block likewise over SCAN_POSE_EPOCHS pose epochs and timed over a block
# of SCAN_POSE_STEPS steps; the bench entry at bench.py's layout
SCAN_RUNS = (("stock", {}, PER_STEP),
             ("multiplier", {"tpu": {"rays_per_step_multiplier": K_FRAMES}},
              PER_STEP),
             ("unfused_exact", {"tpu": {"fuse_compositing": False,
                                        "chamfer_mode": "exact"}},
              {"mlp_point_fwd": 1, "mlp_point_bwd": 1, "mlp_fused_fwd": 1,
               "chamfer_exact": 2, "ref_pair": 1, "ref_pair_bwd": 1}),
             ("parity", {"tpu": {"parity": True}},
              {"chamfer_exact": 2, "mlp_fused_fwd": 0, "ref_pair": 1,
               "ref_pair_bwd": 1}),
             ("ssim_normal", {"training": {"with_ssim": True},
                              "rendering": {"normal_loss": True}}, PER_STEP))
SCAN_TIMED_EPOCHS = 2
SCAN_POSE_EPOCHS, SCAN_POSE_VIEWS, SCAN_POSE_STEPS = 5, 2, 50
BENCH_FULL = (192, 2, 3)


def scan_setup(dev, overrides):
    """The stock step with ``overrides`` ({group: {key: value}}, the parity
    profile expanded) on the stock scene, its epoch-0 schedule, and the
    frame orders of EPOCHS + SCAN_TIMED_EPOCHS epochs drawn from SEED, the
    loop's layout at k > 1."""
    import numpy as np

    from nope_nerf_tpu_torch.config import apply_parity_profile
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import scene_batch_arrays
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    cfg = stock_cfg()
    for group, values in overrides.items():
        cfg[group].update(values)
    apply_parity_profile(cfg)
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    cfg["_num_cams"] = scene.N_imgs
    batch0 = scene_batch_arrays(scene, cfg, dev)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    static = sched.static_flags(0)
    rcfg = make_render_cfg(cfg, dev)
    n = scene.N_imgs
    k = max(int(cfg["tpu"].get("rays_per_step_multiplier", 1) or 1), 1)
    rng = np.random.default_rng(SEED)
    epochs = []
    for _ in range(EPOCHS + SCAN_TIMED_EPOCHS):
        order = rng.permutation(n)
        frames = order if k == 1 else np.concatenate(
            [order[:, None], rng.integers(0, n, (n, k - 1))], axis=1)
        epochs.append((frames, [scene.sample_ref_idx(int(i)) for i in order]))
    return cfg, scene, batch0, rcfg, scalars, static, epochs


def scan_route(dev, setup, capture_it, mesh=None, timed=True):
    """EPOCHS epochs of the setup on one route from seeds (their per-step
    losses, then the parameters and Adam moments), under ``mesh`` if given;
    with ``timed`` then one epoch timed on the host clock (wall ms per
    step) and one by the device's kernel time (:func:`device_ms`); returns
    them with the epoch step."""
    import torch

    from nope_nerf_tpu_torch.training.loop import build_params
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_epoch_step)

    cfg, scene, batch0, rcfg, scalars, static, epochs = setup
    params, init_c2w = build_params(cfg, scene,
                                    torch.Generator().manual_seed(SEED), dev)
    state = init_train_state(params, capturable=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    run = make_epoch_step(cfg, rcfg, init_c2w, mesh=mesh, device=dev,
                          eager=not capture_it)
    if run.route != ("cuda graph" if capture_it else "eager"):
        raise AssertionError(f"epoch step on the {run.route} route "
                             f"({run.why}), capture {capture_it}")

    def epoch(i):
        frames, refs = epochs[i]
        run(state, batch0, frames, refs, scalars, gen, static)

    losses = []
    for i in range(EPOCHS):
        epoch(i)
        losses.append(run.steps["loss"].clone())
    opt = state.optimizer
    tensors = [p for g in opt.param_groups for p in g["params"]]
    out = {"run": run, "losses": torch.cat(losses),
           "params": [p.detach().clone() for p in tensors],
           "moments": [opt.state[p][m].clone() for p in tensors
                       for m in ("exp_avg", "exp_avg_sq")]}
    if not timed:
        return out
    n = scene.N_imgs
    out["wall_ms"] = host_ms(lambda: epoch(EPOCHS), iters=1, warmup=0) / n
    out["device_ms"] = device_ms(lambda: epoch(EPOCHS + 1), iters=1,
                                 warmup=0) / n
    return out


def compare_routes(label, eager, graph, rerun):
    """Raises unless the captured route's losses, parameters and Adam
    moments equal the eager route's bit for bit, saying whether an eager
    rerun (``rerun()``) is bitwise the first (a step that is not
    deterministic eagerly) or not. Returns the differences' numbers."""
    import torch

    def diff(a, b):
        loss_rel = float(torch.max(torch.abs(a["losses"] - b["losses"])
                                   / torch.abs(b["losses"])))
        rels = [rel_l2(x, y) for key in ("params", "moments")
                for x, y in zip(a[key], b[key])]
        bit = (torch.equal(a["losses"], b["losses"]) and all(
            torch.equal(x, y) for key in ("params", "moments")
            for x, y in zip(a[key], b[key])))
        return bit, {"loss_max_rel": loss_rel, "state_max_rel_l2": max(rels)}

    bit, numbers = diff(graph, eager)
    if not bit:
        rerun_bit, _ = diff(rerun(), eager)
        raise AssertionError(f"{label}: the captured epochs differ from the "
                             f"eager ones {numbers} (an eager rerun bitwise "
                             f"equal: {rerun_bit})")
    return numbers


def scan_pose(dev, card):
    """The pose-optimisation block (:class:`PoseOptBlock`) captured against
    eager: ``optimize_eval_poses`` over SCAN_POSE_EPOCHS epochs of
    SCAN_POSE_VIEWS views at EVAL_POINTS rays from seed-0 weights, the
    poses compared; then a block of SCAN_POSE_STEPS steps timed on each
    route after its first (wall and device ms per step)."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.evaluation.pose_opt import (PoseOptBlock,
                                                         optimize_eval_poses,
                                                         pose_optimizer)
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.models.pose import init_pose_params
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    cfg = stock_cfg()
    rcfg = make_render_cfg(cfg, dev)
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    nerf = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    imgs = torch.as_tensor(np.asarray(scene.imgs[:SCAN_POSE_VIEWS]),
                           device=dev)
    init = np.asarray(scene.c2ws[:SCAN_POSE_VIEWS], np.float32)
    eye = np.eye(4, dtype=np.float32)
    poses, times = {}, {}
    for cap in (False, True):
        c2w, pose = optimize_eval_poses(nerf, scene.K, cfg, rcfg, imgs, eye,
                                        init, SCAN_POSE_EPOCHS, 1e-3,
                                        EVAL_POINTS, seed=SEED, eager=not cap)
        poses[cap] = (c2w, torch.cat([pose["r"], pose["t"]]).detach())
        frozen = {k: {kk: t.detach() for kk, t in layer.items()}
                  for k, layer in nerf.items()}
        p = init_pose_params(SCAN_POSE_VIEWS, dev)
        for t in p.values():
            t.requires_grad_(True)
        block = PoseOptBlock(cfg, rcfg, torch.as_tensor(init, device=dev),
                             EVAL_POINTS, imgs.shape[1:3], dev, eager=not cap)
        if block.route != ("cuda graph" if cap else "eager"):
            raise AssertionError(f"pose block on the {block.route} route, "
                                 f"capture {cap}")
        opt = pose_optimizer(p, True)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        lrs = np.full(SCAN_POSE_STEPS, 1e-3, np.float32)
        frames = np.arange(SCAN_POSE_STEPS) % SCAN_POSE_VIEWS
        cam, scale = (torch.as_tensor(a, device=dev) for a in (scene.K, eye))

        def one(block=block, p=p, opt=opt, gen=gen, cam=cam, scale=scale):
            return block(frozen, p, opt, imgs, cam, scale, lrs, frames, gen)

        one()  # the warm-up step and the capture
        times[block.route] = (
            host_ms(one, iters=1, warmup=0) / SCAN_POSE_STEPS,
            device_ms(one, iters=1, warmup=0) / SCAN_POSE_STEPS)
    bitwise = (np.array_equal(poses[False][0], poses[True][0])
               and torch.equal(poses[False][1], poses[True][1]))
    rel = rel_l2(poses[True][1], poses[False][1])
    print(f"scan pose block [{card}]: {SCAN_POSE_EPOCHS} pose epochs x "
          f"{SCAN_POSE_VIEWS} views at {EVAL_POINTS} rays, captured against "
          f"eager: bitwise {bitwise} (pose relL2 {rel:.3e}); ms per pose "
          "step wall / device: " + "; ".join(
              f"{r} {w:.3f} / {d:.3f}" for r, (w, d) in times.items()))
    if not bitwise:
        raise AssertionError(f"scan pose block: captured against eager "
                             f"relL2 {rel}, not bitwise")
    return {"bitwise": bitwise, "pose_rel_l2": rel,
            "ms_per_step": {r: {"wall": w, "device": d}
                            for r, (w, d) in times.items()}}


def run_scan(dev, card):
    """The scan phase (see SCAN_RUNS). Returns the launch counts of its
    runs (both routes, the pose blocks and the benches) and its record."""
    import torch

    from nope_nerf_tpu_torch.training import capture

    torch.cuda.empty_cache()
    counters = reset_counts()
    runs = {}
    for label, overrides, want in SCAN_RUNS:
        setup = scan_setup(dev, overrides)
        eager = scan_route(dev, setup, False)
        graph = scan_route(dev, setup, True)
        numbers = compare_routes(
            f"scan {label}", eager, graph,
            lambda: scan_route(dev, setup, False))
        run = graph["run"]
        graphs = list(run.graphs.graphs.values())
        per_replay = [g.record.launches for g in graphs]
        bad = [c for c in per_replay
               if any(c.get(k, 0) != v for k, v in want.items())]
        if len(graphs) != 1 or bad:
            raise AssertionError(f"scan {label}: {len(graphs)} graphs, "
                                 f"launches per replay {per_replay}, "
                                 f"expected {want}")
        replays = graphs[0].record.replays
        runs[label] = dict(numbers, graphs=len(graphs),
                           warmups=run.graphs.warmups, replays=replays,
                           launches_per_replay=per_replay[0],
                           ms_per_step={
                               "eager": {"wall": eager["wall_ms"],
                                         "device": eager["device_ms"]},
                               "cuda graph": {"wall": graph["wall_ms"],
                                              "device": graph["device_ms"]}})
        print(f"scan {label} [{card}]: {EPOCHS} epochs x {N_FRAMES} steps "
              f"captured against eager: bitwise ({numbers}); "
              f"{len(graphs)} graph, {run.graphs.warmups} warm-up step, "
              f"{replays} replays; ms/step wall / device: eager "
              f"{eager['wall_ms']:.3f} / {eager['device_ms']:.3f}, cuda "
              f"graph {graph['wall_ms']:.3f} / {graph['device_ms']:.3f}; "
              f"launches per replay {per_replay[0]}")
        del eager, graph
        torch.cuda.empty_cache()
    pose = scan_pose(dev, card)
    counts = collections.Counter(executed(counters))
    benches = {}
    for k in (1, K_FRAMES):
        over = {} if k == 1 else {"rays_per_step_multiplier": k}
        rec, bench_counts = short_bench(dev, card, over, layout=BENCH_FULL)
        benches[f"k{k}"] = rec["value"]
        counts.update(bench_counts)  # short_bench counts from 0
    counts = {c.name: counts[c.name] for c in counters}
    print(f"scan phase [{card}]: bench.py's layout {BENCH_FULL}: rays/s "
          f"{benches}; launches {counts}; {len(capture.records())} graphs "
          "captured so far in this process")
    return counts, {"runs": runs, "pose_block": pose,
                    "bench_rays_per_sec": benches}


@contextlib.contextmanager
def kernel_a_plain():
    """Route the renderer's Kernel A calls to its plain version (the
    renderer looks the wrapper up at each call)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    real = mk.fused_mlp_composite
    mk.fused_mlp_composite = mk.fused_mlp_composite_reference
    try:
        yield
    finally:
        mk.fused_mlp_composite = real


def host_ms(fn, iters, warmup=1, sync=True):
    """Mean wall time of ``fn`` in ms, each call ended by a device
    synchronise (the host clock of a caller that waits for its result), or
    with ``sync`` False only the last (the host's cost of issuing it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def check_restore(dev, card, cfg, trained):
    """The stock run's four streams and Adam moments, restored into fresh
    tensors, equal the trained state's bit for bit."""
    import torch

    from nope_nerf_tpu_torch.convert import adam_state_from_jax_leaves
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO
    from nope_nerf_tpu_torch.training.loop import build_params, restore
    from nope_nerf_tpu_torch.training.trainer import (group_tensors,
                                                      init_train_state)

    scene = MemoryScene(N_FRAMES, 8, 8, SEED + 1)
    fresh, _ = build_params(dict(cfg, _num_cams=N_FRAMES), scene,
                            torch.Generator().manual_seed(SEED + 1), dev)
    params, scalars, leaves = restore(CheckpointIO(cfg["training"]["out_dir"]),
                                      cfg, fresh, dev)
    state = init_train_state(params)
    adam_state_from_jax_leaves(state.optimizer, leaves)
    n_params = n_moments = 0
    bad = []
    for g in ("nerf", "pose", "focal", "distortion"):
        for a, b in zip(group_tensors(params[g]),
                        group_tensors(trained.params[g])):
            n_params += 1
            if not torch.equal(a.detach(), b.detach()):
                bad.append(f"{g} param")
            if g == "nerf":
                sa, sb = state.optimizer.state[a], trained.optimizer.state[b]
                for key in ("exp_avg", "exp_avg_sq"):
                    n_moments += 1
                    if not torch.equal(sa[key], sb[key]):
                        bad.append(f"nerf {key}")
    print(f"eval restore [{card}]: {n_params} parameter tensors and "
          f"{n_moments} nerf Adam moments restored into fresh tensors from "
          f"the stock run's checkpoints (it={scalars['it']}, "
          f"epoch_it={scalars['epoch_it']}): {len(bad)} differ")
    if bad:
        raise AssertionError(f"restored checkpoints differ: {bad}")
    return params


def check_input_only_backward(dev, card):
    """Kernel A's input-only backward (no weight needs a gradient) against
    the full one at the stock shapes: d_origins / d_rays / d_dirs bitwise
    equal; the full one's ten fused passes and WGRAD_PER_BWD["A"] launches
    that serve only the weight gradients against the input-only one's one
    launch of csrc/mlp_input_bwd.cu and none of either; both timed beside
    the input-only memory floor."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    static = (cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"],
              cfg["model"]["occ_activation"], True, False, False, N_SAMPLES)
    cots = (t(rng.normal(size=(N_RAYS, 3)) / N_RAYS),
            t(rng.normal(size=(N_RAYS, 1)) / N_RAYS),
            torch.zeros((N_RAYS, N_SAMPLES), device=dev))
    frozen = [w.detach() for w in weights]
    geo = [origins, rays_t, dirs]
    out_full = mk.fused_mlp_composite(weights, *geo, z_t, deltas_t, *static)
    out_in = mk.fused_mlp_composite(frozen, *geo, z_t, deltas_t, *static)
    count = (mk.WGRAD_LAUNCHES, mk.MLP_FUSED_BWD_LAUNCHES,
             mk.MLP_INPUT_BWD_LAUNCHES)
    n0 = [c.count for c in count]
    g_full = torch.autograd.grad(out_full, geo + weights, cots,
                                 retain_graph=True)
    n1 = [c.count for c in count]
    g_in = torch.autograd.grad(out_in, geo, cots, retain_graph=True)
    n2 = [c.count for c in count]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(g_in, g_full[:3])]
    ms_full = cuda_ms(lambda: torch.autograd.grad(
        out_full, geo + weights, cots, retain_graph=True))
    ms_in = cuda_ms(lambda: torch.autograd.grad(out_in, geo, cots,
                                                retain_graph=True))
    dev_in = device_ms(lambda: torch.autograd.grad(out_in, geo, cots,
                                                   retain_graph=True))
    widths = _mlp_widths(weights, static)
    floor = mlp_bwd_floor(N_RAYS * N_SAMPLES, *widths, div=N_SAMPLES,
                                weight_grads=False)
    print(f"kernel A input-only bwd [{card}] N={N_RAYS} S={N_SAMPLES}: "
          f"d_origins/d_rays/d_dirs bitwise equal to the full backward "
          f"{same}; weight-gradient launches {n1[0] - n0[0]} (full) vs "
          f"{n2[0] - n1[0]}, fused passes {n1[1] - n0[1]} vs "
          f"{n2[1] - n1[1]}, input-only launches {n1[2] - n0[2]} vs "
          f"{n2[2] - n1[2]}; full {ms_full:.3f} ms, input-only {ms_in:.3f} "
          f"ms (device {dev_in:.3f} ms); input-only memory floor "
          f"{floor:.3f} ms")
    want = ((mk.WGRAD_PER_BWD["A"], mk.FUSED_BWD_PER_BWD, 0), (0, 0, 1))
    got = tuple(tuple(y - x for x, y in zip(a, b))
                for a, b in ((n0, n1), (n1, n2)))
    if not all(same) or got != want:
        raise AssertionError("kernel A's input-only backward differs from "
                             f"the full one (launches {got}, expected {want})")
    return {"ms_full": ms_full, "ms_input_only": ms_in,
            "device_ms_input_only": dev_in, "floor_ms_input_only": floor}


def pose_step_ms(dev, nerf_params, scene, render_cfg, weight_grads):
    """Wall ms of one test-time pose-optimisation step (ray draw, render,
    MSE, backward, Adam) at EVAL_POINTS rays, with the field's weights
    requiring gradients (the full backward) or frozen (input-only)."""
    import torch

    from nope_nerf_tpu_torch.evaluation.pose_opt import pose_opt_loss
    from nope_nerf_tpu_torch.models.pose import init_pose_params
    from nope_nerf_tpu_torch.training.trainer import sample_ray_idx

    nerf = {k: {kk: v.detach().clone().requires_grad_(weight_grads)
                for kk, v in layer.items()} for k, layer in nerf_params.items()}
    imgs = torch.as_tensor(scene.imgs, device=dev)
    cam = torch.as_tensor(scene.K, device=dev)
    eye = torch.eye(4, device=dev)
    init = torch.as_tensor(scene.c2ws, device=dev)
    pose = init_pose_params(scene.N_imgs, dev)
    for v in pose.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(pose.values()), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        idx = sample_ray_idx(EVAL_POINTS, imgs.shape[1:3], True, gen, dev)
        opt.zero_grad(set_to_none=True)
        pose_opt_loss(pose, nerf, imgs, cam, eye, 0, idx, init,
                      render_cfg).backward()
        opt.step()

    return host_ms(step, iters=20, warmup=3)


def run_eval(dev, card, cfg, trained):
    """The eval phase on the stock run's checkpoints (see the module
    docstring). Returns the eval launch counts and the measured numbers."""
    import torch

    from nope_nerf_tpu_torch import eval as peval
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.rendering import render_image
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    nerf = check_restore(dev, card, cfg, trained)["nerf"]
    n_reference = check_reference_checkpoints(card, trained)
    weights = lpips_weights()
    cfg = dict(cfg, eval_pose=dict(cfg["eval_pose"],
                                   opt_pose_epoch=EVAL_POSE_EPOCHS,
                                   n_points=EVAL_POINTS),
               extract_images=dict(cfg["extract_images"],
                                   lpips_weights=weights))
    train_scene = MemoryScene(N_FRAMES, H, W, SEED)
    eval_scene = MemoryScene(N_FRAMES, H, W, SEED, mode="eval")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counters = reset_counts()
    res = peval.main(cfg, device=dev, train_scene=train_scene,
                     eval_scene=eval_scene)
    counts = executed(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    finite = all(math.isfinite(res[k]) for k in ("psnr", "ssim", "lpips"))
    print(f"eval [{card}]: {EVAL_POSE_EPOCHS} pose epochs x "
          f"{eval_scene.N_imgs} held-out view at {EVAL_POINTS} rays, then "
          f"{H}x{W} through Kernel A: PSNR {res['psnr']:.4f}, SSIM "
          f"{res['ssim']:.5f}, LPIPS {res['lpips']:.5f}, "
          f"{res['ms_per_image'][0]:.1f} ms/image (render + scoring + PNGs), "
          f"peak memory {peak / 2**30:.3f} GiB; launches {counts}")
    stray = [n for n, v in counts.items() if v and n not in (
        "mlp_composite_fwd", "mlp_composite_bwd", *MLP_GEMMS,
        "mlp_input_bwd", *A_BWD_KERNELS)]
    if not (counts["mlp_composite_fwd"] and counts["mlp_composite_bwd"]) \
            or stray or not finite:
        raise AssertionError(f"eval: kernel A fwd/bwd not both launched, or "
                             f"launched off this path {stray}, or non-finite "
                             f"metrics {res}")
    check_gemm_counts("eval", counts, weight_grads=False)
    lpips_rec = check_lpips(dev, card, weights, eval_scene.imgs[0],
                            train_scene.imgs[0])
    shutil.rmtree(os.path.dirname(weights))

    render_cfg = make_render_cfg(cfg, dev)
    cam = torch.as_tensor(train_scene.K, device=dev)
    world = torch.linalg.inv(torch.as_tensor(train_scene.c2ws[0], device=dev))
    eye = torch.eye(4, device=dev)
    before = executed(counters)

    def render_full():
        return render_image(nerf, (H, W), cam, world, eye, render_cfg,
                            chunk=65536)

    render_ms = host_ms(render_full, iters=3)
    during = {k: v - before[k] for k, v in executed(counters).items()}
    check_gemm_counts("eval render", during, weight_grads=False)
    print(f"eval render launches [{card}]: {during}")
    render_ms = (render_ms + host_ms(render_full, iters=3)) / 2
    print(f"eval render [{card}]: {H}x{W}, {render_ms:.1f} ms/image through "
          "the fused forward (host clock, each render synchronised)")
    small = render_image(nerf, SMALL_VIEW, cam, world, eye, render_cfg)
    with kernel_a_plain():
        small_plain = render_image(nerf, SMALL_VIEW, cam, world, eye,
                                   render_cfg)
        small_plain_ms = host_ms(lambda: render_image(
            nerf, SMALL_VIEW, cam, world, eye, render_cfg), iters=3)
    small_ms = host_ms(lambda: render_image(nerf, SMALL_VIEW, cam, world, eye,
                                            render_cfg), iters=3)
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "depth"), small, small_plain)}
    print(f"eval render [{card}]: {H}x{W} through Kernel A {render_ms:.1f} "
          f"ms/image; {SMALL_VIEW[0]}x{SMALL_VIEW[1]} Kernel A vs its plain "
          f"version max|err| rgb={err['rgb']:.3e} depth={err['depth']:.3e}; "
          f"kernel {small_ms:.1f} ms, plain {small_plain_ms:.1f} ms")
    if not (err["rgb"] <= RGB_ATOL and err["depth"] <= DIST_ATOL):
        raise AssertionError(f"eval render: Kernel A disagrees with its plain "
                             f"version {err}")

    bwd = check_input_only_backward(dev, card)
    ms_full = pose_step_ms(dev, nerf, eval_scene, render_cfg, True)
    ms_in = pose_step_ms(dev, nerf, eval_scene, render_cfg, False)
    print(f"eval pose step [{card}]: {EVAL_POINTS} rays, full backward "
          f"{ms_full:.3f} ms/step, input-only backward {ms_in:.3f} ms/step")
    return counts, {"psnr": res["psnr"], "ssim": res["ssim"],
                    "lpips": res["lpips"], "lpips_check": lpips_rec,
                    "reference_tensors_restored": n_reference,
                    "ms_per_image": res["ms_per_image"][0],
                    "render_ms": render_ms,
                    "peak_bytes": peak,
                    "small_view_max_abs_err": err, "small_view_ms": small_ms,
                    "small_view_plain_ms": small_plain_ms,
                    "bwd_full_ms": bwd["ms_full"],
                    "bwd_input_only_ms": bwd["ms_input_only"],
                    "bwd_input_only_device_ms": bwd["device_ms_input_only"],
                    "bwd_input_only_floor_ms": bwd["floor_ms_input_only"],
                    "pose_step_full_ms": ms_full,
                    "pose_step_input_only_ms": ms_in}


def lpips_weights():
    """Seeded VGG16-features and LPIPS-head state dicts with the published
    keys and shapes, converted by ``python -m
    nope_nerf_tpu_torch.convert_lpips``; returns the npz path."""
    import torch

    work = os.path.join(WORK, "lpips")
    os.makedirs(work, exist_ok=True)
    gen = torch.Generator().manual_seed(SEED + 7)
    vgg_shapes, lin_shapes = lpips_checkpoint_shapes()
    vgg = seeded_state(vgg_shapes, gen, 0.08)
    vgg.update({k: v * 1.25 for k, v in vgg.items() if k.endswith(".bias")})
    lin = {k: v.abs() for k, v in seeded_state(lin_shapes, gen, 1.0).items()}
    paths = [os.path.join(work, n) for n in ("vgg16.pth", "lin.pth",
                                              "lpips_vgg.npz")]
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    run_module("nope_nerf_tpu_torch.convert_lpips", paths[2], "--vgg",
               paths[0], "--lin", paths[1])
    return paths[2]


def check_lpips(dev, card, path, img0, img1):
    """One 540x960 pair's LPIPS against float64 on the card (rel
    LPIPS_REL), with TF32 on beside it, and the metric's time."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.convert import lpips_params_from_jax, tree_to
    from nope_nerf_tpu_torch.models import lpips
    from nope_nerf_tpu_torch.training.checkpoints import load_pytree

    params = lpips_params_from_jax(load_pytree(path)[0]["params"], dev)
    a, b = (torch.as_tensor(np.asarray(im), device=dev) for im in (img0, img1))
    got = float(lpips.lpips_distance(params, a, b))
    p64 = tree_to(params, torch.float64)
    want = float(lpips.lpips_distance(p64, a.double(), b.double()))
    tf32 = float(with_tf32(lambda: lpips._distance(params, a, b)))
    rel, rel_tf32 = abs(got - want) / want, abs(tf32 - want) / want
    ms = cuda_ms(lambda: lpips.lpips_distance(params, a, b), iters=5)
    print(f"eval LPIPS [{card}]: {a.shape[0]}x{a.shape[1]} pair {got:.6f} "
          f"vs float64 {want:.6f}: rel {rel:.3e} (bar {LPIPS_REL:.0e}); "
          f"TF32 on: rel {rel_tf32:.3e}; {ms:.2f} ms per image")
    if not (math.isfinite(got) and rel <= LPIPS_REL < rel_tf32):
        raise AssertionError(f"LPIPS on the card {got} vs float64 {want}: "
                             f"rel {rel}, TF32 {rel_tf32}: the bar "
                             f"{LPIPS_REL} does not separate them")
    return {"lpips": got, "lpips_f64": want, "rel": rel,
            "rel_tf32": rel_tf32, "ms_per_image": ms}


def with_tf32(fn):
    """``fn()`` without autograd and with both TF32 flags on; the smoke
    runs with them off (:func:`main`), and they are off again after."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            return fn()
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False


def write_llff_scene(scene_dir, n_frames, hw, seed):
    """``n_frames`` random frames of ``hw`` on a smooth trajectory
    (``synthetic.MemoryScene``) in the LLFF layout, by the port's dataset
    writer, without depth priors. Returns the frames."""
    from nope_nerf_tpu_torch.make_synthetic_dataset import write_dataset
    from nope_nerf_tpu_torch.synthetic import MemoryScene

    scene = MemoryScene(n_frames, *hw, seed)
    write_dataset(scene, scene_dir)
    shutil.rmtree(os.path.join(scene_dir, "dpt"))
    return scene.imgs


def run_dpt(dev, card):
    """The DPT phase (see the module docstring): seeded checkpoint ->
    ``convert_dpt`` -> ``dpt_depth`` on a 540x960 scene -> the port's
    ``get_scene`` with those priors -> 2 epochs of stock training. Returns
    the training's launch counts and the phase's numbers."""
    import numpy as np
    import torch
    import yaml

    from nope_nerf_tpu_torch.convert import tree_to
    from nope_nerf_tpu_torch.dataloading.scene import get_scene
    from nope_nerf_tpu_torch.models import dpt
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.training.loop import train

    work = os.path.join(WORK, "dpt")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    write_llff_scene(os.path.join(data, "scene"), DPT_FRAMES, (H, W), SEED)
    gen = torch.Generator().manual_seed(SEED + 5)
    state = seeded_state(dpt_checkpoint_shapes(), gen, 0.05)
    state["scratch.output_conv.4.bias"].fill_(DPT_HEAD_BIAS)
    pt, npz = os.path.join(work, "dpt.pt"), os.path.join(work, "dpt.npz")
    torch.save(state, pt)
    del state
    t0 = time.perf_counter()
    run_module("nope_nerf_tpu_torch.convert_dpt", pt, npz)
    convert_s = time.perf_counter() - t0
    os.remove(pt)
    cfg_path = os.path.join(work, "preprocess.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"depth": {"type": "DPT", "path": npz},
                        "dataloading": {"path": data, "scene": ["scene"],
                                        "resize_factor": None},
                        "training": {"mode": "all"}}, f)
    t0 = time.perf_counter()
    run_module("nope_nerf_tpu_torch.dpt_depth", cfg_path)
    cli_s = time.perf_counter() - t0
    out_dir = os.path.join(data, "scene", "dpt")
    files = sorted(os.listdir(out_dir))
    npzs = [f for f in files if f.startswith("depth_") and f.endswith(".npz")]
    pngs = [f for f in files if f.endswith(".png")]
    preds = [np.load(os.path.join(out_dir, f))["pred"] for f in npzs]
    bad = [f for f, p in zip(npzs, preds) if p.shape != (1, *DPT_OUT_HW)
           or p.dtype != np.float32 or not np.all(np.isfinite(p))
           or not np.all(p > 0)]
    if len(npzs) != DPT_FRAMES or len(pngs) != DPT_FRAMES or bad:
        raise AssertionError(f"dpt_depth wrote {files}; bad priors {bad}")

    # one frame through the CLI's batch function in f32, and the network in
    # float64 and with TF32 on, from the scene as the CLI read it
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.dpt_depth import depth_batch

    pre_cfg = load_config(cfg_path, DEFAULT_CONFIG)
    frames = torch.as_tensor(get_scene(pre_cfg, mode="all").imgs, device=dev)
    x = dpt.dpt_input_transform_batched(frames)
    params = dpt.load_dpt(npz, dev)
    depth = depth_batch(params, frames[:1], pre_cfg["depth"])[0]
    p64 = tree_to(params, torch.float64)
    depth64 = dpt.apply_dpt_batched(p64, x[:1].double())[0]
    del p64
    depth_tf32 = with_tf32(lambda: dpt._apply_dpt_nchw(
        params, x[:1].permute(0, 3, 1, 2)))[0]
    err, err_tf32 = rel_l2(depth.double(), depth64), rel_l2(
        depth_tf32.double(), depth64)
    cli_err = rel_l2(torch.as_tensor(preds[0][0], device=dev).double(),
                     depth64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: depth_batch(params, frames, pre_cfg["depth"]),
                 iters=3, warmup=1) / len(x)
    peak = torch.cuda.max_memory_allocated(dev)
    d = depth64.cpu().numpy()
    print(f"dpt [{card}]: {DPT_FRAMES} frames {H}x{W} -> {DPT_OUT_HW[0]}x"
          f"{DPT_OUT_HW[1]}; convert_dpt {convert_s:.1f} s, dpt_depth CLI "
          f"{cli_s:.1f} s (process, weights and 4 frames); depth "
          f"{d.min():.3f}..{d.max():.3f}; frame 0 relL2 vs float64 {err:.3e}"
          f" (bar {DPT_RELL2:.0e}), the CLI's prior {cli_err:.3e}, TF32 on "
          f"{err_tf32:.3e}; {ms:.2f} ms per frame in batches of "
          f"{len(x)}, peak memory {peak / 2**30:.3f} GiB")
    if not (err <= DPT_RELL2 and cli_err <= DPT_RELL2 < err_tf32):
        raise AssertionError(f"dpt: relL2 vs float64 {err} (the CLI's "
                             f"{cli_err}), TF32 {err_tf32}: the bar "
                             f"{DPT_RELL2} does not separate them")
    del params

    cfg = stock_cfg()
    cfg["dataloading"].update(path=data, scene=["scene"], resize_factor=None)
    cfg["training"].update(out_dir=os.path.join(work, "out"), seed=SEED)
    scene = get_scene(cfg, mode="train")
    want = np.stack([p[0] for p in preds])
    if scene.dpt_depth is None or not np.array_equal(scene.dpt_depth, want):
        raise AssertionError("get_scene did not read the priors dpt_depth "
                             "wrote")
    torch.cuda.empty_cache()
    counters = reset_counts()
    # Kernel B's last two eager calls (clouds from the 384x672 priors) and
    # Kernel C's forward (the first epoch's visualisation), held against their
    # plain versions at these inputs below
    with recording(cb, "nearest_idx_banded", keep=2) as argmin_calls, \
            recording(mk, "fused_mlp") as point_calls:
        _, _, _, history = train(cfg, max_epochs=DPT_EPOCHS, scene=scene,
                                 device=dev)
    counts = executed(counters)
    losses = [v for h in history for v in h["step_losses"]]
    if len(losses) != DPT_EPOCHS * scene.N_imgs or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"dpt training: losses {losses}")
    check_launches("dpt training", counts, RUNS[0][2])
    kernel_checks = {
        "chamfer_band": check_argmin_calls(
            "dpt training's chamfer_band", cb.nearest_idx_banded,
            cb.nearest_idx_banded_reference, argmin_calls),
        "mlp_point_fwd": check_point_mlp_call(
            "dpt training's visualisation", point_calls)}
    print(f"dpt training [{card}]: {len(losses)} steps on the priors "
          f"({scene.dpt_depth.shape[1]}x{scene.dpt_depth.shape[2]}), loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches {counts}; kernel "
          f"checks at this phase's inputs {json.dumps(kernel_checks)}")
    # the converted weights stay for the multigpu phase's dpt_depth runs
    for name in os.listdir(work):
        path = os.path.join(work, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif name != "dpt.npz":
            os.remove(path)
    return counts, {"depth_rel_l2_vs_f64": err, "cli_rel_l2_vs_f64": cli_err,
                    "tf32_rel_l2_vs_f64": err_tf32, "ms_per_frame": ms,
                    "batch": len(x), "peak_bytes": peak,
                    "cli_s": cli_s, "convert_s": convert_s,
                    "train_losses": losses, "kernel_checks": kernel_checks}


# the reference NeRF's Linear layers under ``renderer.model.``
# (model/official_nerf.py: nn.Sequential slots 0, 2, 4, 6 of each trunk half,
# the layout of tests/test_reference_ckpt_convert.py's fixtures) and the
# port's parameter each holds; written out here, not taken from the converter
# under test (tests/test_torch_convert_tools.py holds it to the JAX tool's)
REF_NERF_LAYERS = (
    ("layers0.0", "trunk0_0"), ("layers0.2", "trunk0_1"),
    ("layers0.4", "trunk0_2"), ("layers0.6", "trunk0_3"),
    ("layers1.0", "trunk1_0"), ("layers1.2", "trunk1_1"),
    ("layers1.4", "trunk1_2"), ("layers1.6", "trunk1_3"),
    ("fc_density", "fc_density"), ("fc_feature", "fc_feature"),
    ("rgb_layers.0", "rgb_layer"), ("fc_rgb", "fc_rgb"),
)


def check_reference_checkpoints(card, trained):
    """The stock run's parameters written as the reference's four ``.pt``
    streams (torch Linear (out, in) weights under ``renderer.model.``,
    the resume scalars, an optimizer blob), converted by ``python -m
    nope_nerf_tpu_torch.convert_reference``, restored equal bit for bit."""
    import torch

    from nope_nerf_tpu_torch.convert import load_group
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO

    work = os.path.join(WORK, "reference")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    p = {g: {k: v.detach().cpu() for k, v in sub.items()}
         for g, sub in trained.params.items() if g != "nerf"}
    nerf = trained.params["nerf"]
    scal = {"epoch_it": EPOCHS, "it": EPOCHS * N_FRAMES}
    model = {}
    for ref, ours in REF_NERF_LAYERS:
        model[f"renderer.model.{ref}.weight"] = nerf[ours]["w"].detach().cpu().T
        model[f"renderer.model.{ref}.bias"] = nerf[ours]["b"].detach().cpu()
    streams = {
        "model": model,
        "model_pose": {"r": p["pose"]["r"], "t": p["pose"]["t"]},
        "model_focal": dict(p["focal"]),
        "model_distortion": {"global_scales": p["distortion"]["scales"],
                             "global_shifts": p["distortion"]["shifts"]}}
    for name, sd in streams.items():
        torch.save({"model": sd, "optimizer": {"state": {},
                                               "param_groups": []}, **scal},
                   os.path.join(work, f"{name}.pt"))
    out = os.path.join(work, "npz")
    run_module("nope_nerf_tpu_torch.convert_reference", work, out)
    io = CheckpointIO(out)
    bad, n = [], 0
    for g, stream in (("nerf", "model"), ("pose", "model_pose"),
                      ("focal", "model_focal"),
                      ("distortion", "model_distortion")):
        restored = load_group(io, f"{stream}.npz", g, "cpu")
        if io.load(f"{stream}.npz")[1] != scal:
            bad.append(f"{stream} scalars")
        for k, sub in trained.params[g].items():
            for a, b in ([(restored[k][kk], v) for kk, v in sub.items()]
                         if isinstance(sub, dict) else [(restored[k], sub)]):
                n += 1
                if not torch.equal(a, b.detach().cpu()):
                    bad.append(f"{g}/{k}")
    print(f"reference checkpoints [{card}]: the stock run's 4 streams as "
          f"reference .pt files -> convert_reference -> {n} parameter "
          f"tensors restored: {len(bad)} differ")
    shutil.rmtree(work)
    if bad:
        raise AssertionError(f"reference checkpoint round trip: {bad}")
    return n


def check_launches(label, counts, expect, weight_grads=True):
    """Every kernel in ``expect`` launched in ``counts``, no other one, and
    the GEMM counts of :func:`check_gemm_counts` (Kernel A's backward
    brings :data:`A_BWD_KERNELS` with it)."""
    if "mlp_composite_bwd" in expect:
        expect = (*expect, *A_BWD_KERNELS)
    idle = [n for n in expect if counts[n] == 0]
    stray = [n for n, v in counts.items() if v and n not in expect]
    if idle or stray:
        raise AssertionError(f"{label}: kernels never launched {idle}, "
                             f"launched off this path {stray}")
    check_gemm_counts(label, counts, weight_grads=weight_grads)


def synthetic_cfg(base):
    """The stock config on the teacher scene under ``base``: the depth range
    the teacher was rendered in, gt poses fixed, the stock pre-switch loss
    weights (rgb, depth, pc, rgb_s) throughout, a visualisation and a pair
    dump every SYN_VIS_EVERY steps, pose metrics every epoch."""
    cfg = stock_cfg()
    cfg["dataloading"].update(path=os.path.join(base, "data"),
                              scene=["scene"], resize_factor=None,
                              spherify=False)
    cfg["rendering"]["depth_range"] = [0.5, 6.0]
    cfg["pose"].update(learn_R=False, learn_t=False, init_pose=True,
                       init_pose_type="gt")
    cfg["training"].update(out_dir=os.path.join(base, "out"), seed=SEED,
                           auto_scheduler=False, print_every=0,
                           checkpoint_every=0, backup_every=0,
                           visualize_every=SYN_VIS_EVERY,
                           vis_reprojection_every=SYN_VIS_EVERY,
                           eval_pose_every=1, eval_img_every=1)
    cfg["extract_images"].update(traj_option="interp", N_novel_imgs=SYN_NOVEL,
                                 output_geo=True)
    return cfg


def fired_steps(epochs, n, every):
    """The steps after which a trigger of period ``every`` fires in
    ``epochs`` scanned epochs of ``n`` steps (the stock config's path): the
    last step of each epoch that crosses a multiple of ``every``."""
    return [e * n + n - 1 for e in range(epochs)
            if (e * n - 1) // every != (e * n + n - 1) // every]


def reset_counts():
    """Every kernel counter and every captured graph's replays at 0."""
    from nope_nerf_tpu_torch.training import capture

    counters = kernel_counters()
    for c in counters:
        c.reset()
    capture.reset_replays()
    return counters


def executed(counters):
    """{name: launches run} of ``counters`` since :func:`reset_counts`: the
    launches of eager calls, plus each captured graph's launches times its
    replays (``training/capture.py``)."""
    from nope_nerf_tpu_torch.training import capture

    run = capture.executed_launches()
    return {c.name: run[c.name] for c in counters}


def snapshot(x):
    """A detached copy of the tensors in ``x`` (nested lists, tuples and
    dicts), the rest as it is."""
    import torch

    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot(v) for v in x)
    return x


@contextlib.contextmanager
def recording(module, name, keep=1, copy=False):
    """Wrap ``module.name`` inside the block; yields a list of the (args,
    kwargs) of its last ``keep`` calls (with ``copy``, a :func:`snapshot`
    of them, for inputs that change in place later, as the weights do), so
    a kernel's wrapper can be held against its plain version at the inputs
    a path gave it."""
    import torch

    fn = getattr(module, name)
    calls = collections.deque(maxlen=keep)

    def wrapper(*args, **kwargs):
        # a call made while a CUDA graph captures sees placeholders, which
        # later work overwrites: only eager calls are kept
        if not torch.cuda.is_current_stream_capturing():
            calls.append(snapshot((args, kwargs)) if copy else (args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def kernel_a_training_call():
    """Inside the block, record Kernel A's last eager call that builds an
    autograd graph (on the scan path the warm-up step of a captured step):
    a copy of its inputs and, once the step's backward has run, the
    cotangents that reached its three outputs (None where none did)."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    real = mk.fused_mlp_composite
    last = {}

    def wrapper(*args):
        outs = real(*args)
        if (any(o.requires_grad for o in outs)
                and not torch.cuda.is_current_stream_capturing()):
            cots = [None] * len(outs)
            for i, o in enumerate(outs):
                o.register_hook(lambda g, i=i: cots.__setitem__(
                    i, None if g is None else g.detach().clone()))
            last.update(args=snapshot(args), cots=cots)
        return outs

    mk.fused_mlp_composite = wrapper
    try:
        yield last
    finally:
        mk.fused_mlp_composite = real


def check_kernel_a_call(label, call):
    """Rerun a recorded Kernel A training call (:func:`kernel_a_training_
    call`) forward and backward through the kernel and its plain version,
    under the step's own cotangents of rgb and depth (none on alpha, which
    no loss reads), at check_kernel_a's bars (outputs
    max|err| RGB_ATOL / DIST_ATOL / ALPHA_ATOL, gradients relL2
    GRAD_RELL2)."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    weights, geo, rest = call["args"][0], call["args"][1:4], call["args"][4:]
    results, times = [], []
    for fn in (mk.fused_mlp_composite, mk.fused_mlp_composite_reference):
        w = [x.clone().requires_grad_() for x in weights]
        g = [x.clone().requires_grad_() for x in geo]
        outs = fn(w, *g, *rest)
        # the loss reads rgb and depth; alpha only feeds them
        cots = [torch.zeros_like(o) if c is None or i == 2 else c
                for i, (o, c) in enumerate(zip(outs, call["cots"]))]

        def bwd(outs=outs, g=g, w=w, cots=cots):
            return torch.autograd.grad(outs, g + w, cots, retain_graph=True)

        results.append(([o.detach() for o in outs], bwd()))
        times.append((cuda_ms(lambda fn=fn, w=w, g=g: fn(w, *g, *rest),
                              iters=5), cuda_ms(bwd, iters=5)))
    (o_k, g_k), (o_r, g_r) = results
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "dist", "alpha"), o_k, o_r)}
    names = ["d_origins", "d_rays", "d_dirs"] + [
        f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    worst = max(rels, key=rels.get)
    finite = all(bool(torch.isfinite(x).all()) for x in (*o_k, *g_k))
    rays, S = geo[0].shape[0], rest[-1]
    (b_fwd, _), _, (b_bwd, _) = mlp_bounds(
        weights, rays * S, nbytes(*geo, *rest[:2], *o_k), S)
    print(f"{label}: Kernel A's last training call ({rays} rays x {S} "
          f"samples) against its plain version: max|err| {err}; gradients "
          f"relL2 max {rels[worst]:.3e} ({worst}); fwd {times[0][0]:.3f} ms "
          f"(plain {times[1][0]:.3f}, bound {b_fwd:.3f}), bwd "
          f"{times[0][1]:.3f} ms (plain {times[1][1]:.3f}, bound "
          f"{b_bwd:.3f})")
    if not (finite and err["rgb"] <= RGB_ATOL and err["dist"] <= DIST_ATOL
            and err["alpha"] <= ALPHA_ATOL and rels[worst] < GRAD_RELL2):
        raise AssertionError(f"{label}: Kernel A against its plain version "
                             f"at the run's inputs: {err}, {rels}, finite "
                             f"{finite}")
    return {"rays": rays, "max_abs_err": err, "max_rel_l2": rels[worst],
            "fwd_ms": times[0][0], "fwd_plain_ms": times[1][0],
            "fwd_bound_ms": b_fwd, "bwd_ms": times[0][1],
            "bwd_plain_ms": times[1][1], "bwd_bound_ms": b_bwd}


def to_f64(x):
    """The floating tensors of ``x`` (nested dicts) in float64."""
    if isinstance(x, dict):
        return {k: to_f64(v) for k, v in x.items()}
    return x.double()


def check_ssim_normal(dev, card, cfg, state):
    """One more step of the ssim_normal run's state with ``static
    ['normal_diff']`` asking for the normal term: its normal_diff held to
    the same function in float64 on the card (relL2 NORMAL_RELL2) and its
    rgb_s loss's gradient (the SSIM map's) to float64 (relL2
    SSIM_GRAD_RELL2); then the step's wall time without and with the term
    (in turns: off, on, on, off), the term being what the trainer skips."""
    import torch

    from nope_nerf_tpu_torch.losses import losses
    from nope_nerf_tpu_torch.ops import rendering
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import (make_render_cfg,
                                                      make_train_step)

    cfg = dict(cfg, _num_cams=N_FRAMES)
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    batch = dict(scene_batch_arrays(scene, cfg, dev), idx=2, ref_idx=3)
    _, init_c2w = build_params(cfg, scene, torch.Generator().manual_seed(SEED),
                               dev)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    static = sched.static_flags(0)
    step = make_train_step(cfg, make_render_cfg(cfg, dev), init_c2w)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with recording(rendering, "normal_diff", copy=True) as nd_calls, \
            recording(losses, "rgb_s_loss", copy=True) as rgbs_calls:
        _, aux = step(state, batch, scalars, dict(static, normal_diff=True),
                      gen)
    (params, points, jitter, rcfg), _ = nd_calls[0]
    with torch.no_grad():
        nd32 = rendering.normal_diff(params, points, jitter, rcfg)
        nd64 = rendering.normal_diff(to_f64(params), points.double(),
                                     jitter.double(), rcfg)
    nd_rel = rel_l2(nd32.double(), nd64)
    same = torch.equal(nd32, aux["normal_diff"])
    (rgb1, rgb2, valid, with_ssim), kw = rgbs_calls[0]
    grads = []
    for dt in (torch.float32, torch.float64):
        y = rgb2.to(dt).requires_grad_()
        loss = losses.rgb_s_loss(rgb1.to(dt), y, valid.to(dt), with_ssim,
                                 **{k: v.to(dt) for k, v in kw.items()
                                    if v is not None})
        grads.append((float(loss.detach()),
                      torch.autograd.grad(loss, y)[0]))
    ssim_rel = rel_l2(grads[0][1].double(), grads[1][1])
    loss_rel = abs(grads[0][0] - grads[1][0]) / abs(grads[1][0])
    print(f"ssim_normal checks [{card}]: normal_diff of {points.shape[0]} "
          f"rays (mean {float(nd64.mean()):.4f}) against float64 relL2 "
          f"{nd_rel:.3e} (the step's own equal to the rerun: {same}); "
          f"rgb_s with the SSIM map ({tuple(rgb2.shape)}): value rel "
          f"{loss_rel:.3e}, d/d(reprojected colours) relL2 {ssim_rel:.3e} "
          "against float64")
    if not (with_ssim and same and nd_rel <= NORMAL_RELL2
            and ssim_rel <= SSIM_GRAD_RELL2):
        raise AssertionError(f"ssim_normal: normal_diff relL2 {nd_rel} "
                             f"(bar {NORMAL_RELL2}, step's equal {same}), "
                             f"SSIM gradient relL2 {ssim_rel} (bar "
                             f"{SSIM_GRAD_RELL2}), with_ssim {with_ssim}")

    def timed(normal):
        flags = dict(static, normal_diff=normal)
        return host_ms(lambda: step(state, batch, scalars, flags, gen),
                       iters=10, warmup=2)

    off1, on1, on2, off2 = timed(False), timed(True), timed(True), timed(False)
    print(f"ssim_normal step [{card}]: {off1:.3f}, {off2:.3f} ms without the "
          f"normal term (the trainer's choice: no loss reads it), {on1:.3f}, "
          f"{on2:.3f} ms with it")
    return {"normal_diff_rel_l2": nd_rel, "ssim_grad_rel_l2": ssim_rel,
            "ssim_loss_rel": loss_rel, "step_ms_without_normal": [off1, off2],
            "step_ms_with_normal": [on1, on2]}


def check_argmin_calls(label, kernel, plain, calls):
    """Rerun recorded calls of a Chamfer argmin wrapper through the kernel
    and its plain version: identical indices required."""
    import torch

    def mismatches(a, b):
        if torch.is_tensor(a):
            a, b = (a,), (b,)
        return sum(int(torch.sum(x != y)) for x, y in zip(a, b))

    mism = 0
    for args, kwargs in calls:
        mism += mismatches(kernel(*args, **kwargs), plain(*args, **kwargs))
    if not calls or mism:
        raise AssertionError(f"{label}: {len(calls)} recorded calls, {mism} "
                             "indices differ from the plain version")
    X, Y = calls[-1][0][:2]
    return {"calls": len(calls), "points": [X.shape[0], Y.shape[0]],
            "index_mismatches": mism}


def check_point_mlp_call(label, calls):
    """Rerun the last recorded call of Kernel C's forward wrapper through
    the kernel and its plain version, at check_kernel_c's bars."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (args, kwargs), = calls
    with torch.no_grad():
        out_k = mk.fused_mlp(*args, **kwargs)
        out_r = mk.fused_mlp_reference(*args, **kwargs)
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "density"), out_k, out_r)}
    finite = all(bool(torch.isfinite(o).all()) for o in out_k)
    if not (finite and err["rgb"] <= RGB_ATOL
            and err["density"] <= ALPHA_ATOL):
        raise AssertionError(f"{label}: kernel C fwd against its plain "
                             f"version max|err| {err}, finite {finite}")
    return {"points": args[1].shape[0], "max_abs_err": err}


def run_synthetic(dev, card):
    """The synthetic phase (see the module docstring). Returns the launch
    counts of its main-path runs (training, the render CLI, the bench) and
    its measured numbers."""
    import torch

    from nope_nerf_tpu_torch import eval_poses, render, vis_poses
    from nope_nerf_tpu_torch.geometry.rays import arange_pixels
    from nope_nerf_tpu_torch.make_synthetic_dataset import write_dataset
    from nope_nerf_tpu_torch.ops.chamfer import resolve_chamfer_mode
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.phong import phong_render
    from nope_nerf_tpu_torch.ops.rendering import render_image
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg
    from nope_nerf_tpu_torch.training.visualize import (render_visdata,
                                                        visdata_view)
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    base = os.path.join(ROOT, "chiprun_out", "chip_smoke", "synthetic")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    teacher = SyntheticScene(n_frames=SYN_FRAMES, hw=SYN_HW, seed=SEED,
                             device=dev)
    write_dataset(teacher, os.path.join(base, "data", "scene"))
    print(f"synthetic [{card}]: teacher scene of {SYN_FRAMES} frames "
          f"{SYN_HW[0]}x{SYN_HW[1]} rendered and written in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = synthetic_cfg(base)
    ratio = cfg["training"]["pc_ratio"]
    n_pc = int(SYN_HW[0] / ratio) * int(SYN_HW[1] / ratio)
    mode = resolve_chamfer_mode(
        cfg["tpu"]["chamfer_mode"], n_pc, n_pc, n_devices=1,
        sharded_exact=False, hints_available=True)
    # the Chamfer kernel `auto` resolves to: its counter, wrapper and plain
    # version ("grid" runs none)
    argmin = {"band": ("chamfer_band", cb, "nearest_idx_banded",
                       cb.nearest_idx_banded_reference),
              "exact": ("chamfer_exact", ck, "nearest_idx_exact",
                        ck.nearest_idx_exact_reference)}.get(mode)
    torch.cuda.empty_cache()
    counters = reset_counts()
    t0 = time.perf_counter()
    with (recording(argmin[1], argmin[2], keep=2) if argmin
          else contextlib.nullcontext(())) as argmin_calls:
        state, _, scene, history = train(cfg, max_epochs=SYN_EPOCHS,
                                         device=dev)
    train_s = time.perf_counter() - t0
    counts = executed(counters)
    psnrs = [h["psnr"] for h in history]
    print(f"synthetic training [{card}]: {len(history)} epochs x "
          f"{history[0]['steps']} steps in {train_s:.1f} s (visualisations "
          f"and pair dumps included); PSNR per epoch "
          + " ".join(f"{p:.2f}" for p in psnrs))
    steps = sum(h["steps"] for h in history)
    if steps != SYN_EPOCHS * scene.N_imgs or not all(map(math.isfinite,
                                                         psnrs)):
        raise AssertionError(f"synthetic: {steps} steps, PSNRs {psnrs}")
    tail = sum(psnrs[-SYN_TAIL:]) / SYN_TAIL
    if not (psnrs[-1] >= psnrs[0] + SYN_PSNR_GAIN and tail >= SYN_PSNR_TAIL):
        raise AssertionError(f"synthetic: PSNR {psnrs[0]:.3f} -> "
                             f"{psnrs[-1]:.3f} dB, {tail:.3f} dB over the "
                             f"last {SYN_TAIL} epochs: less than a "
                             f"{SYN_PSNR_GAIN} dB gain or below "
                             f"{SYN_PSNR_TAIL} dB")
    rendering = os.path.join(cfg["training"]["out_dir"], "rendering")
    fired = fired_steps(SYN_EPOCHS, scene.N_imgs, SYN_VIS_EVERY)
    missing = [os.path.join("%04d_vis" % it, "0000_%s.png" % kind)
               for it in fired for kind in ("img", "depth", "geo")]
    pairs = [n for n in sorted(os.listdir(rendering))
             if n.endswith(("_img1.png", "_img2.png"))]
    missing = [n for n in missing
               if not os.path.isfile(os.path.join(rendering, n))]
    if len(fired) < 2 or missing or len(pairs) != 2 * len(fired):
        raise AssertionError(f"synthetic: rendering/ lacks {missing}; pair "
                             f"dumps {pairs} for steps {fired}")
    check_launches("synthetic training", counts,
                   ("mlp_composite_fwd", "mlp_composite_bwd",
                    "mlp_point_fwd", *(argmin[:1] if argmin else ()),
                    *MLP_GEMMS, *PAIR_KERNELS))
    print(f"synthetic training launches [{card}] (chamfer_mode auto -> "
          f"{mode} at {n_pc} points): {counts}; rendering/: "
          f"{len(fired)} visualisations, {len(pairs)} pair images")
    kernel_checks = {}
    if argmin:
        kernel_checks[argmin[0]] = check_argmin_calls(
            f"synthetic training's {argmin[0]}", getattr(argmin[1], argmin[2]),
            argmin[3], argmin_calls)

    counters = reset_counts()
    t0 = time.perf_counter()
    with recording(mk, "fused_mlp") as cli_calls:
        render_dir = render.main(cfg, device=dev)
    cli_ms = 1e3 * (time.perf_counter() - t0) / SYN_NOVEL
    render_counts = executed(counters)
    names = [os.path.join(d, f"{i:04d}.png") for i in range(SYN_NOVEL)
             for d in ("img_out", "depth_out", "geo_out")]
    names += [os.path.join("depth_out", f"{i}.npy") for i in range(SYN_NOVEL)]
    names += [os.path.join("video_out", f"{v}.mp4")
              for v in ("img", "depth", "geo")]
    missing = [n for n in names if not os.path.isfile(
        os.path.join(render_dir, n))]
    if missing or render_counts["mlp_composite_fwd"] < SYN_NOVEL:
        raise AssertionError(f"render CLI: missing {missing}; Kernel A "
                             f"forwards {render_counts['mlp_composite_fwd']}"
                             f" for {SYN_NOVEL} views")
    check_launches("render CLI", render_counts,
                   ("mlp_composite_fwd", "mlp_point_fwd", "mlp_fused_fwd"),
                   weight_grads=False)
    kernel_checks["mlp_point_fwd"] = [check_point_mlp_call(
        "render CLI's last view", cli_calls)]
    print(f"render CLI [{card}]: {SYN_NOVEL} interp views at "
          f"{SYN_HW[0]}x{SYN_HW[1]} with the geo pass, {cli_ms:.1f} ms per "
          f"view (render, Phong, PNGs); launches {render_counts}")
    ply = vis_poses.main(cfg)
    poses = eval_poses.main(cfg, vis=True)
    pose_ply = os.path.join(cfg["training"]["out_dir"], "pose_vis.ply")
    if not (os.path.getsize(ply) and os.path.getsize(pose_ply)
            and all(math.isfinite(v) for v in poses.values())):
        raise AssertionError(f"vis_poses / eval_poses: {ply}, {poses}")

    # the time of one render_visdata call at the stock vis_resolution, and
    # of its two parts; then of one novel view's render
    render_cfg = make_render_cfg(cfg, dev)
    init_c2w = torch.as_tensor(scene.c2ws, dtype=torch.float32, device=dev)
    vis_hw = tuple(cfg["training"]["vis_resolution"])
    nerf = state.params["nerf"]
    with torch.no_grad():
        view = visdata_view(state.params, cfg, init_c2w, scene)
    _, pixels = arange_pixels(vis_hw, device=dev)
    # Kernel C's forward at the surface points of that view's Phong preview
    with recording(mk, "fused_mlp") as vis_calls:
        phong_render(nerf, pixels, *view, render_cfg,
                     rad=cfg["rendering"]["radius"])
    kernel_checks["mlp_point_fwd"].append(check_point_mlp_call(
        "render_visdata's Phong preview", vis_calls))
    print(f"synthetic kernel checks [{card}] at this phase's inputs: "
          f"{json.dumps(kernel_checks)}")
    vis_dir = os.path.join(base, "timed_vis")
    ms_vis = host_ms(lambda: render_visdata(
        state, cfg, render_cfg, init_c2w, scene, vis_hw, 0, vis_dir), iters=3)
    ms_vis_render = host_ms(lambda: render_image(
        nerf, vis_hw, *view, render_cfg, chunk=min(vis_hw[0] * vis_hw[1],
                                                  16384)), iters=3)
    ms_vis_phong = host_ms(lambda: phong_render(
        nerf, pixels, *view, render_cfg, rad=cfg["rendering"]["radius"]),
        iters=3)
    ms_view = host_ms(lambda: render_image(nerf, SYN_HW, *view, render_cfg),
                      iters=5)
    print(f"synthetic timings [{card}]: render_visdata at {vis_hw[0]}x"
          f"{vis_hw[1]} {ms_vis:.1f} ms (render {ms_vis_render:.1f} ms, "
          f"Phong {ms_vis_phong:.1f} ms); a {SYN_HW[0]}x{SYN_HW[1]} novel "
          f"view's render {ms_view:.1f} ms")

    rec, bench_counts = short_bench(dev, card, {})
    rec_k, bench_k_counts = short_bench(
        dev, card, {"rays_per_step_multiplier": K_FRAMES})
    print(f"bench short [{card}]: k = 1 {rec['value']:.1f} rays/s, "
          f"k = {K_FRAMES} {rec_k['value']:.1f} rays/s "
          f"({rec_k['value'] / rec['value']:.3f}x)")

    total = {k: counts[k] + render_counts[k] + bench_counts[k]
             + bench_k_counts[k] for k in counts}
    return total, {"psnr_per_epoch": psnrs, "psnr_tail_mean": tail,
                   "train_s": train_s,
                   "chamfer_mode": mode, "render_visdata_ms": ms_vis,
                   "render_visdata_render_ms": ms_vis_render,
                   "render_visdata_phong_ms": ms_vis_phong,
                   "novel_view_render_ms": ms_view,
                   "render_cli_ms_per_view": cli_ms,
                   "kernel_checks": kernel_checks,
                   "bench_short": rec, f"bench_short_k{K_FRAMES}": rec_k,
                   "pose_errors": poses}


# The recovery phase: poses recovered from scratch, the product of the
# method, on the scene and config of scripts/torch_reproduce_synthetic.sh
# (the JAX package's teacher at seed 3 from tests/fixtures/teacher_seed3.npz,
# 20 frames of 96x128 written to disk and read back by get_scene, which
# holds 2 out; hidden 128, 64 samples, 1024 rays, identity poses, the
# auto-scheduler, chamfer_mode auto): that script's training through
# train(), its whole schedule (REC_EPOCHS None: until the auto-scheduler
# ends it, 700-1000 epochs, 30-55 s on an H100). The gate: the mean ATE of
# the last REC_TAIL epochs under REC_ATE_FRACTION of the first epoch's ATE.
# A run's ATE is chaotic in the f32 rounding of its gradients: on an H100
# (700 W) the first 130 epochs met the gate for exactly one rounding (the
# layer-by-layer backward at its stock split counts: 0.45) and for none of
# 18 others (that backward or the fused one with other split counts:
# 0.52-1.11 of the start), and that one rounding read 0.59 at epoch 300;
# over the whole schedule 6 of 8 roundings (3 of each backward) end at
# 0.16-0.29 and one of each stalls at 0.57-0.60 (PERF.md §6, PR 14;
# tools/torch_recovery_rounding_probe.py). The control
# (``--recovery-control``) runs the same phase with the pose learning rate
# at 0, which the gate must reject (1.00 of its start).
REC_SEED, REC_FRAMES, REC_HW = 3, 20, (96, 128)
REC_EPOCHS, REC_TAIL, REC_ATE_FRACTION = None, 10, 0.5


def recovery_scene_yaml(base):
    """The scene.yaml that scripts/torch_reproduce_synthetic.sh writes with
    OUT = ``base`` (tests/test_torch_scripts.py holds the two equal)."""
    return {
        "model": {"hidden_dim": 128},
        "dataloading": {"path": os.path.join(base, "data"),
                        "scene": ["scene"], "resize_factor": None},
        "rendering": {"num_points": 64},
        "depth": {"type": "None"},
        "pose": {"learn_pose": True, "init_pose": False},
        "training": {"out_dir": os.path.join(base, "out"),
                     "n_training_points": 1024, "print_every": 190,
                     "checkpoint_every": 2000, "backup_every": 0,
                     "visualize_every": 0, "auto_scheduler": True,
                     "length_smooth": 100, "patient": 12,
                     "scheduling_start": 1200, "scheduling_epoch": 600,
                     "annealing_epochs": 300},
        "eval_pose": {"opt_pose_epoch": 200},
        "extract_images": {"N_novel_imgs": 20, "traj_option": "interp",
                           "resolution": list(REC_HW)},
    }


def run_recovery(dev, card, pose_lr=None):
    """The recovery phase (see REC_EPOCHS). With ``pose_lr`` the poses learn
    at that rate instead (the control). Returns the launch counts of its
    training and its record; raises when the ATE gate rejects the run."""
    import torch

    from nope_nerf_tpu_torch.config import update_recursive
    from nope_nerf_tpu_torch.make_synthetic_dataset import write_dataset
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.training.checkpoints import load_pytree
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    base = os.path.join(WORK, "recovery")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    teacher, _, _ = load_pytree(os.path.join(
        ROOT, "tests", "fixtures", f"teacher_seed{REC_SEED}.npz"))
    write_dataset(SyntheticScene(n_frames=REC_FRAMES, hw=REC_HW,
                                 seed=REC_SEED, num_points=32,
                                 teacher=teacher, device=dev),
                  os.path.join(base, "data", "scene"))
    cfg = stock_cfg()
    update_recursive(cfg, recovery_scene_yaml(base))
    if pose_lr is not None:
        cfg["training"]["pose_lr"] = pose_lr
    gen_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    counters = reset_counts()
    t0 = time.perf_counter()
    with recording(cb, "nearest_idx_banded", keep=2) as argmin_calls, \
            kernel_a_training_call() as a_call, \
            per_step_launches() as step_counts:
        _, _, scene, history = train(cfg, max_epochs=REC_EPOCHS, device=dev)
    train_s = time.perf_counter() - t0
    counts = executed(counters)
    ate = [h["ate_trans"] for h in history]
    psnr = [h["psnr"] for h in history]
    ms = sorted(h["ms_per_step"] for h in history)
    print(f"recovery [{card}]: {len(history)} epochs x {history[0]['steps']}"
          f" steps from identity poses in {train_s:.1f} s (scene "
          f"{gen_s:.1f} s, median {ms[len(ms) // 2]:.3f} ms/step wall); ATE "
          f"every 10th epoch " + " ".join(f"{a:.4f}" for a in ate[::10])
          + f" -> {ate[-1]:.4f}; PSNR {psnr[0]:.2f} -> {psnr[-1]:.2f} dB")
    steps = sum(h["steps"] for h in history)
    if (len(history) <= REC_TAIL or steps != len(history) * scene.N_imgs
            or (REC_EPOCHS is not None and len(history) != REC_EPOCHS)
            or not all(map(math.isfinite, ate + psnr))):
        raise AssertionError(f"recovery: {len(history)} epochs, {steps} "
                             f"steps, ATE {ate}, PSNR {psnr}")
    tail = sum(ate[-REC_TAIL:]) / REC_TAIL
    if not tail < REC_ATE_FRACTION * ate[0]:
        raise AssertionError(f"recovery: ATE {ate[0]:.5f} -> {tail:.5f} "
                             f"(mean of the last {REC_TAIL} of {len(history)} "
                             f"epochs), not under {REC_ATE_FRACTION} of its "
                             "start")
    check_launches("recovery training", counts,
                   ("mlp_composite_fwd", "mlp_composite_bwd", "chamfer_band",
                    *MLP_GEMMS, *PAIR_KERNELS))
    check_per_step("recovery training", step_counts)
    kernel_checks = {
        "chamfer_band": check_argmin_calls(
            "recovery's last step's chamfer_band", cb.nearest_idx_banded,
            cb.nearest_idx_banded_reference, argmin_calls),
        "mlp_composite": check_kernel_a_call(f"recovery [{card}]", a_call)}
    print(f"recovery launches [{card}]: {counts}")
    shutil.rmtree(base)
    return counts, {"epochs": len(history), "steps": steps,
                    "ate_per_epoch": ate, "psnr_per_epoch": psnr,
                    "ate_tail_fraction": tail / ate[0],
                    "gate_fraction": REC_ATE_FRACTION,
                    "rpe_trans_last": history[-1]["rpe_trans"],
                    "rpe_rot_last": history[-1]["rpe_rot"],
                    "train_s": train_s, "scene_s": gen_s,
                    "median_ms_per_step": ms[len(ms) // 2],
                    "kernel_checks": kernel_checks}


def recovery_control(dev, card):
    """The ATE gate's control: the recovery phase with the pose learning
    rate at 0, so the poses stay where they start. Returns 0 when the gate
    rejects the run, as it must."""
    try:
        run_recovery(dev, card, pose_lr=0.0)
    except AssertionError as e:
        if "ATE" in str(e) and "not under" in str(e):
            print(f"recovery control [{card}]: rejected: {e}")
            return 0
        raise
    print(f"recovery control [{card}]: the ATE gate passed a run whose "
          "poses never learned", file=sys.stderr)
    return 1


# The multigpu phase (tpu.n_devices > 1, nope_nerf_tpu_torch/parallel) at
# the stock shapes: one process per rank under torch.distributed. W = 1 runs
# under NCCL in this process through make_ray_mesh(1) and must equal the
# unsharded step bit for bit. W = 2 runs two worker processes: over NCCL on
# two cards when the machine has them, else both on card 0 over gloo
# (NCCL refuses two ranks on one card; allow_shared_device). Against the
# one-process step at the same global batch: Kernel A's rows are per ray, so
# each rank's rgb and depth rows are expected bitwise (bar MG_OUT_ATOL); the
# loss sums the ranks' parts in another order (MG_LOSS_RTOL); the gradient
# is the mean of two partial gradients (relL2 MG_GRAD_RELL2 per group).
# After MG_STEPS steps the ranks' parameters must be bitwise equal. A
# step with fuse_compositing False and chamfer_mode exact (MG_UNFUSED) runs
# Kernels C and D per rank, held to the one-process step likewise. Each
# rank then trains 2 epochs x MG_FRAMES steps through train() (the first
# epoch's visualisation and pair dump, rank 0 writing; eager steps over
# gloo) and runs dpt_depth on
# MG_DPT_FRAMES frames, whose priors are held to a one-device run's.
MG_STEPS, MG_FRAMES, MG_DPT_FRAMES, MG_JOIN_S = 8, 4, 3, 420
# one more step per rank on the route of Kernels C and D, held to the
# one-process step at the same bars; per step Kernel C once each way (the
# rank's 512 rays x 128 samples in one launch) and Kernel D twice, A and B
# idle
MG_UNFUSED = {"fuse_compositing": False, "chamfer_mode": "exact"}
MG_UNFUSED_STEP = {"mlp_point_fwd": 1, "mlp_point_bwd": 1, "chamfer_exact": 2,
                   "mlp_fused_fwd": 1, "mlp_composite_fwd": 0,
                   "mlp_composite_bwd": 0, "chamfer_band": 0}
MG_OUT_ATOL, MG_LOSS_RTOL, MG_GRAD_RELL2 = 1e-6, 1e-5, 1e-3
# dpt_depth on two ranks against one device: the ranks' batches of 2 frames
# and the one device's batch of 3 take different cuDNN algorithms. On an
# H100 (700 W) they differ by relL2 1.4e-6 per frame, the size of the
# network's own f32 error against float64 (1.55e-6, PERF.md §6); the bar
# is a tenth of DPT_RELL2
MG_DPT_RELL2 = 1e-5


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mg_setup(dev, tpu=None):
    """The stock step at full width from seeds, with the ``tpu`` overrides:
    (cfg, scene, batch0, render_cfg, scalars, static, fresh) where
    ``fresh()`` builds the same (TrainState, init_c2w) every call."""
    import torch

    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_render_cfg)

    cfg = stock_cfg()
    cfg["tpu"].update(tpu or {})
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    cfg["_num_cams"] = scene.N_imgs
    batch0 = scene_batch_arrays(scene, cfg, dev)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}

    def fresh():
        params, init_c2w = build_params(
            cfg, scene, torch.Generator().manual_seed(SEED), dev)
        return init_train_state(params), init_c2w

    return (cfg, scene, batch0, make_render_cfg(cfg, dev), scalars,
            sched.static_flags(0), fresh)


def mg_batch(batch0, scene, i):
    n = scene.N_imgs
    return dict(batch0, idx=[i % n], ref_idx=scene.sample_ref_idx(i % n))


@contextlib.contextmanager
def captured_render():
    """Inside the block, the rgb and depth_pred of each training render."""
    from nope_nerf_tpu_torch.training import trainer

    real = trainer.render_ray_batch
    outs = []

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        outs.append((out["rgb"].detach().clone(),
                     out["depth_pred"].detach().clone()))
        return out

    trainer.render_ray_batch = wrapper
    try:
        yield outs
    finally:
        trainer.render_ray_batch = real


def mg_step(step, state, batch, scalars, static, dev, seed):
    """One step from a generator seeded ``seed``: (loss, the render's (rgb,
    depth) rows, the gradients Adam read by group, this step's launches)."""
    import torch

    counters = kernel_counters()
    before = [c.count for c in counters]
    with captured_render() as outs:
        _, aux = step(state, batch, scalars, static,
                      torch.Generator(device=dev).manual_seed(seed))
    grads = {g["name"]: torch.cat([p.grad.reshape(-1) for p in g["params"]])
             for g in state.optimizer.param_groups}
    return (aux["loss"].clone(), outs[-1], grads,
            {c.name: c.count - b for c, b in zip(counters, before)})


def flat_params(state):
    import torch

    return torch.cat([p.detach().reshape(-1)
                      for g in state.optimizer.param_groups
                      for p in g["params"]])


def check_mg_launches(label, counts, want=None):
    """A step launched the kernels of ``want`` (default PER_STEP: Kernel A
    once each way and Kernel B twice) that often."""
    want = PER_STEP if want is None else want
    bad = {n: counts[n] for n in want if counts[n] != want[n]}
    if bad:
        raise AssertionError(f"{label}: launches {bad}, expected {want}")


def mg_one_rank(dev, card):
    """W = 1 under NCCL through make_ray_mesh(1): the sharded step against
    the unsharded one, bitwise (loss, gradients, parameters after Adam),
    for two steps; each step's launches; then both steps timed in turns.
    Returns the launch counts of the sharded steps and the numbers."""
    import torch
    import torch.distributed as dist

    from nope_nerf_tpu_torch.parallel.mesh import make_ray_mesh
    from nope_nerf_tpu_torch.training.trainer import make_train_step

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_ray_mesh(1)
        if mesh.backend != "nccl":
            raise AssertionError(f"W = 1 mesh on {mesh.backend}")
        cfg, scene, batch0, rcfg, scalars, static, fresh = mg_setup(dev)
        (plain_state, init_c2w), (mesh_state, _) = fresh(), fresh()
        plain = make_train_step(cfg, rcfg, init_c2w)
        sharded = make_train_step(cfg, rcfg, init_c2w, mesh=mesh)
        reset_counts()
        counts = collections.Counter()
        for i in range(2):
            batch = mg_batch(batch0, scene, i)
            a = mg_step(plain, plain_state, batch, scalars, static, dev, i)
            b = mg_step(sharded, mesh_state, batch, scalars, static, dev, i)
            check_mg_launches(f"multigpu W = 1 step {i}", b[3])
            counts.update(b[3])
            same = {"loss": bool(torch.equal(a[0], b[0])),
                    "rgb": bool(torch.equal(a[1][0], b[1][0])),
                    "depth": bool(torch.equal(a[1][1], b[1][1])),
                    "grads": all(torch.equal(a[2][g], b[2][g]) for g in a[2]),
                    "params": bool(torch.equal(flat_params(plain_state),
                                               flat_params(mesh_state)))}
            if not all(same.values()):
                raise AssertionError(f"multigpu W = 1 step {i}: bitwise "
                                     f"equal to the unsharded step {same}")
        counts = {c.name: counts[c.name] for c in kernel_counters()}
        # the scan path under the mesh: its all-reduces captured into the
        # graph (NCCL), against the same epochs eager
        setup = scan_setup(dev, {})
        scan_numbers = compare_routes(
            "multigpu W = 1 scan",
            scan_route(dev, setup, False, mesh=mesh, timed=False),
            scan_route(dev, setup, True, mesh=mesh, timed=False),
            lambda: scan_route(dev, setup, False, mesh=mesh, timed=False))
        times = {}
        for label, step, state in (("plain", plain, plain_state),
                                   ("mesh", sharded, mesh_state),
                                   ("mesh", sharded, mesh_state),
                                   ("plain", plain, plain_state)):
            it = iter(range(2, 100))
            ms = host_ms(lambda: step(state, mg_batch(batch0, scene, next(it)),
                                      scalars, static), iters=8)
            times.setdefault(label, []).append(ms)
        print(f"multigpu W = 1 [{card}]: NCCL mesh of 1, the sharded step "
              f"bitwise equal to the unsharded one over 2 steps (loss, rgb, "
              f"depth, gradients, parameters after Adam); the scan path "
              f"under the mesh, {EPOCHS} epochs captured against eager: "
              f"bitwise ({scan_numbers}); ms/step plain "
              f"{times['plain']}, mesh {times['mesh']}; launches {counts}")
        return counts, {"backend": mesh.backend, "bitwise_steps": 2,
                        "ms_per_step": times}
    finally:
        dist.destroy_process_group()


def mg_worker(rank, port, out, dpt_cfg_path):
    """One rank of the W = 2 run (see the block comment above): writes its
    results to ``out/rank<rank>.json`` and its tensors to ``.pt``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from nope_nerf_tpu_torch import dpt_depth
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.parallel.mesh import (make_ray_mesh,
                                                   shard_train_step)
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_cards = torch.cuda.device_count()
    torch.cuda.set_device(rank % n_cards)
    dist.init_process_group("nccl" if n_cards >= 2 else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        card = card_line()
        mesh = make_ray_mesh(2, allow_shared_device=True)
        dev = mesh.device
        label = f"multigpu W = 2 rank {rank} ({mesh.backend}, {dev})"
        cfg, scene, batch0, rcfg, scalars, static, fresh = mg_setup(dev)
        state, init_c2w = fresh()
        step = shard_train_step(cfg, rcfg, init_c2w, mesh)
        counters = reset_counts()
        with kernel_a_training_call() as a_call, \
                recording(cb, "nearest_idx_banded", keep=2) as b_calls:
            first = mg_step(step, state, mg_batch(batch0, scene, 0), scalars,
                            static, dev, 0)
            per_step = [first[3]]
            for i in range(1, MG_STEPS):
                per_step.append(mg_step(step, state, mg_batch(batch0, scene, i),
                                        scalars, static, dev, i)[3])
        counts = executed(counters)
        for i, c in enumerate(per_step):
            check_mg_launches(f"{label} step {i}", c)
        a_check = check_kernel_a_call(f"{label} [{card}]", a_call)
        if a_check["rays"] != N_RAYS // 2:
            raise AssertionError(f"{label}: Kernel A ran on "
                                 f"{a_check['rays']} rays, not {N_RAYS // 2}")
        b_check = check_argmin_calls(f"{label} chamfer_band",
                                     cb.nearest_idx_banded,
                                     cb.nearest_idx_banded_reference, b_calls)
        it = iter(range(MG_STEPS, MG_STEPS + 100))
        ms = host_ms(lambda: step(state, mg_batch(batch0, scene, next(it)),
                                  scalars, static), iters=5)
        dev_ms = device_ms(lambda: step(
            state, mg_batch(batch0, scene, next(it)), scalars, static),
            iters=3, warmup=1)

        # the route of Kernels C and D, one step
        ucfg, uscene, ubatch0, urcfg, uscalars, ustatic, ufresh = mg_setup(
            dev, MG_UNFUSED)
        ustate, uc2w = ufresh()
        reset_counts()
        with recording(mk, "fused_mlp", copy=True) as c_calls, \
                recording(ck, "nearest_idx_exact", keep=2) as d_calls:
            unfused = mg_step(shard_train_step(ucfg, urcfg, uc2w, mesh),
                              ustate, mg_batch(ubatch0, uscene, 0), uscalars,
                              ustatic, dev, 0)
        unfused_counts = executed(counters)
        check_mg_launches(f"{label} unfused step", unfused[3],
                          MG_UNFUSED_STEP)
        c_check = check_point_mlp_call(f"{label} Kernel C fwd", c_calls)
        if c_check["points"] != N_RAYS // 2 * ucfg["rendering"]["num_points"]:
            raise AssertionError(f"{label}: Kernel C ran on "
                                 f"{c_check['points']} points")
        d_check = check_argmin_calls(f"{label} chamfer_exact",
                                     ck.nearest_idx_exact,
                                     ck.nearest_idx_exact_reference, d_calls)

        def result(r, st=None):
            return {"loss": r[0].cpu(), "rgb": r[1][0].cpu(),
                    "depth": r[1][1].cpu(),
                    "grads": {k: v.cpu() for k, v in r[2].items()},
                    "params": None if st is None else flat_params(st).cpu()}

        torch.save({"stock": result(first, state), "unfused": result(unfused)},
                   os.path.join(out, f"rank{rank}.pt"))

        tcfg = stock_cfg()
        tcfg["training"].update(out_dir=os.path.join(out, "train"),
                                seed=SEED, vis_reprojection_every=10000)
        tcfg["tpu"]["n_devices"] = 2
        reset_counts()
        _, _, _, hist = train(tcfg, max_epochs=EPOCHS,
                              scene=MemoryScene(MG_FRAMES, H, W, SEED + 1),
                              device=dev, mesh=mesh)
        train_counts = executed(counters)
        losses = [v for h in hist for v in h["step_losses"]]
        if len(losses) != EPOCHS * MG_FRAMES or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"{label}: train() losses {losses}")
        dpt_dir = dpt_depth.main(load_config(dpt_cfg_path, DEFAULT_CONFIG),
                                 device=dev, mesh=mesh)
        rec = {"rank": rank, "backend": mesh.backend, "device": str(dev),
               "counts": counts, "train_counts": train_counts,
               "unfused_counts": unfused_counts, "kernel_a": a_check,
               "chamfer_band": b_check, "kernel_c_fwd": c_check,
               "chamfer_exact": d_check,
               "ms_per_step": ms, "device_ms_per_step": dev_ms,
               "train_losses": losses, "dpt_dir": dpt_dir}
        print(f"{label} [{card}]: {MG_STEPS} steps, launches {counts}; "
              f"{ms:.3f} ms/step, device {dev_ms:.3f} ms/step; unfused step "
              f"launches {unfused_counts}; train() "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, launches "
              f"{train_counts}")
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def mg_two_ranks(dev, card):
    """W = 2 (see the block comment above): two worker processes, joined
    with a timeout; their results against the one-process step and a
    one-device dpt_depth run. Returns the ranks' launch counts summed, and
    the numbers."""
    import multiprocessing

    import numpy as np
    import torch
    import yaml

    from nope_nerf_tpu_torch import dpt_depth
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.training.trainer import make_train_step

    out = os.path.join(WORK, "multigpu")
    shutil.rmtree(out, ignore_errors=True)
    data = os.path.join(out, "data")
    write_llff_scene(os.path.join(data, "scene"), MG_DPT_FRAMES, (H, W),
                     SEED + 2)
    npz = os.path.join(WORK, "dpt", "dpt.npz")
    cfgs = {}
    for name, n_dev in (("dpt_two", 2), ("dpt_one", 1)):
        cfgs[name] = os.path.join(out, f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump({"depth": {"type": "DPT", "path": npz},
                            "dataloading": {"path": data, "scene": ["scene"],
                                            "resize_factor": None,
                                            "depth_net": name},
                            "training": {"mode": "all"},
                            "tpu": {"n_devices": n_dev}}, f)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mg_worker, args=(r, port, out,
                                                 cfgs["dpt_two"]))
             for r in range(2)]
    for p in procs:
        p.start()
    # the one-process step and the one-device priors, while the ranks run
    cfg, scene, batch0, rcfg, scalars, static, fresh = mg_setup(dev)
    state, init_c2w = fresh()
    ref = mg_step(make_train_step(cfg, rcfg, init_c2w), state,
                  mg_batch(batch0, scene, 0), scalars, static, dev, 0)
    ucfg, uscene, ubatch0, urcfg, uscalars, ustatic, ufresh = mg_setup(
        dev, MG_UNFUSED)
    ustate, uc2w = ufresh()
    uref = mg_step(make_train_step(ucfg, urcfg, uc2w), ustate,
                   mg_batch(ubatch0, uscene, 0), uscalars, ustatic, dev, 0)
    one_dir = dpt_depth.main(load_config(cfgs["dpt_one"], DEFAULT_CONFIG),
                             device=dev)
    for p in procs:
        p.join(timeout=max(MG_JOIN_S - (time.perf_counter() - t0), 1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"multigpu W = 2 workers: exit codes {codes}, "
                             f"{len(hung)} killed after {MG_JOIN_S} s")
    wall_s = time.perf_counter() - t0
    recs = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    saved = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]
    n = N_RAYS // 2
    rows = [slice(0, n), slice(n, N_RAYS)]

    def against(got, ref):
        """Each rank's rows, loss and gradients against the one-process
        step: (rgb/depth max|err|, loss rel, gradient relL2 by group)."""
        out_err = max(float(torch.max(torch.abs(g[k].to(dev) - ref[1][i][s])))
                      for g, s in zip(got, rows)
                      for i, k in enumerate(("rgb", "depth")))
        loss_rel = max(abs(float(g["loss"]) - float(ref[0]))
                       / abs(float(ref[0])) for g in got)
        grad_rel = {k: max(rel_l2(g["grads"][k].to(dev), v) for g in got)
                    for k, v in ref[2].items()}
        return out_err, loss_rel, grad_rel

    out_err, loss_rel, grad_rel = against([g["stock"] for g in saved], ref)
    u_err, u_loss_rel, u_grad_rel = against([g["unfused"] for g in saved],
                                            uref)
    params_equal = bool(torch.equal(saved[0]["stock"]["params"],
                                    saved[1]["stock"]["params"]))
    two_dir = recs[0]["dpt_dir"]
    names = sorted(f for f in os.listdir(one_dir) if f.endswith(".npz"))
    dpt_rel = {}
    for f in names:
        a = np.load(os.path.join(two_dir, f))["pred"]
        b = np.load(os.path.join(one_dir, f))["pred"]
        dpt_rel[f] = float(np.linalg.norm(a.astype(np.float64) - b)
                           / np.linalg.norm(b))
    files_two = sorted(os.listdir(two_dir))
    train_out = os.path.join(out, "train")
    written = sorted(os.listdir(os.path.join(train_out, "rendering")))
    print(f"multigpu W = 2 [{card}]: {recs[0]['backend']} on "
          f"{[r['device'] for r in recs]}; against the one-process step at "
          f"1024 rays: rgb/depth max|err| {out_err:.3e} (bar {MG_OUT_ATOL}),"
          f" loss rel {loss_rel:.3e} (bar {MG_LOSS_RTOL}), gradients relL2 "
          f"{grad_rel} (bar {MG_GRAD_RELL2}); parameters after {MG_STEPS} "
          f"steps bitwise equal across ranks: {params_equal}; the step on "
          f"Kernels C and D: rgb/depth max|err| {u_err:.3e}, loss rel "
          f"{u_loss_rel:.3e}, gradients relL2 {u_grad_rel}; train() "
          f"rendering/ {written}; dpt_depth 2 ranks vs 1 device relL2 "
          f"{dpt_rel} (bar {MG_DPT_RELL2}); workers {wall_s:.1f} s")
    ok = (out_err <= MG_OUT_ATOL and loss_rel <= MG_LOSS_RTOL
          and max(grad_rel.values()) <= MG_GRAD_RELL2 and params_equal
          and u_err <= MG_OUT_ATOL and u_loss_rel <= MG_LOSS_RTOL
          and max(u_grad_rel.values()) <= MG_GRAD_RELL2
          and len(names) == MG_DPT_FRAMES and files_two == sorted(
              os.listdir(one_dir))
          and max(dpt_rel.values()) <= MG_DPT_RELL2
          and "%04d_vis" % fired_steps(
              EPOCHS, MG_FRAMES,
              stock_cfg()["training"]["visualize_every"])[0]
          in written
          and any(f.endswith("_img1.png") for f in written)
          and os.path.isfile(os.path.join(train_out, "model.npz")))
    if not ok:
        raise AssertionError("multigpu W = 2: a check failed (line above)")
    counts = {k: sum(r["counts"][k] + r["unfused_counts"][k]
                     + r["train_counts"][k] for r in recs)
              for k in recs[0]["counts"]}
    shutil.rmtree(out)
    return counts, {"backend": recs[0]["backend"],
                    "devices": [r["device"] for r in recs],
                    "rgb_depth_max_abs_err": out_err, "loss_rel": loss_rel,
                    "grad_rel_l2": grad_rel, "params_bitwise": params_equal,
                    "unfused": {"rgb_depth_max_abs_err": u_err,
                                "loss_rel": u_loss_rel,
                                "grad_rel_l2": u_grad_rel},
                    "dpt_rel_l2": dpt_rel, "workers_s": wall_s,
                    "ranks": recs}


def run_multigpu(dev, card):
    """The multigpu phase: W = 1 under NCCL, then W = 2. Returns the launch
    counts of both and their numbers."""
    t0 = time.perf_counter()
    c1, rec1 = mg_one_rank(dev, card)
    c2, rec2 = mg_two_ranks(dev, card)
    counts = {k: c1[k] + c2[k] for k in c1}
    for name in ("mlp_composite_fwd", "mlp_composite_bwd", "chamfer_band"):
        if not (c1[name] and c2[name]):
            raise AssertionError(f"multigpu: {name} launched {c1[name]} "
                                 f"times at W = 1, {c2[name]} at W = 2")
    for name in ("mlp_point_fwd", "mlp_point_bwd", "chamfer_exact"):
        if not c2[name]:
            raise AssertionError(f"multigpu: {name} never launched at W = 2")
    secs = time.perf_counter() - t0
    print(f"multigpu phase [{card}]: {secs:.1f} s; launches {counts}")
    return counts, {"w1": rec1, "w2": rec2, "seconds": secs}


def short_bench(dev, card, overrides, layout=BENCH_SHORT):
    """A run of the bench entry (the scan path) with ``overrides`` as its
    BENCH_TPU_OVERRIDES and ``layout`` as its (steps per dispatch, warm-up
    dispatches, timed dispatches): its JSON line, its launches (Kernels A
    and B, the layer GEMMs) and each step's (:data:`PER_STEP`)."""
    import io

    import torch

    from nope_nerf_tpu_torch import bench

    saved = (bench.SCAN_STEPS, bench.WARMUP_DISPATCHES,
             bench.MEASURE_DISPATCHES, os.environ.get("BENCH_TPU_OVERRIDES"))
    bench.SCAN_STEPS, bench.WARMUP_DISPATCHES, bench.MEASURE_DISPATCHES = \
        layout
    os.environ["BENCH_TPU_OVERRIDES"] = json.dumps(overrides)
    torch.cuda.empty_cache()
    counters = reset_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                per_step_launches() as step_counts:
            bench.run(dev)
    finally:
        (bench.SCAN_STEPS, bench.WARMUP_DISPATCHES,
         bench.MEASURE_DISPATCHES) = saved[:3]
        if saved[3] is None:
            os.environ.pop("BENCH_TPU_OVERRIDES")
        else:
            os.environ["BENCH_TPU_OVERRIDES"] = saved[3]
    counts = executed(counters)
    lines = out.getvalue().splitlines()
    rec = json.loads(lines[-1])
    if len(lines) != 1 or rec["metric"] != "train_rays_per_sec" or not (
            rec["value"] > 0):
        raise AssertionError(f"bench {overrides}: printed {lines}")
    label = f"bench {json.dumps(overrides)}"
    check_launches(label, counts, ("mlp_composite_fwd", "mlp_composite_bwd",
                                   "chamfer_band", *MLP_GEMMS,
                                   *PAIR_KERNELS))
    check_per_step(label, step_counts)
    print(f"bench {json.dumps(overrides)} [{card}]: {layout[1]} x "
          f"{layout[0]} warm-up steps, {layout[2]} x {layout[0]} timed: "
          f"{json.dumps(rec)}")
    return rec, counts


def gate_control(dev, card):
    """The convergence gate's control: the synthetic phase with the field's
    weight-matrix gradients zeroed before every Adam step (its biases still
    learn). Returns 0 when the PSNR gate rejects the run, as it must."""
    import torch

    step = torch.optim.Adam.step

    def zeroed(self, *args, **kwargs):
        for group in self.param_groups:
            if group.get("name") == "nerf":
                for p in group["params"]:
                    if p.dim() == 2 and p.grad is not None:
                        p.grad.zero_()
        return step(self, *args, **kwargs)

    torch.optim.Adam.step = zeroed
    try:
        run_synthetic(dev, card)
    except AssertionError as e:
        if "PSNR" in str(e):
            print(f"gate control [{card}]: rejected: {e}")
            return 0
        raise
    finally:
        torch.optim.Adam.step = step
    print(f"gate control [{card}]: the PSNR gate passed a run whose weight "
          "matrices never learned", file=sys.stderr)
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--gate-control"], ["--recovery-control"],
                    ["--input-bwd"]) and not (
            len(argv) == 2 and argv[0] == "--fwd-turns"):
        print("usage: chip_smoke.py [--gate-control | --recovery-control | "
              "--input-bwd | --fwd-turns OTHER.cu]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "nope_nerf_tpu_torch")):
        print("chip_smoke: nope_nerf_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    # the package, and tests/ for the plain saves the fused forward is held to
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch device: {kind}")

    from nope_nerf_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})")
    if argv == ["--gate-control"]:
        return gate_control(dev, card)
    if argv == ["--recovery-control"]:
        return recovery_control(dev, card)
    if argv[:1] == ["--fwd-turns"]:
        fwd_source_turns(dev, card, argv[1])
        return 0
    if argv == ["--input-bwd"]:
        print(json.dumps({"kernels": [check_input_bwd(dev, card)]}))
        return 0

    a_fwd, a_bwd = check_kernel_a(dev, card)
    b = check_kernel_b(dev, card)
    c_fwd, c_bwd = check_kernel_c(dev, card)
    d = check_kernel_d(dev, card)
    fused_bwd = check_fused_bwd(dev, card)
    input_bwd = check_input_bwd(dev, card)
    a_bwd_parts, a_bwd_pair = check_composite_encode_bwd(dev, card)
    pair = check_ref_pair(dev, card)
    records = [a_fwd, a_bwd, b, c_fwd, c_bwd, d, fused_bwd, input_bwd,
               *a_bwd_parts, pair]
    launches = {rec["name"]: 0 for rec in records}
    runs = {}
    for label, overrides, expect in RUNS:
        with (kernel_a_training_call() if label in KERNEL_A_RUNS
              else contextlib.nullcontext()) as a_call:
            counts, state, cfg, history, step_counts = run_training(
                dev, card, label, overrides, expect)
        runs[label] = (cfg, state, history)
        if "mlp_composite_fwd" in expect:
            check_per_step(label, step_counts)
        if label in KERNEL_A_RUNS:
            runs[f"{label}_kernel_a"] = check_kernel_a_call(
                f"{label} [{card}]", a_call)
        for rec in records:
            launches[rec["name"]] += counts[rec["name"]]
    scan_counts, scan_rec = run_scan(dev, card)
    steps = {}
    for label in ("stock", "multiplier", "ssim_normal",
                  "multiplier_per_step"):
        last = runs[label][2][-1]
        steps[label] = {k: last[k] for k in ("ms_per_step", "rays_per_sec",
                                             "device_ms_per_step")}
    print(f"training steps [{card}], last epoch (ms/step wall on the host "
          "clock / device by CUDA events, rays/s on the wall time): "
          + "; ".join(f"{k} {v['ms_per_step']:.3f} / "
                      f"{v['device_ms_per_step']:.3f} ms/step, "
                      f"{v['rays_per_sec']:.1f} rays/s"
                      for k, v in steps.items())
          + f"; k = {K_FRAMES} / stock rays/s "
          f"{steps['multiplier']['rays_per_sec'] / steps['stock']['rays_per_sec']:.3f}")
    k4 = runs["multiplier_kernel_a"]
    for rec, key in ((a_fwd, "fwd"), (a_bwd, "bwd")):
        rec[f"k{K_FRAMES}_training_call"] = {
            "rays": k4["rays"], "ms": k4[f"{key}_ms"],
            "plain_ms": k4[f"{key}_plain_ms"],
            "bound_ms": k4[f"{key}_bound_ms"]}
    ssim_normal = check_ssim_normal(dev, card, *runs["ssim_normal"][:2])
    stock = runs["stock"][:2]
    eval_counts, eval_rec = run_eval(dev, card, *stock)
    dpt_counts, dpt_rec = run_dpt(dev, card)
    mg_counts, mg_rec = run_multigpu(dev, card)
    shutil.rmtree(os.path.join(WORK, "dpt"))
    syn_counts, syn_rec = run_synthetic(dev, card)
    rec_counts, rec_rec = run_recovery(dev, card)
    for rec in records:
        rec["launches"] = (launches[rec["name"]] + scan_counts[rec["name"]]
                           + eval_counts[rec["name"]]
                           + dpt_counts[rec["name"]] + mg_counts[rec["name"]]
                           + syn_counts[rec["name"]]
                           + rec_counts[rec["name"]])
        rec["scan_launches"] = scan_counts[rec["name"]]
        rec["eval_launches"] = eval_counts[rec["name"]]
        rec["dpt_launches"] = dpt_counts[rec["name"]]
        rec["multigpu_launches"] = mg_counts[rec["name"]]
        rec["synthetic_launches"] = syn_counts[rec["name"]]
        rec["recovery_launches"] = rec_counts[rec["name"]]
    print(json.dumps({"training": {
        "steps": steps, "multiplier_kernel_a": runs["multiplier_kernel_a"],
        "multiplier_per_step_kernel_a": runs["multiplier_per_step_kernel_a"],
        "ssim_normal": ssim_normal}}))
    print(json.dumps({"a_bwd_pair": a_bwd_pair}))
    print(json.dumps({"scan": scan_rec}))
    print(json.dumps({"eval": eval_rec}))
    print(json.dumps({"dpt": dpt_rec}))
    print(json.dumps({"multigpu": mg_rec}))
    print(json.dumps({"synthetic": syn_rec}))
    print(json.dumps({"recovery": rec_rec}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
