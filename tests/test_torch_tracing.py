"""The port's tracing (``nope_nerf_tpu_torch/tracing.py``) on the CPU: host
spans (nesting, parent, dispatch number, the ring's bound, per-name
totals, ``record_function`` only while a profiler records), the sections
that one eager training step and one pose step mark, Kernel A's backward
nested in ``step.backward``, nothing recorded outside a step, no device
time off CUDA, and the benchmark's readers of it (``benchmark/
program_trace.py``, ``benchmark/metrics/*``) on planted records. The
captured step's section timings are held to the dispatch's device time on
the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from nope_nerf_tpu_torch import tracing

torch.set_num_threads(1)

TRAIN_SECTIONS = ["step.rays", "step.field", "step.pair", "step.loss",
                  "step.backward", "step.update", "step.aux"]
POSE_SECTIONS = ["step.rays", "step.field", "step.loss", "step.backward",
                 "step.update", "step.aux"]


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _names(records):
    return [r.name for r in records]


def test_spans_nest_with_parent_and_dispatch_number():
    """A span's parent is the innermost span open when it opened; spans of
    one dispatch share its number, the next dispatch has the next number,
    and a dispatch keeps the host ns of its spans by name."""
    with tracing.span("outer"):
        with tracing.span("outer.inner"):
            pass
    with tracing.dispatch("train", 3, "cpu") as first:
        with tracing.span("dispatch.upload"):
            pass
        with tracing.span("dispatch.replay"):
            pass
        with tracing.span("dispatch.replay"):
            pass
    with tracing.dispatch("pose_opt", 2, "cpu") as second:
        with tracing.span("dispatch.upload"):
            pass
    got = {(r.name, r.dispatch): r for r in tracing.spans()}
    assert _names(tracing.spans())[:2] == ["outer.inner", "outer"]
    assert got[("outer.inner", None)].parent == "outer"
    assert got[("outer", None)].parent is None
    assert (first.number, second.number) == (1, 2)
    assert (first.phase, first.steps, second.phase) == ("train", 3,
                                                         "pose_opt")
    for name in ("dispatch.upload", "dispatch.replay"):
        assert got[(name, 1)].parent == "dispatch"
    assert got[("dispatch", 1)].parent is None
    assert got[("dispatch.upload", 2)].dispatch == 2
    replays = [r for r in tracing.spans() if r.name == "dispatch.replay"]
    assert first.host["dispatch.replay"] == sum(r.ns for r in replays)
    assert first.replay_min_ns == min(r.ns for r in replays)
    assert second.replay_min_ns is None
    assert first.idle and second.idle  # nothing waits on the CPU
    assert set(first.host) == {"dispatch", "dispatch.upload",
                               "dispatch.replay"}
    assert first.host["dispatch"] >= sum(
        v for k, v in first.host.items() if k != "dispatch")
    assert [d.number for d in tracing.dispatches()] == [1, 2]
    assert [d.number for d in tracing.dispatches("pose_opt")] == [2]


def test_the_ring_is_bounded_and_the_totals_count_every_span():
    n = tracing.RING + 25
    for i in range(n):
        with tracing.span("a" if i % 2 else "b"):
            pass
    kept = tracing.spans()
    assert len(kept) == tracing.RING
    assert _names(kept) == ["a" if i % 2 else "b"
                            for i in range(n - tracing.RING, n)]
    totals = tracing.totals()
    assert totals["a"][0] + totals["b"][0] == n
    for count, total, longest in totals.values():
        assert 0 <= longest <= total
    recent = max(r.ns for r in kept if r.name == "a")
    assert totals["a"][2] >= recent


def test_spans_reach_the_profiler_only_while_it_records(monkeypatch):
    """While a CPU ``torch.profiler`` session records, each span opens a
    ``record_function`` of its name (it is in the session's events); with
    no session recording, none is opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("dispatch"):
            with tracing.span("dispatch.replay"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"dispatch", "dispatch.replay"} <= names

    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with tracing.span("dispatch"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("dispatch"):
            pass
    assert opened == ["dispatch"]


def _train_setup(n_frames=4):
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_render_cfg)

    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"]["hidden_dim"] = 32
    cfg["rendering"]["num_points"] = 16
    cfg["training"].update(n_training_points=32, pc_ratio=2)
    cfg["tpu"]["chamfer_mode"] = "band"
    scene = MemoryScene(n_frames, 24, 32, 0)
    cfg["_num_cams"] = n_frames
    batch0 = scene_batch_arrays(scene, cfg, "cpu")
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    params, init_c2w = build_params(cfg, scene,
                                    torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(params)
    return (cfg, make_render_cfg(cfg, "cpu"), init_c2w, batch0, scalars,
            sched.static_flags(0), state)


def _step_spans(number):
    return [r for r in tracing.spans()
            if r.dispatch == number and r.name.startswith("step.")]


def test_an_eager_training_step_marks_its_sections_in_order():
    """One eager CPU training step (a one-step epoch of ``EpochStep``):
    the host spans ``step.rays`` ... ``step.aux`` in order inside the
    dispatch, beside ``dispatch.upload``, ``.scalars`` and ``.snapshot``;
    the step's boundaries end with ``tracing.END``; no device time (no
    section ms, no dispatch ms) on the CPU."""
    from nope_nerf_tpu_torch.training.trainer import make_epoch_step

    cfg, rcfg, init_c2w, batch0, scalars, static, state = _train_setup()
    run = make_epoch_step(cfg, rcfg, init_c2w, device="cpu")
    assert run.route == "eager"
    gen = torch.Generator().manual_seed(0)
    run(state, batch0, np.array([2]), np.array([3]), scalars, gen, static)
    rec = run.last_dispatch
    assert (rec.phase, rec.steps) == ("train", 1)
    assert _names(_step_spans(rec.number)) == TRAIN_SECTIONS
    assert all(r.parent == "dispatch" for r in _step_spans(rec.number))
    mine = [r for r in tracing.spans() if r.dispatch == rec.number]
    assert [r.name for r in mine if r.parent == "dispatch"
            and r.name.startswith("dispatch.")] == [
        "dispatch.upload", "dispatch.scalars", "dispatch.snapshot"]
    (sections,) = run.graphs.eager_sections.values()
    assert sections.names == TRAIN_SECTIONS + [tracing.END]
    assert sections.events == []
    assert rec.device_ms() is None
    assert tracing.section_ms("train") is None
    assert tracing.section_ms("train", eager=True) is None
    # a second epoch of two steps marks the same boundaries twice
    run(state, batch0, np.array([0, 1]), np.array([1, 2]), scalars, gen,
        static)
    assert _names(_step_spans(run.last_dispatch.number)) == (
        TRAIN_SECTIONS * 2)


def test_an_eager_pose_step_marks_its_sections_in_order():
    """One eager CPU pose step (a one-step block of ``PoseOptBlock``):
    ``step.rays``, ``.field``, ``.loss``, ``.backward``, ``.update`` and
    ``.aux`` in order, in a dispatch of phase "pose_opt"."""
    from nope_nerf_tpu_torch.evaluation.pose_opt import (PoseOptBlock,
                                                         pose_optimizer)
    from nope_nerf_tpu_torch.models.pose import init_pose_params

    cfg, rcfg, _, batch0, _, _, state = _train_setup()
    nerf = {k: {kk: t.detach() for kk, t in layer.items()}
            for k, layer in state.params["nerf"].items()}
    pose = init_pose_params(2, "cpu")
    for t in pose.values():
        t.requires_grad_(True)
    opt = pose_optimizer(pose, False)
    block = PoseOptBlock(cfg, rcfg, None, 16, (24, 32), "cpu")
    losses = block(nerf, pose, opt, batch0["imgs"][:2],
                   batch0["camera_mat_gt"], batch0["scale_mat"],
                   np.array([1e-3], np.float32), np.array([1]),
                   torch.Generator().manual_seed(0))
    assert losses.shape == (1,) and torch.isfinite(losses).all()
    rec = block.last_dispatch
    assert (rec.phase, rec.steps) == ("pose_opt", 1)
    assert _names(_step_spans(rec.number)) == POSE_SECTIONS
    assert rec.device_ms() is None
    assert tracing.section_ms("pose_opt") is None


def _kernel_a_backward_args(N=8, S=16, hidden=32, seed=0):
    """A context of ``FusedMLPComposite.backward`` built on CPU tensors:
    the saves of Kernel A's forward (the plain chain's, laid out as the
    fused forward saves them) and the cotangents of its outputs."""
    from _mlp_saves import plain_saves
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    class Ctx:
        pass

    cfg = {"model": {"hidden_dim": hidden, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    gen = torch.Generator().manual_seed(seed)
    weights = mk.collect_weights(init_nerf_params(gen, cfg))
    M = N * S
    origins, rays, dirs = (torch.randn((N, 3), generator=gen)
                           for _ in range(3))
    z = torch.sort(torch.rand((N, S), generator=gen) * 4 + 1, 1).values
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full((N, 1), 1e10)], 1)
    enc = torch.zeros((M, mk._pad8(63)), dtype=torch.bfloat16)
    enc[:, :63] = torch.randn((M, 63), generator=gen).to(torch.bfloat16)
    denc = torch.zeros((N, mk._pad8(27)), dtype=torch.bfloat16)
    denc[:, :27] = torch.randn((N, 27), generator=gen).to(torch.bfloat16)
    dims = mk._dims(weights, 10, 4)
    _, Wb, Wh, _ = mk._kernel_weights(weights, True)
    sv = plain_saves(weights, enc, denc, S, dims)
    ctx = Ctx()
    ctx.cfg = (10, 4, "softplus", False, False, False, S)
    ctx.dims = dims
    ctx.saved_tensors = (origins, rays, dirs, z, deltas, sv["enc"],
                         sv["denc"], sv["feat"], sv["hr"], sv["raw"],
                         *sv["acts"], *mk._weight_list(Wb, Wh))
    ctx.needs_input_grad = (True,) * 3 + (False,) * 3 + (True,) * 24
    cots = (torch.randn((N, 3), generator=gen),
            torch.randn((N, 1), generator=gen), None)
    return ctx, cots


def test_kernel_a_backward_nests_in_step_backward():
    """Inside a step, Kernel A's backward (``FusedMLPComposite.backward``,
    run here on CPU tensors) is the section ``step.backward.field``: its
    host span's parent is ``step.backward``, which resumes after it."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ctx, cots = _kernel_a_backward_args()
    sections = tracing.Sections("train", False, "cpu")
    with tracing.step(sections):
        tracing.section("step.loss")
        tracing.section("step.backward")
        grads = mk.FusedMLPComposite.backward(ctx, *cots)
        tracing.section("step.update")
    assert all(torch.isfinite(g).all() for g in grads[:3])
    assert sections.names == ["step.loss", "step.backward",
                              "step.backward.field", "step.backward",
                              "step.update", tracing.END]
    got = {r.name: r for r in tracing.spans()}
    assert got["step.backward.field"].parent == "step.backward"
    assert got["step.backward"].parent is None
    assert _names(tracing.spans()) == ["step.loss", "step.backward.field",
                                       "step.backward", "step.update"]
    assert (got["step.backward"].start_ns
            <= got["step.backward.field"].start_ns
            <= got["step.backward.field"].end_ns
            <= got["step.backward"].end_ns)


def test_section_outside_a_step_records_nothing():
    """Outside a step opened by ``EpochStep`` or ``PoseOptBlock`` a
    boundary records nothing: a bare ``fused_mlp_composite`` forward and
    backward (its plain version on the CPU), Kernel A's backward called
    alone, a bare ``section``."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ctx, cots = _kernel_a_backward_args()
    mk.FusedMLPComposite.backward(ctx, *cots)
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params

    o, r, d, z, deltas = ctx.saved_tensors[:5]

    nerf = init_nerf_params(torch.Generator().manual_seed(0), {
        "model": {"hidden_dim": 32, "pos_enc_levels": 10,
                  "dir_enc_levels": 4},
        "rendering": {"white_background": False}})
    weights = [w.requires_grad_() for w in mk.collect_weights(nerf)]
    rgb, dist, _ = mk.fused_mlp_composite(
        weights, o, r, d, z, deltas, 10, 4, "softplus", False, False, False,
        z.shape[1])
    (rgb.sum() + dist.sum()).backward()
    assert weights[0].grad is not None
    tracing.section("step.rays")
    assert tracing.spans() == [] and tracing.totals() == {}
    assert tracing.section_ms("train") is None


def test_profile_dir_trace_holds_the_programs_spans(tmp_path):
    """``tpu.profile_dir`` on the scan path: the run's Chrome trace holds
    the dispatch spans and the step's sections; each history entry's
    device time and sections are None on the CPU."""
    import json

    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene, tiny_config

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=8,
                           device="cpu")
    cfg = tiny_config(None, str(tmp_path / "out"), n_training_points=32,
                      num_points=8)
    cfg["model"].update(hidden_dim=16)
    cfg["training"].update(visualize_every=0, vis_reprojection_every=0,
                           auto_scheduler=False)
    cfg["tpu"].update(epoch_scan=True, profile_dir=str(tmp_path / "prof"))
    *_, history = train(cfg, max_epochs=2, scene=scene, device="cpu")
    assert len(history) == 2
    assert all(h["device_ms_per_step"] is None and h["sections_ms"] is None
               for h in history)
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"dispatch", "dispatch.upload", "dispatch.scalars",
            "dispatch.snapshot", *TRAIN_SECTIONS} <= names


def test_device_timer_reads_none_off_cuda():
    timer = tracing.DeviceTimer(torch.device("cpu"))
    timer.stop()
    assert timer.done() and timer.seconds() is None
    assert timer.seconds(wait=False) is None


# ---------------------------------------------------------------------------
# The benchmark's readers of the program's tracing
# ---------------------------------------------------------------------------

SECTION_METRICS = {"rays": "step.rays", "field": "step.field",
                   "pair": "step.pair", "loss": "step.loss",
                   "backward": "step.backward",
                   "field_bwd": "step.backward.field",
                   "update": "step.update", "aux": "step.aux"}
METRICS = ([f"step_{k}_ms.train" for k in SECTION_METRICS]
           + [f"step_{k}_ms.pose_opt" for k in SECTION_METRICS
              if k != "pair"]
           + [f"{m}.{p}" for m in ("device_ms_per_step", "replay_host_ms")
              for p in ("train", "pose_opt")])


def _read(name, t):
    from benchmark.harness import read_metric

    return read_metric(name, t)


class _Timer:
    def __init__(self, seconds):
        self.value = seconds

    def seconds(self, wait=True):
        return self.value


def _planted(monkeypatch, phase):
    """A process whose tracing recorded, for ``phase``: a last replay's
    sections and three dispatches (the first a warm-up)."""
    sections = {name: 0.1 * (i + 1)
                for i, name in enumerate(SECTION_METRICS.values())}
    d = []
    for number, (steps, ms, fastest, idle) in enumerate(
            [(48, 480.0, 0.5e6, True), (48, 192.0, 1.0e6, True),
             (24, 120.0, 0.75e6, True), (48, 190.0, 3.9e6, False)]):
        rec = tracing.Dispatch(number + 1, phase, steps,
                               _Timer(ms / 1e3), idle)
        rec.host = {"dispatch": 60 * fastest,
                    "dispatch.replay": steps * fastest}
        rec.replay_min_ns = fastest
        d.append(rec)
    other = tracing.Dispatch(9, "other", 1, _Timer(1.0))
    monkeypatch.setattr(tracing, "section_ms",
                        lambda p, eager=False, wait=True:
                        dict(sections) if p == phase else None)
    monkeypatch.setattr(tracing, "dispatches",
                        lambda p=None: [x for x in d + [other]
                                        if p is None or x.phase == p])
    return sections


@pytest.mark.parametrize("name", METRICS)
def test_program_trace_metrics_read_none_without_a_record(name):
    """Each new metric reads None when the program recorded nothing, and
    in a run of another phase."""
    phase = name.split(".")[-1]
    assert _read(name, {"phase": phase}) is None
    assert _read(name, {"phase": "render"}) is None
    assert _read(name, {}) is None


@pytest.mark.parametrize("name", METRICS)
def test_program_trace_metrics_on_a_planted_record(name, monkeypatch):
    """On planted records: a section metric is that section's ms of the
    last replay; ``device_ms_per_step`` the median over the phase's
    dispatches of device ms over steps (10, 4, 5, 3.96 -> 4.5);
    ``replay_host_ms`` the median over the dispatches begun on an idle
    device of their fastest replay's host ms (0.5, 1.0, 0.75 -> 0.75, the
    busy one's 3.9 left out); none reads another phase's record or
    runs."""
    base, phase = name.rsplit(".", 1)
    sections = _planted(monkeypatch, phase)
    if base.startswith("step_"):
        key = SECTION_METRICS[base[len("step_"):-len("_ms")]]
        want = sections[key]
    else:
        want = {"device_ms_per_step": 4.5, "replay_host_ms": 0.75}[base]
    assert _read(name, {"phase": phase}) == pytest.approx(want)
    other = "train" if phase == "pose_opt" else "pose_opt"
    assert _read(name, {"phase": other}) is None
