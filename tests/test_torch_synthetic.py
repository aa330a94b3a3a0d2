"""The port's synthetic teacher scene, its dataset writer, its trajectory
module and its bench entry against the JAX package, and the port twins of
the JAX package's convergence tests (tests/test_training.py::
test_vanilla_nerf_converges, tests/test_regimes.py::test_llff_path_converges)
with the same PSNR bars.
"""
import contextlib
import io
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_scene():
    """The JAX package's 4-frame 16x20 teacher scene."""
    from nope_nerf_tpu.utils.synthetic import SyntheticScene

    return SyntheticScene(n_frames=4, hw=(16, 20), num_points=16, seed=0)


def test_lookat_c2w_matches_jax_exactly():
    from nope_nerf_tpu.utils.synthetic import lookat_c2w as jlookat
    from nope_nerf_tpu_torch.utils.synthetic import lookat_c2w

    rng = np.random.default_rng(0)
    for _ in range(8):
        eye, target = rng.normal(size=3) * 3, rng.normal(size=3) * 0.2
        np.testing.assert_array_equal(lookat_c2w(eye, target),
                                      jlookat(eye, target))
    np.testing.assert_array_equal(lookat_c2w([1.0, 2.0, 3.0], [0, 0, 0],
                                             up=(0.0, 0.0, 1.0)),
                                  jlookat([1.0, 2.0, 3.0], [0, 0, 0],
                                          up=(0.0, 0.0, 1.0)))


def test_synthetic_scene_matches_jax_given_teacher(jax_scene):
    """Given the JAX teacher (through ``convert.params_from_jax``), the
    port's frames and depths match the JAX scene's to 1e-5 (both plain f32
    renders); every other attribute is equal."""
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16, seed=0,
                           teacher=jax.device_get(jax_scene.teacher),
                           device="cpu")
    mine, theirs = vars(scene), vars(jax_scene)
    assert sorted(mine) == sorted(theirs)
    for key, want in theirs.items():
        got = mine[key]
        if key in ("imgs", "dpt_depth"):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)
        elif key == "teacher":
            for layer, p in want.items():
                for k, v in p.items():
                    np.testing.assert_array_equal(got[layer][k].numpy(),
                                                  np.asarray(v))
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key
    assert 0.0 <= scene.imgs.min() and scene.imgs.max() <= 1.0
    assert scene.imgs.std() > 0.01  # the teacher gives the frames structure


def test_synthetic_scene_own_teacher():
    """Without ``teacher`` the field is the port's ``init_nerf_params`` from
    a generator seeded ``seed + 100`` with trunk0_0.w x 4: the same scene
    for the same seed, another for another seed."""
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.utils.synthetic import TEACHER_CFG, SyntheticScene

    a = SyntheticScene(n_frames=3, hw=(8, 10), num_points=8, seed=2,
                       device="cpu")
    b = SyntheticScene(n_frames=3, hw=(8, 10), num_points=8, seed=2,
                       device="cpu")
    c = SyntheticScene(n_frames=3, hw=(8, 10), num_points=8, seed=3,
                       device="cpu")
    ref = init_nerf_params(torch.Generator().manual_seed(102), TEACHER_CFG)
    assert torch.equal(a.teacher["trunk0_0"]["w"], ref["trunk0_0"]["w"] * 4.0)
    assert torch.equal(a.teacher["trunk1_0"]["w"], ref["trunk1_0"]["w"])
    np.testing.assert_array_equal(a.imgs, b.imgs)
    assert np.abs(a.imgs - c.imgs).max() > 1e-3
    assert np.isfinite(a.dpt_depth).all() and a.imgs.shape == (3, 8, 10, 3)


def test_tiny_config_matches_jax(jax_scene):
    from nope_nerf_tpu.utils.synthetic import tiny_config as jtiny
    from nope_nerf_tpu_torch.utils.synthetic import tiny_config

    assert tiny_config(None, "/out", 64, 16) == jtiny(jax_scene, "/out", 64,
                                                       16)


def test_dataset_writer_matches_jax_tool(jax_scene, tmp_path):
    """``tools/make_synthetic_dataset.py`` and the port's writer on the
    same scene (the JAX teacher in the port's ``SyntheticScene``): the same
    files; PNG frames and 16-bit gt depths within +-1, the DPT depths to
    1e-5, ``poses_bounds.npy`` exactly."""
    from nope_nerf_tpu_torch.make_synthetic_dataset import write_dataset
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    argv = sys.argv
    sys.argv = ["x", str(tmp_path / "jax"), "--frames", "4", "--height", "16",
                "--width", "20", "--gt-depth"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=32, seed=0,
                           teacher=jax.device_get(jax_scene.teacher),
                           device="cpu")
    write_dataset(scene, str(tmp_path / "port"), gt_depth=True)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want and len(got) == 13
    for name in got:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".png"):
            pa = np.asarray(Image.open(a)).astype(np.int64)
            pb = np.asarray(Image.open(b)).astype(np.int64)
            assert pa.shape == pb.shape and np.abs(pa - pb).max() <= 1, name
        elif name.endswith(".npz"):
            np.testing.assert_allclose(np.load(a)["pred"], np.load(b)["pred"],
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b))


def _trajectory(rng, n):
    from scipy.spatial.transform import Rotation

    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(scale=0.2, size=(n, 3))).as_matrix()
    c2w[:, :3, 3] = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), axis=0)
    return c2w


TRAJECTORY_CALLS = {
    "interp_poses": lambda m, c, r: m.interp_poses(c, 13),
    "scipy_bspline": lambda m, c, r: np.concatenate([
        m.scipy_bspline(c[:, :3, 3], n=17, degree=3),
        m.scipy_bspline(c[:, :3, 3], n=17, degree=2, periodic=True)]),
    "interp_poses_bspline": lambda m, c, r: m.interp_poses_bspline(
        c, 11, np.arange(len(c)), 100),
    "get_poses_at_times": lambda m, c, r: m.get_poses_at_times(
        c, np.arange(len(c), dtype=float), np.linspace(0, len(c) - 1, 9)),
    "viewmatrix": lambda m, c, r: m.viewmatrix(r.normal(size=3),
                                               r.normal(size=3),
                                               r.normal(size=3)),
    "poses_avg": lambda m, c, r: m.poses_avg(np.concatenate(
        [c[:, :3, :4], np.tile([[[60.0], [80.0], [64.0]]], (len(c), 1, 1))],
        -1)),
    "render_path_spiral": lambda m, c, r: np.stack(m.render_path_spiral(
        np.concatenate([c[0, :3, :4], [[60.0], [80.0], [64.0]]], 1),
        np.array([0.0, 1.0, 0.0]), [0.3, 0.2, 0.1], 2.5, 0.1, 0.5, 2, 7)),
    "generate_spiral_nerf": lambda m, c, r: m.generate_spiral_nerf(
        c, np.array([2.0, 4.0]), 10,
        np.tile([[[60.0], [80.0], [64.0]]], (len(c), 1, 1))),
    "create_spheric_poses": lambda m, c, r: m.create_spheric_poses(2.0, 0.3,
                                                                   12),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORY_CALLS))
def test_trajectory_matches_jax(name):
    """Each public function of the port's ``geometry/trajectory.py``
    against the JAX package's on the same trajectory: 1e-6."""
    from nope_nerf_tpu.geometry import trajectory as jtraj
    from nope_nerf_tpu_torch.geometry import trajectory as ptraj

    call = TRAJECTORY_CALLS[name]
    c2ws = _trajectory(np.random.default_rng(1), 6)
    got = call(ptraj, c2ws, np.random.default_rng(2))
    want = call(jtraj, c2ws, np.random.default_rng(2))
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _psnrs(cfg):
    with open(os.path.join(cfg["training"]["out_dir"], "logs",
                           "events.jsonl")) as f:
        return [e["value"] for e in map(json.loads, f)
                if e["tag"] == "train/psnr"]


def test_vanilla_nerf_converges(tmp_path):
    """Port twin of tests/test_training.py::test_vanilla_nerf_converges:
    fixed gt poses on the teacher scene, 40 epochs; PSNR climbs by more
    than 1 dB."""
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene, tiny_config

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16,
                           device="cpu")
    cfg = tiny_config(scene, str(tmp_path / "out2"), n_training_points=128,
                      num_points=16)
    cfg["pose"].update({"learn_R": False, "learn_t": False,
                        "init_pose": True, "init_pose_type": "gt"})
    cfg["training"].update({"scheduling_start": 0, "annealing_epochs": 0,
                            "auto_scheduler": False})
    train(cfg, max_epochs=40, scene=scene, device="cpu")
    psnrs = _psnrs(cfg)
    assert len(psnrs) >= 10
    assert psnrs[-1] > psnrs[0] + 1.0, f"no convergence: {psnrs[:3]}...{psnrs[-3:]}"


def test_llff_path_converges(tmp_path):
    """Port twin of tests/test_regimes.py::test_llff_path_converges: the
    NDC + dist_alpha regime of configs/LLFF/fern.yaml fits; 30 finite PSNRs,
    the last over the first by more than 0.5 dB."""
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene, tiny_config

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16,
                           device="cpu")
    cfg = tiny_config(scene, str(tmp_path / "out"), n_training_points=128,
                      num_points=16)
    cfg["rendering"].update({"sample_option": "ndc", "dist_alpha": True,
                             "depth_range": [0.0, 1.0]})
    cfg["pose"].update({"learn_R": False, "learn_t": False,
                        "init_pose": True, "init_pose_type": "gt"})
    cfg["training"].update({"scheduling_start": 0, "annealing_epochs": 0,
                            "auto_scheduler": False})
    train(cfg, max_epochs=30, scene=scene, device="cpu")
    psnrs = _psnrs(cfg)
    assert len(psnrs) == 30
    assert all(np.isfinite(psnrs))
    assert psnrs[-1] > psnrs[0] + 0.5, (psnrs[0], psnrs[-1])


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench module at a tiny shape: 8 frames of 16x20, width 32, 8
    samples, 32 rays, 1 warm-up dispatch and 2 timed dispatches of 3
    steps."""
    from nope_nerf_tpu_torch import bench

    base = bench.bench_config

    def tiny():
        cfg = base()
        cfg["model"]["hidden_dim"] = 32
        cfg["rendering"]["num_points"] = 8
        cfg["training"]["n_training_points"] = 32
        return cfg

    monkeypatch.setattr(bench, "bench_config", tiny)
    monkeypatch.setattr(bench, "H", 16)
    monkeypatch.setattr(bench, "W", 20)
    monkeypatch.setattr(bench, "SCAN_STEPS", 3)
    monkeypatch.setattr(bench, "WARMUP_DISPATCHES", 1)
    monkeypatch.setattr(bench, "MEASURE_DISPATCHES", 2)
    return bench


def test_bench_prints_one_json_line(tiny_bench):
    """On ``--device cpu`` the measurement prints exactly one line, the JSON
    object of the repository's ``bench.py`` (same keys, same baseline)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rate = tiny_bench.run("cpu")
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "train_rays_per_sec" and rec["unit"] == "rays/s"
    assert rec["baseline"] == "estimated" and rec["device"] == "cpu"
    assert rec["value"] == round(rate, 1) > 0
    assert rec["vs_baseline"] == round(rate / 10240.0, 3)


def test_bench_refuses(tiny_bench, monkeypatch):
    """No CUDA device: ``main`` raises before starting a child (unless
    ``--device cpu``). ``rays_per_step_multiplier`` 2 runs on the CPU:
    each step takes frame i and the frame after it (``bench.py``'s (steps,
    k) layout), and rays/s is steps * n * k over the timed window."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(tiny_bench, "_supervise",
                        lambda argv: started.append(argv) or 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_bench.main([])
    assert tiny_bench.main(["--device", "cpu"]) == 0
    assert started == [["--device", "cpu"]]
    monkeypatch.setenv("BENCH_TPU_OVERRIDES",
                       json.dumps({"rays_per_step_multiplier": 2}))
    frames = []
    real_epoch = tiny_bench.make_epoch_step

    def recording_epoch(*args, **kwargs):
        epoch = real_epoch(*args, **kwargs)

        def run(state, scene_arrays, idxs, refs, *rest):
            frames.extend((list(map(int, i)), int(r))
                          for i, r in zip(idxs, refs))
            return epoch(state, scene_arrays, idxs, refs, *rest)
        return run

    clock = iter([100.0, 102.5])  # the timed window: 2.5 s
    monkeypatch.setattr(tiny_bench, "make_epoch_step", recording_epoch)
    monkeypatch.setattr(tiny_bench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    with contextlib.redirect_stdout(io.StringIO()):
        rate = tiny_bench.run("cpu")
    steps = (1 + 2) * 3
    assert frames == [([s % 8, (s + 1) % 8], (s + 1) % 8)
                      for s in range(3)] * 3 and len(frames) == steps
    assert rate == pytest.approx(2 * 3 * 32 * 2 / 2.5, rel=1e-12)
    monkeypatch.setenv("BENCH_TPU_OVERRIDES", json.dumps({"n_devices": 2}))
    with pytest.raises(NotImplementedError, match="n_devices"):
        tiny_bench.run("cpu")
