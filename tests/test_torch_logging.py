"""The port's metrics logger (``nope_nerf_tpu_torch/utils/logging.py``)
against the JAX package's (``nope_nerf_tpu/utils/logging.py``).

Both training loops run 3 epochs on the same 4-frame 16x20 teacher scene
from the same parameters (the JAX ``build_params`` draw, given to the port
through ``convert.params_from_jax``), step by step (``tpu.epoch_scan:
False``, the JAX loop's per-step path; ``tests/test_torch_scan.py`` holds
the two scan paths to each other), with every pixel as a ray
(``n_training_points`` = H x W with distinct draws, so both losses
average the same rays) and no jitter. The two ``events.jsonl``
files must hold the same tags at the same steps, the ``train/lr_*`` values
equal, and every other value but ``perf/rays_per_sec`` (a wall-clock rate)
within rtol 1e-3 / atol 1e-5: the two packages' f32 MLPs and optimisers
agree to about 1e-6 per step (``tests/test_torch_train.py``), and over the
12 steps here the values differ by 1.2e-4 relative at most (a distortion
loss of 2e-6), 4e-5 elsewhere.
"""
import collections
import json
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 16, 20
EPOCHS = 3


def _events(out_dir):
    with open(out_dir / "logs" / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def _cfg(out_dir):
    from nope_nerf_tpu.utils.synthetic import tiny_config

    cfg = tiny_config(None, str(out_dir), n_training_points=H * W,
                      num_points=8)
    cfg["model"]["hidden_dim"] = 32
    cfg["training"].update(print_every=2, eval_pose_every=1,
                           eval_img_every=1)
    cfg["tpu"].update(epoch_scan=False, fast_ray_sampling=False,
                      render_add_noise=False, use_pallas_mlp=False,
                      mlp_bf16=False)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX events, port events, port log dir) of the two short runs."""
    import nope_nerf_tpu.training.loop as jloop
    import nope_nerf_tpu_torch.training.loop as ploop
    from nope_nerf_tpu.utils.synthetic import SyntheticScene
    from nope_nerf_tpu_torch.convert import params_from_jax

    base = tmp_path_factory.mktemp("logging")
    scene = SyntheticScene(n_frames=4, hw=(H, W), num_points=16, seed=0)
    jcfg = _cfg(base / "jax")
    jcfg["_num_cams"] = scene.N_imgs
    params, init_c2w = jloop.build_params(jcfg, scene, jax.random.PRNGKey(1))
    params = jax.device_get(params)
    assert init_c2w is None  # poses from scratch

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jloop, "build_params",
                   lambda cfg, scene, key: (params, None))
        mp.setattr(ploop, "build_params",
                   lambda cfg, scene, gen, device: (
                       params_from_jax(params, device), None))
        jloop.train(_cfg(base / "jax"), max_epochs=EPOCHS, scene=scene)
        ploop.train(_cfg(base / "port"), max_epochs=EPOCHS, scene=scene,
                    device="cpu")
    finally:
        mp.undo()
    return _events(base / "jax"), _events(base / "port"), base / "port" / "logs"


def test_same_tags_at_same_steps(runs):
    """Every (tag, step) pair of the JAX log, as often, in the port's; the
    print steps carry ``perf/rays_per_sec`` and no epoch end adds one."""
    jev, pev, _ = runs
    jkeys = collections.Counter((e["tag"], e["step"]) for e in jev)
    pkeys = collections.Counter((e["tag"], e["step"]) for e in pev)
    assert pkeys == jkeys
    rate_steps = sorted(e["step"] for e in pev
                        if e["tag"] == "perf/rays_per_sec")
    assert rate_steps == list(range(0, EPOCHS * 4, 2))
    assert {"train/loss", "train/psnr", "train/lr_nerf", "eval/ate_trans",
            "train/loss_pc_epoch"} <= {t for t, _ in pkeys}


def test_values_agree(runs):
    """``train/lr_*`` equal; every other value but the rays/s within rtol
    1e-3 / atol 1e-5; the rays/s finite and positive."""
    jev, pev, _ = runs
    jval = {(e["tag"], e["step"]): e["value"] for e in jev}
    for e in pev:
        key, got = (e["tag"], e["step"]), e["value"]
        if e["tag"] == "perf/rays_per_sec":
            assert np.isfinite(got) and got > 0
        elif e["tag"].startswith("train/lr_"):
            assert got == jval[key], key
        else:
            np.testing.assert_allclose(got, jval[key], rtol=1e-3, atol=1e-5,
                                       err_msg=str(key))


def test_tensorboard_file_holds_the_same_scalars(runs):
    """With tensorboard importable the port's log directory also holds an
    event file with every scalar of ``events.jsonl`` (f32 values)."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    _, pev, log_dir = runs
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0})
    acc.Reload()
    got = {(tag, s.step): s.value for tag in acc.Tags()["scalars"]
           for s in acc.Scalars(tag)}
    want = {(e["tag"], e["step"]): e["value"] for e in pev}
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key] == np.float32(v), key


def test_jsonl_alone_without_tensorboard(tmp_path, monkeypatch):
    """With the ``SummaryWriter`` import blocked the logger writes
    ``events.jsonl`` alone; ``flush`` makes it readable before ``close``."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from nope_nerf_tpu_torch.utils.logging import MetricsLogger

    log = MetricsLogger(str(tmp_path))
    assert log.tb is None
    log.add_scalar("train/loss", np.float32(0.5), 3)
    log.add_scalar("perf/rays_per_sec", 1024.0, 4)
    log.flush()
    lines = [json.loads(x)
             for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [(e["tag"], e["value"], e["step"]) for e in lines] == [
        ("train/loss", 0.5, 3), ("perf/rays_per_sec", 1024.0, 4)]
    log.close()
    assert [p.name for p in tmp_path.iterdir()] == ["events.jsonl"]


def test_throughput_counts_rays_since_reset(monkeypatch):
    """``Throughput``: ticked steps x rays per step over the seconds since
    the last reset, as the JAX counter."""
    from nope_nerf_tpu.utils import logging as jlog
    from nope_nerf_tpu_torch.utils import logging as plog

    rates = []
    for mod in (jlog, plog):
        clock = iter([10.0, 12.0, 12.0, 13.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.Throughput(512)
        t.tick()
        t.tick(3)
        r1 = t.rate()
        t.reset()
        t.tick()
        rates.append((r1, t.rate()))
    assert rates[0] == rates[1] == (4 * 512 / 2.0, 512 / 1.0)


_FRAME_ORDER_RUN = r"""
import json
import sys

if sys.argv[1] == "tensorflow_first":
    import tensorflow  # noqa: F401
import numpy as np
import torch

torch.set_num_threads(1)
from nope_nerf_tpu_torch.training.loop import train
from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene, tiny_config

orders = []
permutation = np.random.permutation


def recorded(n):
    order = permutation(n)
    orders.append([int(i) for i in order])
    return order


np.random.permutation = recorded
scene = SyntheticScene(n_frames=4, hw=(12, 16), num_points=8, seed=0,
                       device="cpu")
cfg = tiny_config(scene, sys.argv[2], n_training_points=32, num_points=8)
cfg["model"]["hidden_dim"] = 16
cfg["training"]["seed"] = 7
_, _, _, hist = train(cfg, max_epochs=2, scene=scene, device="cpu")
print(json.dumps({"orders": orders, "losses": hist[0]["step_losses"]}))
"""


def test_frame_order_does_not_depend_on_tensorflow_import(tmp_path):
    """Two fresh processes train 2 tiny epochs on the CPU at one seed, one
    of them after ``import tensorflow``: the same frame permutations and
    the same first-epoch step losses. The loop imports tensorboard (and,
    where it is installed, TensorFlow, whose first import draws from
    ``np.random``) before it seeds ``np.random``, as the JAX package's
    process has TensorFlow loaded before its seed."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = []
    for mode in ("plain", "tensorflow_first"):
        out = subprocess.run(
            [sys.executable, "-c", _FRAME_ORDER_RUN, mode,
             str(tmp_path / mode)], capture_output=True, text=True, env=env,
            cwd=root, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert len(runs[0]["orders"]) == 2
    assert runs[0]["orders"] == runs[1]["orders"]
    assert runs[0]["losses"] == runs[1]["losses"]
