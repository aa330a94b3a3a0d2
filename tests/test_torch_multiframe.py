"""Several frames per step (``tpu.rays_per_step_multiplier`` k) in the port's
loop: the frames it hands the step against the JAX loop's, and the port
twins of tests/test_round2.py::test_rays_per_step_multiplier_convergence and
tests/test_round4.py::TestThroughputMultiplier at their bars."""
import random as pyrandom

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_FRAMES, H, W = 5, 8, 10


class _Scene:
    """A random 5-frame scene whose reference draws read ``rng``, so the
    loop's pyrng draws sit between its permutation and its extra frames."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.N_imgs = N_FRAMES
        self.K = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                           [0, 0, 0, 1]], np.float32)
        self.scale_mat = np.eye(4, dtype=np.float32)
        self.c2ws = None
        self.imgs = rng.uniform(size=(N_FRAMES, H, W, 3)).astype(np.float32)
        self.dpt_depth = 1.0 + rng.uniform(size=(N_FRAMES, H, W)).astype(
            np.float32)

    def sample_ref_idx(self, i, rng=None):
        return (rng or pyrandom).choice([j for j in range(N_FRAMES)
                                         if j != i])


def _recorded_frames(loop_mod, cfg, monkeypatch, **train_kw):
    """Run ``loop_mod.train`` for 3 epochs with a step that only records
    the frames and the reference frame it is given."""
    seen = []
    aux = {"loss": 0.5, "l2_mean": 0.1, "loss_pc": 0.0, "loss_rgb_s": 0.0,
           "scale": 1.0, "shift": 0.0}

    def make_train_step(*args, **kwargs):
        def step(state, batch, *rest):
            seen.append((np.ravel(np.asarray(batch["idx"])).tolist(),
                         int(batch["ref_idx"])))
            return state, dict(aux)
        return step

    monkeypatch.setattr(loop_mod, "make_train_step", make_train_step)
    loop_mod.train(cfg, max_epochs=3, scene=_Scene(), **train_kw)
    return seen


@pytest.mark.parametrize("k", [1, 3])
def test_loop_draws_the_jax_loops_frames(k, tmp_path, monkeypatch):
    """Same seed, same frames: the port's loop gives the step the k frame
    indices (and the reference frame) of each step that the JAX loop's
    step-by-step path (``tpu.epoch_scan: False``) gives its step, over 3
    epochs: the permutation, the reference draws, then the extra frames."""
    from nope_nerf_tpu.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu.training import loop as jloop
    from nope_nerf_tpu_torch.training import loop as ploop

    def cfg(out):
        c = load_config(DEFAULT_CONFIG)
        c["model"]["hidden_dim"] = 16
        c["training"].update(out_dir=str(tmp_path / out), seed=7,
                             print_every=0, checkpoint_every=0,
                             backup_every=0, visualize_every=0,
                             vis_reprojection_every=0, eval_pose_every=0)
        c["tpu"].update(rays_per_step_multiplier=k, epoch_scan=False)
        return c

    want = _recorded_frames(jloop, cfg("jax"), monkeypatch)
    got = _recorded_frames(ploop, cfg("port"), monkeypatch, device="cpu")
    assert len(got) == 3 * N_FRAMES and all(len(f) == k for f, _ in got)
    assert got == want
    # frame 0 walks a permutation of the views in every epoch
    for e in range(3):
        epoch = got[e * N_FRAMES:(e + 1) * N_FRAMES]
        assert sorted(f[0] for f, _ in epoch) == list(range(N_FRAMES))


@pytest.fixture(scope="module")
def jax_teacher():
    """The teacher field of the JAX test's 4-frame 16x20 scene."""
    from nope_nerf_tpu.utils.synthetic import SyntheticScene

    return jax.device_get(SyntheticScene(n_frames=4, hw=(16, 20),
                                         num_points=16).teacher)


def _synthetic_cfg(tmp_path, k, teacher):
    """The JAX test's scene (its teacher through the port's renderer) and
    tiny config at k frames per step."""
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene, tiny_config

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16,
                           teacher=teacher, device="cpu")
    cfg = tiny_config(scene, str(tmp_path / "out"), num_points=16,
                      n_training_points=64)
    cfg["tpu"]["rays_per_step_multiplier"] = k
    return scene, cfg


@pytest.mark.parametrize("k", [2, 4])
def test_rays_per_step_multiplier_convergence(k, tmp_path, jax_teacher):
    """The port twin of the JAX test on its scene: 14 epochs of 4 steps of
    k frames each (the permutation as frame 0, k - 1 uniform extra frames,
    each frame paired with the next), losses finite and the last epoch's
    mean below 0.6 x the first's. The bar reads the first epoch's loss as
    much as training: the loss falls to ~0.55 of it by epoch 5 and climbs
    back as the poses drift."""
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_render_cfg,
                                                      make_train_step)

    scene, cfg = _synthetic_cfg(tmp_path, k, jax_teacher)
    cfg["_num_cams"] = n = scene.N_imgs
    params, init_c2w = build_params(cfg, scene,
                                    torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(params)
    batch0 = scene_batch_arrays(scene, cfg, "cpu")
    weights = {"rgb_weight": 1.0, "depth_weight": 0.04, "pc_weight": 1.0,
               "rgb_s_weight": 1.0, "depth_consistency_weight": 0.0,
               "weight_dist_1st_loss": 0.0, "weight_dist_2nd_loss": 0.0}
    scalars = {"weights": weights, "w_l1": 1.0, "w_l2": 0.0,
               "lrs": {g: 1e-3 for g in ("nerf", "pose", "focal",
                                         "distortion")}}
    static = {"render_model": True, "use_ref": True, "use_rgb_s": True}
    step = make_train_step(cfg, make_render_cfg(cfg, "cpu"), init_c2w)
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(14):
        order = rng.permutation(n)
        extra = rng.integers(0, n, size=(n, k - 1))
        idxs = np.concatenate([order[:, None], extra], axis=1)
        step_losses = []
        for frames, i in zip(idxs, order):
            batch = dict(batch0, idx=frames.tolist(), ref_idx=int((i + 1) % n))
            _, aux = step(state, batch, scalars, static, gen)
            step_losses.append(float(aux["loss"]))
        losses.append(float(np.mean(step_losses)))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.6 * losses[0], losses


def test_rays_per_step_counts_k_batches(tmp_path, jax_teacher):
    """The port twin of TestThroughputMultiplier: with k = 4 the loop's
    rays/s counts 4 x n_training_points rays per step, as the bench entry
    does (steps * n * k / dt)."""
    from nope_nerf_tpu_torch.training.loop import train

    scene, cfg = _synthetic_cfg(tmp_path, 4, jax_teacher)
    cfg["training"].update(scheduling_start=0, annealing_epochs=0,
                           auto_scheduler=False)
    _, _, _, hist = train(cfg, max_epochs=1, scene=scene, device="cpu")
    (rec,) = hist
    rays_per_step = rec["rays_per_sec"] * rec["ms_per_step"] / 1e3
    assert rays_per_step == pytest.approx(64 * 4, rel=1e-9)
    assert np.isfinite(rec["step_losses"]).all()
