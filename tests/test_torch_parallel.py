"""Multi-GPU training of the port (``nope_nerf_tpu_torch/parallel``) on the
CPU: two ranks over gloo (``tests/_torch_parallel_workers.py`` spawns them),
each on the plain versions of the kernels, against the one-process port and
against the JAX package's mesh on 2 of the 8 virtual CPU devices that
``tests/conftest.py`` creates.

The training step runs on the fixture of ``tests/test_parallel.py`` (4
frames of 16x20, 64 rays, 16 samples, hidden 64) with every loss on,
``pc_ratio`` 1 (320-point clouds) and the pose-smoothness terms weighted
0.1. Tolerances: against the one-process port, the loss at rtol 1e-4 and
the updated parameters at atol 2e-5 (``tests/test_parallel.py``'s bars),
and the parameters bitwise equal across the ranks; against JAX, the bars
of ``tests/test_torch_train.py::test_slice_trajectory_f32`` (loss rtol
1e-4, gradients relL2 1e-4, parameters after the step within 2 lr, and
within 0.05 lr where the gradient is at least 1e-2 of its leaf's largest).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_parallel_workers as workers  # noqa: E402

KERNEL = {"use_pallas_mlp": True, "mlp_bf16": True}
# (name, tpu overrides, {"weight_decay": ..., "static": overrides}); the
# last two decay the nerf weights, on a step that renders and on one that
# does not (the pair branch alone: the nerf loss gradient is zero, and the
# decay alone moves the nerf weights, on every rank as in the JAX step)
STEP_CONFIGS = (
    ("plain", {}, {}),
    ("kernel_a", KERNEL, {}),
    ("kernel_c_exact", dict(KERNEL, fuse_compositing=False,
                            chamfer_mode="exact"), {}),
    ("weight_decay", {}, {"weight_decay": 0.1}),
    ("weight_decay_no_render", {},
     {"weight_decay": 0.1, "static": {"render_model": False}}),
)
STEP_NAMES = [c[0] for c in STEP_CONFIGS]
# the weight-decay steps again at injected ray indices and no jitter, to be
# held to the JAX ``make_train_step``
JAX_WD_CONFIGS = (
    ("weight_decay", {"weight_decay": 0.1}),
    ("weight_decay_no_render",
     {"weight_decay": 0.1, "static": {"render_model": False}}),
)
HEAD_BIAS = 400.0  # tests/test_torch_dpt.py: every pixel passes the ReLU


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _quantised(rng, n):
    """Points on a 0.25 grid, so many distances tie."""
    return (np.round(rng.uniform(-1, 1, (n, 3)) * 4) / 4).astype(np.float32)


@pytest.fixture(scope="module")
def jax_setup():
    from nope_nerf_tpu.training.loop import build_params, scene_device_arrays
    from nope_nerf_tpu.utils.synthetic import SyntheticScene, tiny_config

    f32 = np.float32
    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16)
    cfg = tiny_config(scene, "unused", n_training_points=64, num_points=16)
    cfg["training"]["pc_ratio"] = 1
    cfg["_num_cams"] = scene.N_imgs
    params, init_c2w = build_params(cfg, scene, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    # poses off the identity: with every frame at one pose the reprojection
    # samples exact pixel centres, where rgb_s's gradient is discontinuous
    params["pose"] = {"r": (rng.normal(size=(4, 3)) * 0.02).astype(f32),
                      "t": (rng.normal(size=(4, 3)) * 0.05).astype(f32)}
    params["distortion"]["shifts"] = (rng.normal(size=(4, 1)) * 0.05).astype(
        f32)
    imgs, dpts = scene_device_arrays(scene)
    ray_idx = rng.integers(0, 16 * 20, 64)
    setup = {
        "cfg": cfg, "params": jax.device_get(params),
        "init_c2w": None if init_c2w is None else np.asarray(init_c2w),
        "scene": {"imgs": np.asarray(imgs), "dpt_depth": np.asarray(dpts),
                  "K": np.asarray(scene.K),
                  "scale_mat": np.asarray(scene.scale_mat)}}
    return setup, ray_idx


@pytest.fixture(scope="module")
def dpt_files(tmp_path_factory):
    """A seeded DPT checkpoint converted to the port's npz, and a 3-frame
    scene on disk (24x400 frames, 32x384 network inputs)."""
    from test_dpt_convert import synth_state_dict

    from nope_nerf_tpu_torch.convert_dpt import convert
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    base = tmp_path_factory.mktemp("dpt")
    state = synth_state_dict(np.random.default_rng(0))
    state["scratch.output_conv.4.bias"][:] = HEAD_BIAS
    npz = str(base / "dpt.npz")
    save_pytree(npz, {"params": convert(state)})
    argv = sys.argv
    sys.argv = ["x", str(base / "scene"), "--frames", "3", "--height", "24",
                "--width", "400"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    return base, npz


def _dpt_cfg(base, npz, depth_net, n_devices):
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    p = base / f"{depth_net}.yaml"
    p.write_text(yaml.safe_dump({
        "depth": {"type": "DPT", "path": npz},
        "dataloading": {"path": str(base), "scene": ["scene"],
                        "resize_factor": None, "depth_net": depth_net},
        "training": {"mode": "all"}, "tpu": {"n_devices": n_devices}}))
    return load_config(str(p), DEFAULT_CONFIG)


RENDER_BASE = {
    "num_points": 8, "depth_range": [0.5, 4.0], "sample_option": "uniform",
    "dist_alpha": False, "use_ray_dir": True, "normalise_ray": True,
    "white_background": False, "normal_loss": False, "outside_steps": 0,
    "occ_activation": "softplus", "pos_enc_levels": 4, "dir_enc_levels": 2,
    "hidden_dim": 32, "n_max_network_queries": 2 ** 21,
}
RENDER_ROUTES = {
    "kernel_a": dict(RENDER_BASE, use_pallas_mlp=True, mlp_bf16=True,
                     fuse_compositing=True),
    "plain": dict(RENDER_BASE, use_pallas_mlp=False, mlp_bf16=False),
    # 48 rays per launch: each 64-ray chunk splits into two launch chunks
    "plain_chunked": dict(RENDER_BASE, use_pallas_mlp=False, mlp_bf16=False,
                          n_max_network_queries=24 * 8),
}


def _chamfer_clouds():
    from nope_nerf_tpu_torch.ops.kernels.chamfer_band import QB, TILE

    rng = np.random.default_rng(3)
    S, D, k = 1500, 1300, 1  # not multiples of 2 * QB: padded groups
    n_tiles = -(-D // TILE)
    return {
        "band": {"X": _quantised(rng, S), "Y": _quantised(rng, D), "k": k,
                 "sx": rng.integers(0, n_tiles - k + 1,
                                    -(-S // QB)).astype(np.int32),
                 "sy": rng.integers(0, -(-S // TILE) - k + 1,
                                    -(-D // QB)).astype(np.int32)},
        "exact": {"X": _quantised(rng, 403), "Y": _quantised(rng, 517)},
    }


@pytest.fixture(scope="module")
def train_started(tmp_path_factory):
    """The two-rank ``train()`` runs, started first so that they run beside
    the other spawn."""
    out_dir = tmp_path_factory.mktemp("train")
    return out_dir, workers.start(workers.train_runs,
                                  tmp_path_factory.mktemp("train_ranks"),
                                  str(out_dir))


@pytest.fixture(scope="module")
def ranks(train_started, jax_setup, dpt_files, tmp_path_factory):
    """One two-rank spawn: the steps, the Chamfer wrappers, render_image
    and DPT; plus the same calls in this process without a mesh, while the
    ranks run."""
    setup, ray_idx = jax_setup
    base, npz = dpt_files
    configs = [(n, t, None, o) for n, t, o in STEP_CONFIGS]
    configs.append(("jax", {"render_add_noise": False}, ray_idx, {}))
    configs += [("jax_" + n, {"render_add_noise": False}, ray_idx, o)
                for n, o in JAX_WD_CONFIGS]
    imgs = np.random.default_rng(5).uniform(-1, 1, (3, 32, 64, 3)).astype(
        np.float32)
    clouds = _chamfer_clouds()
    handle = workers.start(workers.everything,
                           tmp_path_factory.mktemp("ranks"), setup, configs,
                           clouds, RENDER_ROUTES, npz, imgs,
                           _dpt_cfg(base, npz, "dpt_two", 2))
    one = workers.everything(None, setup, configs, clouds, RENDER_ROUTES,
                             npz, imgs, _dpt_cfg(base, npz, "dpt_one", 1))
    return workers.wait(handle), one, clouds, imgs


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STEP_NAMES)
def test_sharded_step_matches_one_process(ranks, name):
    """Two ranks against one process, same draws: loss rtol 1e-4, the
    parameters of all four groups after Adam atol 2e-5."""
    out, one = ranks[0], ranks[1]
    loss1, _, p1, _ = one["steps"][name]
    for r in out:
        loss, _, p, _ = r["steps"][name]
        np.testing.assert_allclose(loss, loss1, rtol=1e-4)
        assert set(p) == set(p1)
        for k in p1:
            np.testing.assert_allclose(p[k], p1[k], atol=2e-5, err_msg=k)


@pytest.fixture(scope="module")
def one_rank_steps(ranks, jax_setup, tmp_path_factory):
    """The steps of STEP_CONFIGS under a mesh of one rank (a one-process
    gloo group, torn down after)."""
    import torch.distributed as dist

    from nope_nerf_tpu_torch.parallel.mesh import make_ray_mesh

    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        return workers.train_steps(make_ray_mesh(1, device="cpu"),
                                   jax_setup[0],
                                   [(n, t, None, o)
                                    for n, t, o in STEP_CONFIGS])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", STEP_NAMES)
def test_one_rank_mesh_step_bitwise_equal_to_unsharded(ranks, one_rank_steps,
                                                       name):
    """With one rank the sharded step is the unsharded one, bit for bit:
    loss, aux values, the gradients Adam read and the parameters after
    it."""
    loss1, aux1, p1, g1 = ranks[1]["steps"][name]
    loss, aux, p, g = one_rank_steps[name]
    assert loss == loss1 and aux == aux1
    for k in p1:
        assert np.array_equal(g[k], g1[k]), k
        assert np.array_equal(p[k], p1[k]), k


@pytest.mark.parametrize("name", STEP_NAMES + ["jax"] + [
    "jax_" + n for n, _ in JAX_WD_CONFIGS])
def test_sharded_step_params_bitwise_across_ranks(ranks, name):
    """After the gradient all-reduce and Adam every rank holds the same
    parameters, bit for bit, and read the same loss."""
    (l0, a0, p0, _), (l1, a1, p1, _) = (r["steps"][name] for r in ranks[0])
    assert l0 == l1 and a0 == a1
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k


def _jax_train_step(jax_setup, opts):
    """One JAX ``make_train_step`` at the injected ray indices, no jitter:
    (loss, the gradients Adam read (with ``wd * w`` on the nerf leaves),
    the parameters after Adam), numpy."""
    from nope_nerf_tpu.training.trainer import (compute_loss,
                                                init_train_state,
                                                make_render_cfg,
                                                make_train_step)

    setup, ray_idx = jax_setup
    wd = opts.get("weight_decay", 0.0)
    cfg = dict(setup["cfg"], tpu=dict(setup["cfg"]["tpu"],
                                      render_add_noise=False),
               training=dict(setup["cfg"]["training"], weight_decay=wd))
    static = dict(workers.STATIC, **opts.get("static", {}))
    sc = setup["scene"]
    batch = {"imgs": jnp.asarray(sc["imgs"]), "dpts": jnp.asarray(
        sc["dpt_depth"]), "idx": jnp.int32(0), "ref_idx": jnp.int32(1),
        "camera_mat_gt": jnp.asarray(sc["K"]),
        "scale_mat": jnp.asarray(sc["scale_mat"]),
        "ray_idx": jnp.asarray(ray_idx, jnp.int32)}
    f32 = np.float32
    scalars = {"weights": {k: f32(v) for k, v in
                           workers.SCALARS["weights"].items()},
               "w_l1": f32(1.0), "w_l2": f32(0.0),
               "lrs": {k: f32(v) for k, v in workers.SCALARS["lrs"].items()}}
    params = jax.tree.map(jnp.asarray, setup["params"])
    init_c2w = (None if setup["init_c2w"] is None
                else jnp.asarray(setup["init_c2w"]))
    rcfg = make_render_cfg(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: compute_loss(p, batch, scalars, jax.random.PRNGKey(0),
                               cfg=cfg, static=static, init_c2w=init_c2w,
                               render_cfg=rcfg),
        has_aux=True))(params)
    state, _ = init_train_state(params)
    js, _ = make_train_step(cfg, rcfg, init_c2w)(
        state, batch, scalars, jax.random.PRNGKey(0), static)
    w = workers._leaves(setup["params"])
    g = {k: np.asarray(v) + (wd * np.asarray(w[k]) if k.startswith("nerf/")
                             else 0.0)
         for k, v in workers._leaves(jax.device_get(jg)).items()}
    return float(jl), g, workers._leaves(jax.device_get(js.params))


def test_weight_decay_only_on_steps_that_render(ranks, jax_setup):
    """Weight decay adds 0.1 * w to the nerf gradients on every step, as
    the JAX ``make_train_step`` does: on a step that renders, and on one
    that does not, where the nerf loss gradient is zero and the nerf leaves
    move by JAX's amount (Adam's first step on 0.1 * w), on one process and
    on every rank alike. (The name is older than the repair: the port once
    decayed only on steps that render, which this test pinned.)"""
    from nope_nerf_tpu_torch.convert import params_from_jax

    p0 = {k: v.detach().numpy() for k, v in workers._leaves(
        params_from_jax(jax_setup[0]["params"])).items()
        if k.startswith("nerf/")}
    _, _, jp = _jax_train_step(jax_setup, dict(JAX_WD_CONFIGS)[
        "weight_decay_no_render"])
    moved = 0
    for steps in [ranks[1]["steps"]] + [r["steps"] for r in ranks[0]]:
        g_plain = steps["plain"][3]
        g_wd = steps["weight_decay"][3]
        _, _, p_nr, g_nr = steps["weight_decay_no_render"]
        for k, w in p0.items():
            np.testing.assert_allclose(g_wd[k] - g_plain[k], 0.1 * w,
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(g_nr[k], 0.1 * w, rtol=1e-6,
                                       atol=1e-9, err_msg=k)
            # within two f32 ulps of the weight, or 1e-8 (a
            # hundred-thousandth of the 1e-3 step) near zero: the two
            # Adams round their updates in another order
            np.testing.assert_allclose(p_nr[k], jp[k], rtol=2.4e-7,
                                       atol=1e-8, err_msg=k)
            moved += int(np.abs(p_nr[k] - w).max() > 0.5e-3)
    assert moved == 3 * len(p0)  # every leaf, by about lr = 1e-3


@pytest.mark.parametrize("name", [n for n, _ in JAX_WD_CONFIGS])
def test_weight_decay_step_matches_jax_make_train_step(jax_setup, ranks,
                                                       name):
    """One step at ``weight_decay`` 0.1, rendering and not, against the JAX
    ``make_train_step`` from the same parameters at the same injected ray
    indices: on one process and on each of the two gloo ranks, the loss at
    rtol 1e-4, the gradients Adam read (decay included) at relL2 1e-4, and
    the parameters after Adam within 2 lr, and within 0.05 lr where the
    gradient is at least 1e-2 of its leaf's largest (the bars of
    ``test_sharded_step_matches_jax_shard_train_step``)."""
    jl, jg, jp = _jax_train_step(jax_setup, dict(JAX_WD_CONFIGS)[name])
    for steps in [ranks[1]["steps"]] + [r["steps"] for r in ranks[0]]:
        loss, _, p, g = steps["jax_" + name]
        np.testing.assert_allclose(loss, jl, rtol=1e-4)
        assert set(p) == set(jp)
        for k, jv in jp.items():
            assert _rel_l2(g[k], jg[k]) < 1e-4, k
            lr = workers.SCALARS["lrs"][k.split("/")[0]]
            gk = np.abs(jg[k])
            diff = np.abs(p[k] - np.asarray(jv))
            assert (diff[gk >= 1e-2 * gk.max()] <= 0.05 * lr).all(), k
            assert (diff <= 2 * lr).all(), k


def test_sharded_step_matches_jax_shard_train_step(jax_setup, ranks):
    """The two-rank step against JAX's ``shard_train_step`` on a 2-device
    mesh, same parameters and injected ray indices, no jitter."""
    from nope_nerf_tpu.parallel.mesh import make_ray_mesh, shard_train_step
    from nope_nerf_tpu.training.trainer import (compute_loss,
                                                init_train_state,
                                                make_render_cfg)

    setup, ray_idx = jax_setup
    cfg = dict(setup["cfg"], tpu=dict(setup["cfg"]["tpu"],
                                      render_add_noise=False))
    sc = setup["scene"]
    batch = {"imgs": jnp.asarray(sc["imgs"]), "dpts": jnp.asarray(
        sc["dpt_depth"]), "idx": jnp.int32(0), "ref_idx": jnp.int32(1),
        "camera_mat_gt": jnp.asarray(sc["K"]),
        "scale_mat": jnp.asarray(sc["scale_mat"]),
        "ray_idx": jnp.asarray(ray_idx, jnp.int32)}
    f32 = np.float32
    scalars = {"weights": {k: f32(v) for k, v in
                           workers.SCALARS["weights"].items()},
               "w_l1": f32(1.0), "w_l2": f32(0.0),
               "lrs": {k: f32(v) for k, v in workers.SCALARS["lrs"].items()}}
    params = jax.tree.map(jnp.asarray, setup["params"])
    init_c2w = (None if setup["init_c2w"] is None
                else jnp.asarray(setup["init_c2w"]))
    rcfg = make_render_cfg(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: compute_loss(p, batch, scalars, jax.random.PRNGKey(0),
                               cfg=cfg, static=workers.STATIC,
                               init_c2w=init_c2w, render_cfg=rcfg),
        has_aux=True))(params)
    state, _ = init_train_state(params)
    js, _ = shard_train_step(cfg, rcfg, init_c2w, make_ray_mesh(2))(
        state, batch, scalars, jax.random.PRNGKey(0), workers.STATIC)
    jp = workers._leaves(jax.device_get(js.params))
    jgl = workers._leaves(jax.device_get(jg))
    for r in ranks[0]:
        loss, _, p, g = r["steps"]["jax"]
        np.testing.assert_allclose(loss, float(jl), rtol=1e-4)
        assert set(p) == set(jp)
        for k, jv in jp.items():
            assert _rel_l2(g[k], jgl[k]) < 1e-4, k
            lr = workers.SCALARS["lrs"][k.split("/")[0]]
            gk = np.abs(np.asarray(jgl[k]))
            diff = np.abs(p[k] - np.asarray(jv))
            assert (diff[gk >= 1e-2 * gk.max()] <= 0.05 * lr).all(), k
            assert (diff <= 2 * lr).all(), k


# ---------------------------------------------------------------------------
# the sharded Chamfer wrappers (Kernels B and D)
# ---------------------------------------------------------------------------


def _unsharded_chamfer(mode, c):
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    X = torch.tensor(c["X"], requires_grad=True)
    Y = torch.tensor(c["Y"], requires_grad=True)
    if mode == "band":
        sx, sy = torch.tensor(c["sx"]), torch.tensor(c["sy"])
        ix = cb.nearest_idx_banded_reference(X, Y, sx, c["k"])
        iy = cb.nearest_idx_banded_reference(Y, X, sy, c["k"])
        loss = cb.chamfer_loss_banded(X, Y, sx, sy, c["k"])
    else:
        ix, iy = ck.nearest_idx_exact_reference(X, Y)
        loss = ck.chamfer_loss_exact(X, Y)
    loss.backward()
    return ix.numpy(), iy.numpy(), float(loss), X.grad.numpy(), Y.grad.numpy()


@pytest.mark.parametrize("mode", ["band", "exact"])
def test_sharded_chamfer_indices_exact(ranks, mode):
    """The ranks' rows tile each cloud in order (B: whole query groups)
    and their indices are the unsharded ones exactly, on quantised clouds
    full of tied distances."""
    from nope_nerf_tpu_torch.ops.kernels.chamfer_band import QB

    out, _, clouds, _ = ranks
    ix, iy, _, _, _ = _unsharded_chamfer(mode, clouds[mode])
    for key, idx, n in (("x", ix, len(clouds[mode]["X"])),
                        ("y", iy, len(clouds[mode]["Y"]))):
        spans = [r["chamfer"][mode]["r" + key] for r in out]
        assert spans[0][0] == 0 and spans[0][1] == spans[1][0]
        assert spans[1][1] == n
        if mode == "band":
            assert spans[0][1] % QB == 0
        got = np.concatenate([r["chamfer"][mode]["i" + key] for r in out])
        assert np.array_equal(got, idx)
    assert len(np.unique(clouds[mode]["X"], axis=0)) < len(clouds[mode]["X"])


@pytest.mark.parametrize("mode", ["band", "exact"])
def test_sharded_chamfer_loss_and_grads(ranks, mode):
    """The global loss on every rank at rtol 1e-6, and the ranks' averaged
    gradients of both clouds at rtol 1e-5 of the unsharded ones."""
    out, _, clouds, _ = ranks
    _, _, loss, gx, gy = _unsharded_chamfer(mode, clouds[mode])
    for r in out:
        c = r["chamfer"][mode]
        np.testing.assert_allclose(c["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(c["gx"], gx, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(c["gy"], gy, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("mode", ["band", "exact"])
def test_sharded_chamfer_matches_jax_sharded(ranks, mode):
    """The loss against JAX's ``chamfer_loss_banded_sharded`` /
    ``chamfer_loss_pallas_sharded`` (Pallas in interpret mode) on a
    2-device mesh, rtol 1e-6."""
    from nope_nerf_tpu.ops.pallas.chamfer_band import (
        chamfer_loss_banded_sharded)
    from nope_nerf_tpu.ops.pallas.chamfer_kernel import (
        chamfer_loss_pallas_sharded)
    from nope_nerf_tpu.parallel.mesh import make_ray_mesh

    out, _, clouds, _ = ranks
    c = clouds[mode]
    mesh = make_ray_mesh(2)
    X, Y = jnp.asarray(c["X"]), jnp.asarray(c["Y"])
    if mode == "band":
        want = chamfer_loss_banded_sharded(
            X, Y, jnp.asarray(c["sx"]), jnp.asarray(c["sy"]), mesh, c["k"],
            interpret=True)
    else:
        want = chamfer_loss_pallas_sharded(X, Y, mesh, interpret=True)
    for r in out:
        np.testing.assert_allclose(r["chamfer"][mode]["loss"], float(want),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# render_image and DPT under a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(RENDER_ROUTES))
def test_render_image_mesh_matches_one_process(ranks, route):
    """``render_image(mesh=)``: every rank returns the whole image, rgb and
    depth within 1e-6 of the one-process render (Kernel A's plain version,
    the plain MLP, and the plain MLP with each rank's rays in two
    launches)."""
    out, one = ranks[0], ranks[1]
    rgb1, d1 = one["render"][route]
    assert rgb1.shape == (8, 16, 3) and np.isfinite(rgb1).all()
    for r in out:
        rgb, d = r["render"][route]
        np.testing.assert_allclose(rgb, rgb1, atol=1e-6, rtol=0)
        np.testing.assert_allclose(d, d1, atol=1e-6, rtol=0)


def test_apply_dpt_batched_mesh_matches_one_process(ranks):
    """3 frames over 2 ranks (the batch padded to 4): every rank gets the
    3 depths of the unsharded forward within 2e-6 relative (the CPU
    convolutions of a batch of 2 differ from those of a batch of 3 by up
    to 1.2e-6 relative, about 10 f32 ulps)."""
    out, one = ranks[0], ranks[1]
    want = one["dpt"][0]
    assert want.shape == (3, 32, 64) and want.min() > 0
    for r in out:
        got = r["dpt"][0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-6)


def test_dpt_depth_cli_two_ranks(ranks):
    """``dpt_depth.main`` with ``tpu.n_devices: 2``: rank 0 writes the same
    files as the one-device run, ``pred`` within 2e-6 relative and the
    PNGs within 1 level (the ranks' convolutions run on batches of 2, not
    3: see the test above)."""
    from PIL import Image

    out, one = ranks[0], ranks[1]
    one_dir, two_dir = one["dpt"][1], out[0]["dpt"][1]
    assert out[1]["dpt"][1] == two_dir
    names = sorted(os.listdir(one_dir))
    assert sorted(os.listdir(two_dir)) == names and len(names) == 6
    for n in names:
        if n.endswith(".npz"):
            want = np.load(os.path.join(one_dir, n))["pred"]
            got = np.load(os.path.join(two_dir, n))["pred"]
            assert got.shape == want.shape == (1, 32, 384)
            np.testing.assert_allclose(got, want, rtol=2e-6)
        else:
            want = np.asarray(Image.open(os.path.join(one_dir, n)))
            got = np.asarray(Image.open(os.path.join(two_dir, n)))
            assert got.shape == want.shape
            assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1


# ---------------------------------------------------------------------------
# train() on two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ranks(train_started):
    out_dir, handle = train_started
    return out_dir, workers.wait(handle)


def test_train_two_ranks_runs_and_logs_once(train_ranks):
    """3 epochs with ``tpu.n_devices: 2``, the visualisation and pair dumps
    on, step by step (``tpu.epoch_scan: False``; the resume runs the scan
    path): finite losses and PSNR; one event log, checkpoints and the
    ``rendering/`` tree, written by rank 0 alone (each event once)."""
    out_dir, out = train_ranks
    hist, _ = out[0]["vis"]
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["step_losses"]).all() and np.isfinite(h["psnr"])
               for h in hist)
    assert [h["psnr"] for h in out[1]["vis"][0]] == [h["psnr"] for h in hist]
    run = out_dir / "vis"
    events = [json.loads(line) for line in
              open(run / "logs" / "events.jsonl")]
    psnrs = [e for e in events if e["tag"] == "train/psnr"]
    assert [e["step"] for e in psnrs] == [3, 7, 11, 15]  # 3 epochs + resume
    assert any(e["tag"] == "eval/ate_trans" for e in events)
    assert (run / "model.npz").exists() and (run / "model_pose.npz").exists()
    vis = sorted(os.listdir(run / "rendering"))
    assert "0004_vis" in vis and "0008_vis" in vis
    assert any(n.endswith("_img1.png") for n in vis)


@pytest.mark.parametrize("name", ["vis", "resume", "k2"])
def test_train_two_ranks_params_equal(train_ranks, name):
    """Every run ends with the same parameters on both ranks, bit for
    bit."""
    _, out = train_ranks
    p0, p1 = out[0][name][1], out[1][name][1]
    assert set(p0) == set(p1)
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k


def test_train_two_ranks_resume_and_multiplier(train_ranks):
    """The resume continues from rank 0's checkpoints on both ranks (the
    loop's epoch counter stops at the cap, 3, so ``max_epochs`` 5 runs
    epoch 4, it 12-15), and 2 epochs at rays_per_step_multiplier 2 run."""
    _, out = train_ranks
    for r in out:
        (rec,) = r["resume"][0]
        assert rec["epoch"] == 4 and rec["it"] == 15
        assert np.isfinite(rec["step_losses"]).all()
        hist = r["k2"][0]
        assert [h["epoch"] for h in hist] == [0, 1]
        assert all(np.isfinite(h["step_losses"]).all() for h in hist)


def test_mesh_refusals(train_ranks, monkeypatch):
    """Refusals: a world size other than ``n_devices`` and a mesh whose
    size differs from ``tpu.n_devices`` raise ``ValueError`` on the ranks;
    more CUDA ranks than cards raise without ``allow_shared_device``
    (the twin of JAX's ``test_mesh_too_large_raises``)."""
    from nope_nerf_tpu_torch.parallel.mesh import make_ray_mesh

    _, out = train_ranks
    for r in out:
        assert "world size 2 != tpu.n_devices 3" in r["refusals"][
            "world_size"]
        assert "mesh of 2 ranks" in r["refusals"]["mesh_size"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="allow_shared_device"):
        make_ray_mesh(2, device="cuda")


def test_one_device_makes_no_distributed_call(tmp_path, monkeypatch):
    """``tpu.n_devices: 1`` trains without touching ``torch.distributed``:
    every collective and the group's start raise if called."""
    import torch.distributed as dist

    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import (SyntheticScene,
                                                     tiny_config)

    def refuse(*a, **k):
        raise AssertionError("torch.distributed called")

    for fn in ("init_process_group", "all_reduce", "broadcast", "barrier",
               "get_world_size", "get_rank"):
        monkeypatch.setattr(dist, fn, refuse)
    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=16,
                           device="cpu")
    cfg = tiny_config(scene, str(tmp_path), n_training_points=64,
                      num_points=16)
    cfg["tpu"]["n_devices"] = 1
    _, _, _, hist = train(cfg, max_epochs=1, scene=scene, device="cpu")
    assert np.isfinite(hist[0]["step_losses"]).all()
    assert not dist.is_initialized()
