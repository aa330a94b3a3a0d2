"""The Python side of the fused forward of Kernels A and C
(csrc/mlp_fused_fwd.cu): its tensor-map arguments, the route chosen by the
samples per ray and by ``save``, the tensors a saving forward allocates
against those the backward reads, what the wrapper refuses, and the plain
version it is held to against the JAX Pallas kernel in interpret mode. The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mlp_saves import plain_saves

torch.set_num_threads(1)

BF = torch.bfloat16


def _weights(D, l_pos=10, l_dir=4, seed=0):
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": D, "pos_enc_levels": l_pos,
                     "dir_enc_levels": l_dir},
           "rendering": {"white_background": False}}
    return mk.collect_weights(init_nerf_params(
        torch.Generator().manual_seed(seed), cfg, "cpu"))


@pytest.mark.parametrize("points", [False, True])
def test_fused_fwd_maps_arguments(points):
    """The 12 weight k-tile maps in ring order (true widths 63 and 27 of the
    encodings' halves with the padded row strides, box rows D, or D / 2 for
    rgb_layer's two) and the 12 save maps (box rows 64; the encodings at
    their true widths; Kernel A's per-ray direction encoding has no map)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    D, M = 256, 300
    ws = _weights(D)
    Wt = mk._kernel_weights(ws, False)[0]
    dims = mk._dims(ws, 10, 4)
    saves = mk.fused_fwd_saves(M, M if points else M // 6, dims, "cpu")
    maps = mk.fused_fwd_maps(Wt, dims, saves, points)
    assert len(maps) == len(mk.FUSED_WEIGHT_MAPS) + mk.FUSED_SAVE_MAPS == 24
    ptr = {n: Wt[n].data_ptr() for n in Wt}
    want_w = [(ptr["trunk0_0"], 63, 256, 128, 64, 256)]
    want_w += [(ptr[f"trunk0_{i}"], 256, 256, 512, 64, 256) for i in (1, 2, 3)]
    want_w += [(ptr["trunk1_0"], 256, 256, 640, 64, 256),
               (ptr["trunk1_0"] + 512, 63, 256, 640, 64, 256)]
    want_w += [(ptr[f"trunk1_{i}"], 256, 256, 512, 64, 256) for i in (1, 2, 3)]
    want_w += [(ptr["fc_feature"], 256, 256, 512, 64, 256),
               (ptr["rgb_layer"] + 512, 27, 128, 576, 64, 128),
               (ptr["rgb_layer"], 256, 128, 576, 64, 128)]
    assert maps[:12] == want_w
    want_s = [(a.data_ptr(), 256, M, 512, 64, 64) for a in saves["acts"]]
    want_s += [(saves["feat"].data_ptr(), 256, M, 512, 64, 64),
               (saves["hr"].data_ptr(), 128, M, 256, 64, 64),
               (saves["enc"].data_ptr(), 63, M, 128, 64, 64)]
    want_s.append((saves["denc"].data_ptr(), 27, M, 64, 64, 64) if points
                  else (None, 0, 0, 0, 0, 0))
    assert maps[12:] == want_s
    assert mk.fused_fwd_maps(Wt, dims, None, points)[12:] == [
        (None, 0, 0, 0, 0, 0)] * 12
    # other encoding levels: widths 27 and 15 within the one k-tile
    ws = _weights(64, 4, 2)
    Wt, dims = mk._kernel_weights(ws, False)[0], mk._dims(ws, 4, 2)
    maps = mk.fused_fwd_maps(Wt, dims, None, True)
    assert maps[0][1:] == (27, 64, 64, 64, 64)
    assert maps[5][1:] == (27, 64, 192, 64, 64)
    assert maps[10][1:] == (15, 32, 160, 64, 32)


def test_fused_route_by_samples():
    """The fused compositing wherever a 128-point tile holds whole rays;
    the raw route (composite_fwd after the kernel) for any other S."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    assert [mk.fused_route(S) for S in (1, 16, 32, 64, 128)] == ["fused"] * 5
    assert [mk.fused_route(S) for S in (3, 48, 96, 100, 192, 256)] == [
        "raw"] * 6


def _record_launches(monkeypatch):
    """Replace the fused launch and the C entries by recorders."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    calls = []

    def fused(Wt, Wh, Bs, dims, mode, levels, S, inputs, outs, flags,
              saves=None, raw=None):
        calls.append(("fused", dict(mode=mode, S=S, outs=outs, saves=saves,
                                    raw=raw, flags=tuple(flags))))

    def entry(name, signature):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(mk, "fused_fwd", fused)
    monkeypatch.setattr(mk, "c_function", entry)
    monkeypatch.setattr(mk, "_stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("S,save", [(128, False), (128, True), (64, True),
                                    (96, False), (96, True)])
def test_kernel_a_forward_route(monkeypatch, S, save):
    """Kernel A's forward: one fused launch, composite_fwd after it only on
    the raw route; raw written when saving or on the raw route; the saved
    tensors are the fused launch's saves; one forward counted."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    calls = _record_launches(monkeypatch)
    N = 5
    ws = _weights(64)
    geo = [torch.zeros((N, 3)) for _ in range(3)]
    z, deltas = torch.zeros((N, S)), torch.zeros((N, S))
    cfg = (10, 4, "softplus", True, False, False, S)
    f0 = mk.FWD_LAUNCHES.count
    outs, dims, saved = mk._composite_fwd(*geo, z, deltas, cfg, ws, save)
    raw_route = S == 96
    assert [c[0] for c in calls] == (
        ["fused", "nnt_composite_fwd"] if raw_route else ["fused"])
    got = calls[0][1]
    assert got["mode"] == (mk.MODE_RAW if raw_route else mk.MODE_COMPOSITE)
    assert got["flags"] == (True, True, False, False)
    if raw_route:
        assert got["outs"] == (None, None, None)
        assert calls[1][1][0] == got["raw"].data_ptr()
    else:
        assert all(a is b for a, b in zip(got["outs"], outs))
    assert (got["raw"] is not None) == (save or raw_route)
    assert (got["saves"] is not None) == save == (saved is not None)
    if save:
        sv = got["saves"]
        assert got["raw"] is sv["raw"]
        assert saved[5:18] == (sv["enc"], sv["denc"], sv["feat"], sv["hr"],
                               sv["raw"], *sv["acts"])
        assert sv["denc"].shape == (N, 32) and sv["enc"].shape == (N * S, 64)
    assert mk.FWD_LAUNCHES.count == f0 + 1


@pytest.mark.parametrize("save", [False, True])
def test_kernel_c_forward_route(monkeypatch, save):
    """Kernel C's forward: one fused launch of the point mode, raw and the
    saves only with ``save``, its direction encoding per point."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    calls = _record_launches(monkeypatch)
    M = 70
    ws = _weights(128)
    c0 = mk.FWD_POINT_LAUNCHES.count
    outs, dims, saved = mk._point_fwd(torch.zeros((M, 3)), torch.zeros((M, 3)),
                                      (10, 4, "relu", False), ws, save)
    assert [c[0] for c in calls] == ["fused"]
    got = calls[0][1]
    assert got["mode"] == mk.MODE_POINTS and got["S"] == 1
    assert got["flags"] == (False, False, False, False)
    assert got["outs"][:2] == outs and got["outs"][2] is None
    assert (got["raw"] is not None) == save == (saved is not None)
    if save:
        sv = got["saves"]
        assert saved[2:15] == (sv["enc"], sv["denc"], sv["feat"], sv["hr"],
                               sv["raw"], *sv["acts"])
        assert sv["denc"].shape == (M, 32) and sv["hr"].shape == (M, 64)
    assert mk.FWD_POINT_LAUNCHES.count == c0 + 1


def test_saves_are_what_the_backward_reads():
    """The tensors a saving fused forward allocates have the shapes, dtypes
    and row strides _chain_bwd reads (the encodings padded to 8 columns,
    the activations dense, raw f32), and _chain_bwd reading them (filled
    with the plain chain's values) gives the gradients it gives on the
    plain chain's own tensors, bit for bit."""
    from nope_nerf_tpu_torch.ops.encoding import encode_position
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(0)
    N, S, D = 6, 16, 64
    M = N * S
    ws = _weights(D)
    dims = mk._dims(ws, 10, 4)
    n_pos, n_dir = dims[:2]
    _, Wb, Wh, _ = mk._kernel_weights(ws, True)
    pts = torch.tensor(rng.normal(size=(M, 3)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(N, 3)), dtype=torch.float32)
    enc = torch.zeros((M, mk._pad8(n_pos)), dtype=BF)
    enc[:, :n_pos] = encode_position(pts, 10).to(BF)
    denc = torch.zeros((N, mk._pad8(n_dir)), dtype=BF)
    denc[:, :n_dir] = encode_position(dirs, 4).to(BF)
    sv = plain_saves(ws, enc, denc, S, dims)
    layout = {"enc": ((M, 64), BF), "denc": ((N, 32), BF),
              "feat": ((M, D), BF), "hr": ((M, D // 2), BF),
              "raw": ((M, 4), torch.float32)}
    layout.update({i: ((M, D), BF) for i in range(8)})
    for key, (shape, dtype) in layout.items():
        a = sv["acts"][key] if isinstance(key, int) else sv[key]
        assert (a.shape, a.dtype, a.is_contiguous()) == (shape, dtype, True)
    *chain, _, _ = mk._chain_reference(
        mk._weights_dict(ws), enc[:, :n_pos].float(),
        denc[:, :n_dir].float().repeat_interleave(S, 0))
    acts = [a.to(BF) for a in chain[0]]
    feat, hr = chain[1].to(BF), chain[2].to(BF)
    g_raw = torch.tensor(rng.normal(size=(M, 4)), dtype=torch.float32)
    got = mk._chain_bwd(Wb, Wh, g_raw, sv["enc"], sv["denc"], S, sv["feat"],
                        sv["hr"], sv["acts"], M, dims)
    want = mk._chain_bwd(Wb, Wh, g_raw, enc, denc, S, feat, hr, acts, M,
                         dims)
    flat = lambda r: [*r[0], *r[1], r[2]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)


def test_fused_fwd_rejects_what_it_cannot_take():
    """Hidden widths other than 64, 128 and 256 (or an rgb width other than
    D / 2), encodings past one 64-column k-tile, Kernel A's fused
    compositing at an S that does not tile 128 points, and inputs that are
    not contiguous f32 raise before anything is launched."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    def args(D, l_pos=10, mode=None, S=1, x=None):
        ws = _weights(D, l_pos)
        Wt, _, Wh, Bs = mk._kernel_weights(ws, False)
        x = torch.zeros((8, 3)) if x is None else x
        return (Wt, Wh, Bs, mk._dims(ws, l_pos, 4),
                mk.MODE_POINTS if mode is None else mode, (l_pos, 4), S,
                (x, None, torch.zeros((8, 3)), None, None),
                (torch.zeros((8, 3)), torch.zeros((8, 1)), None),
                (1, 1, 0, 0))

    with pytest.raises(ValueError, match="hidden width 96"):
        mk.fused_fwd(*args(96))
    with pytest.raises(ValueError, match="encodings 69"):
        mk.fused_fwd(*args(64, l_pos=11))
    with pytest.raises(ValueError, match="raw route"):
        mk.fused_fwd(*args(64, mode=mk.MODE_COMPOSITE, S=96))
    with pytest.raises(ValueError, match="contiguous f32"):
        mk.fused_fwd(*args(64, x=torch.zeros((8, 3), dtype=torch.float64)))
    with pytest.raises(ValueError, match="contiguous f32"):
        mk.fused_fwd(*args(64, x=torch.zeros((3, 8)).t()))
    with pytest.raises(ValueError, match="write raw"):
        mk.fused_fwd(*args(64)[:10], saves={})


@pytest.mark.parametrize("mode,points,S", [("A", 37 * 128, 128),
                                            ("A", 5 * 64, 64),
                                            ("C", 300, 1)])
def test_fused_fwd_counts_its_tiles(monkeypatch, mode, points, S):
    """One launch of the fused forward adds its 128-point tiles (a partial
    last one included) to the tracing counter ``mlp.fused_fwd_tiles`` and
    one launch to MLP_FUSED_FWD_LAUNCHES (the C entry replaced by a
    recorder: the kernel runs only on the card)."""
    from nope_nerf_tpu_torch import tracing
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    launched = []
    monkeypatch.setattr(mk, "c_function",
                        lambda name, sig: lambda *a: launched.append(name)
                        or 0)
    monkeypatch.setattr(mk, "_stream", lambda t: 0)
    ws = _weights(64)
    Wt, _, Wh, Bs = mk._kernel_weights(ws, False)
    dims = mk._dims(ws, 10, 4)
    if mode == "A":
        N = points // S
        inputs = (torch.zeros((N, 3)), torch.zeros((N, 3)),
                  torch.zeros((N, 3)), torch.zeros((N, S)),
                  torch.zeros((N, S)))
        outs = (torch.zeros((N, 3)), torch.zeros((N, 1)), torch.zeros((N, S)))
        kind = mk.MODE_COMPOSITE
    else:
        inputs = (torch.zeros((points, 3)), None, torch.zeros((points, 3)),
                  None, None)
        outs = (torch.zeros((points, 3)), torch.zeros((points, 1)), None)
        kind = mk.MODE_POINTS
    tiles0 = tracing.counters().get("mlp.fused_fwd_tiles", 0)
    n0 = mk.MLP_FUSED_FWD_LAUNCHES.count
    mk.fused_fwd(Wt, Wh, Bs, dims, kind, (10, 4), S, inputs, outs,
                 (1, 1, 0, 0))
    assert launched == ["nnt_mlp_fused_fwd"]
    assert mk.MLP_FUSED_FWD_LAUNCHES.count == n0 + 1
    assert (tracing.counters()["mlp.fused_fwd_tiles"] - tiles0
            == -(-points // 128))


@pytest.mark.parametrize("S,levels", [(64, (10, 4)), (48, (4, 2))])
def test_composite_plain_version_vs_pallas_at_other_shapes(S, levels):
    """Kernel A's plain version (what the fused forward is held to on the
    card) against the JAX Pallas kernel in interpret mode at the recovery
    scripts' 64 samples and at an S off the 128-point tile (the raw route)
    with utils/synthetic's encoding levels: forward outputs at
    tests/test_torch_render.py's bars (rgb atol 0.03, dist 0.03 x the far
    plane 4, alpha rtol 0.08 / atol 0.05)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": 32, "pos_enc_levels": levels[0],
                     "dir_enc_levels": levels[1]},
           "rendering": {"white_background": False}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(4), cfg))
    port_w = mk.collect_weights(params_from_jax({"nerf": tree})["nerf"])
    rng = np.random.default_rng(6)
    N = 16  # a whole block of the Pallas kernel's rays at these S
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    o = np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3))
    z = np.sort(rng.uniform(0.1, 4.0, size=(N, S)), axis=1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)
    static = (*levels, "softplus", True, False, False, S)
    f32 = [np.asarray(a, np.float32) for a in (o, rays, -rays, z, deltas)]
    jmk.INTERPRET = True
    try:
        jout = jmk.fused_mlp_composite(
            jmk.collect_weights(jax.tree.map(jnp.asarray, tree)),
            *(jnp.asarray(a) for a in f32), *static)
    finally:
        jmk.INTERPRET = False
    out = mk.fused_mlp_composite(port_w, *(torch.tensor(a) for a in f32),
                                 *static)
    np.testing.assert_allclose(out[0].numpy(), jout[0], atol=0.03)
    np.testing.assert_allclose(out[1].numpy(), jout[1], atol=0.03 * 4.0)
    np.testing.assert_allclose(out[2].numpy(), jout[2], rtol=0.08, atol=0.05)
