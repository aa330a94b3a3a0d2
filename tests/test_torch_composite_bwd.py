"""Kernel A's compositing backward and encoding backward on the CPU.

The kernels (csrc/mlp_composite.cu: ``composite_bwd_group`` and
``encode_bwd_staged``, launched by ``mlp_kernel.composite_bwd`` /
``encode_bwd``) run only on the card (tests/test_torch_cuda.py holds them
to these plain versions). Here their plain
versions, ``composite_bwd_reference`` and ``encode_bwd_reference``, are held
on seeded numpy inputs (16 rays x 16 and x 12 samples, every compositing
flag combination a config can ask for) against

* the JAX package's compositing: ``jax.vjp`` of ``ops/rendering.py``'s
  ``composite`` and ``dist_to_alpha`` after the Pallas kernel's ``_act_fwd``;
* the Pallas kernel's own backward helpers called on CPU arrays:
  ``_composite_bwd`` + ``_act_bwd`` with the constants of
  ``_composite_consts``, and ``_encode_fwd`` / ``_encode_bwd`` with the
  kernel's ray sums;
* torch autograd through the plain Kernel A's compositing and encodings
  (``mlp_kernel._composite_reference``, ``_encodings_reference``);

and the wrappers' CPU branch is held to the plain versions.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_RAYS = 16
# (act, occ_alpha, dist_alpha, white_bg): the renderer passes occ_alpha =
# not dist_alpha (ops/rendering.py), so these are every combination
FLAGS = [(act, not dist, dist, white)
         for act, dist, white in itertools.product(("softplus", "relu"),
                                                   (False, True),
                                                   (False, True))]
CASES = [(S, *f) for S in (16, 12) for f in FLAGS]


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _composite_inputs(S, seed):
    """numpy f32: raw (M, 4), z and deltas (N, S) (the last delta 1e10, as
    dist_to_alpha takes it), cotangents of rgb_values, dist and alpha."""
    rng = np.random.default_rng(seed)
    N = N_RAYS
    f = np.float32
    raw = rng.normal(size=(N * S, 4)).astype(f)
    z = np.sort(rng.uniform(0.5, 4.0, size=(N, S)), axis=1).astype(f)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)],
                            1).astype(f)
    cots = (rng.normal(size=(N, 3)).astype(f), rng.normal(size=(N, 1)).astype(f),
            rng.normal(size=(N, S)).astype(f))
    return raw, z, deltas, cots


def _port_composite_bwd(raw, z, deltas, cots, act, occ, dist, white):
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    t = torch.from_numpy
    return mk.composite_bwd_reference(
        t(raw), t(z), t(deltas), *(t(c) for c in cots),
        (act == "softplus", occ, dist, white))


@pytest.mark.parametrize("S,act,occ,dist,white", CASES)
def test_composite_bwd_reference_vs_jax_vjp(S, act, occ, dist, white):
    """Against jax.vjp of the JAX package's head activations
    (mlp_kernel._act_fwd), dist_to_alpha and composite: relL2 < 1e-5 on
    g_raw (f32 orders: jnp.cumprod's gradient against the sequential
    products and suffix sums)."""
    from nope_nerf_tpu.ops import rendering as jr
    from nope_nerf_tpu.ops.pallas import mlp_kernel as jm

    raw, z, deltas, cots = _composite_inputs(S, 1)
    N = N_RAYS

    def f(r):
        rgb, d = jm._act_fwd(r[:, :1], r[:, 1:], act, occ)
        d2 = d.reshape(N, S)
        alpha = jr.dist_to_alpha(d2, jnp.asarray(z)) if dist else d2
        rgbv, depth, _ = jr.composite(rgb.reshape(N, S, 3), alpha,
                                      jnp.asarray(z), white)
        return rgbv, depth[:, None], alpha

    _, vjp = jax.vjp(f, jnp.asarray(raw))
    want = np.asarray(vjp(tuple(jnp.asarray(c) for c in cots))[0])
    got = _port_composite_bwd(raw, z, deltas, cots, act, occ, dist, white)
    assert got.shape == (N * S, 4) and torch.isfinite(got).all()
    assert _rel_l2(got, want) < 1e-5, _rel_l2(got, want)


@pytest.mark.parametrize("S,act,occ,dist,white", CASES)
def test_composite_bwd_reference_vs_pallas_helpers(S, act, occ, dist, white):
    """Against the Pallas kernel's in-kernel backward (_composite_fwd's
    recompute, _composite_bwd, _act_bwd) on CPU arrays, one block of all
    the rays with _composite_consts' selectors: relL2 < 1e-4 (its
    transmittance is a log-space cumprod and its suffix sums bf16 hi/lo
    selector dots, exact to ~2^-18 of each term)."""
    from nope_nerf_tpu.ops.pallas import mlp_kernel as jm

    raw, z, deltas, cots = _composite_inputs(S, 2)
    mask, U, L = (jnp.asarray(c) for c in jm._composite_consts(N_RAYS, S))
    rs, rr = jnp.asarray(raw[:, :1]), jnp.asarray(raw[:, 1:])
    rgb, d = jm._act_fwd(rs, rr, act, occ)
    zj, dj = jnp.asarray(z), jnp.asarray(deltas)
    _, _, alpha, w, trans, sig2d = jm._composite_fwd(
        rgb, d, zj, dj, mask, U, S, dist, white, heads=False)
    g_rgb, g_sig = jm._composite_bwd(
        *(jnp.asarray(c) for c in cots), rgb, zj, dj, alpha, w, trans, sig2d,
        mask, L, S, dist, white)
    g_rgb, g_sig = jm._act_bwd(rs, rr, g_rgb, g_sig, act, occ)
    want = np.concatenate([np.asarray(g_sig), np.asarray(g_rgb)], 1)
    got = _port_composite_bwd(raw, z, deltas, cots, act, occ, dist, white)
    assert _rel_l2(got, want) < 1e-4, _rel_l2(got, want)


@pytest.mark.parametrize("S,act,occ,dist,white", CASES)
def test_composite_bwd_reference_vs_autograd(S, act, occ, dist, white):
    """Against torch autograd through the plain Kernel A's head activations
    and compositing (mlp_kernel._composite_reference): relL2 < 1e-5."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    raw, z, deltas, cots = _composite_inputs(S, 3)
    r = torch.from_numpy(raw).requires_grad_()
    outs = mk._composite_reference(r[:, :1], r[:, 1:], torch.from_numpy(z),
                                   torch.from_numpy(deltas), act, occ, dist,
                                   white)
    want, = torch.autograd.grad(outs, r, [torch.from_numpy(c) for c in cots])
    got = _port_composite_bwd(raw, z, deltas, cots, act, occ, dist, white)
    assert _rel_l2(got, want) < 1e-5, _rel_l2(got, want)


ENC_CASES = [(16, 10, 4), (12, 10, 4), (40, 10, 4), (16, 4, 6)]


def _encode_inputs(S, l_pos, l_dir, seed):
    """numpy f32: origins, rays, dirs (N, 3), z (N, S), the position
    encoding's cotangent as two summands (M, n_pos) and the direction
    encoding's per point (M, n_dir)."""
    rng = np.random.default_rng(seed)
    N, M = N_RAYS, N_RAYS * S
    f = np.float32
    n_pos, n_dir = 3 * (2 * l_pos + 1), 3 * (2 * l_dir + 1)
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    geo = (np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3)).astype(f),
           rays.astype(f), (-rays).astype(f))
    z = np.sort(rng.uniform(0.5, 4.0, size=(N, S)), axis=1).astype(f)
    cots = tuple(rng.normal(size=(M, k)).astype(f) * 1e-3
                 for k in (n_pos, n_pos, n_dir))
    return geo, z, cots


def _port_encode_bwd(geo, z, cots, l_pos, l_dir, fn=None):
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    t = torch.from_numpy
    fn = mk.encode_bwd_reference if fn is None else fn
    return fn(*(t(np.ascontiguousarray(g)) for g in geo), t(z),
              *(t(c) for c in cots), l_pos, l_dir)


@pytest.mark.parametrize("S,l_pos,l_dir", ENC_CASES)
def test_encode_bwd_reference_vs_pallas_helpers(S, l_pos, l_dir):
    """Against the Pallas kernel's encoding backward (_encode_fwd's sin and
    cos, _encode_bwd on ge1 + ge2, its ray sums of l.764 and l.786-792, the
    direction cotangent summed per ray first) on CPU arrays: relL2 < 1e-5
    on d_origins, d_rays and d_dirs (its 2^l x is a split bf16 selector
    dot and its sin / cos XLA's, each within ~1 ulp; its ray sums a tree
    in another order)."""
    from nope_nerf_tpu.ops.pallas import mlp_kernel as jm

    geo, z, (ge1, ge2, gd) = _encode_inputs(S, l_pos, l_dir, 4)
    o, r, dirs = (jnp.asarray(g) for g in geo)
    z_flat = jnp.asarray(z).reshape(-1, 1)
    pts = jm._expand_rays(o, S) + jm._expand_rays(r, S) * z_flat
    _, sin_p, cos_p = jm._encode_fwd(pts, l_pos)
    d_pts = jm._encode_bwd(jnp.asarray(ge1) + jnp.asarray(ge2), sin_p,
                           cos_p, l_pos, 3)
    _, sin_d, cos_d = jm._encode_fwd(dirs, l_dir)
    want = (jm._ray_sum(d_pts, S), jm._ray_sum(d_pts * z_flat, S),
            jm._encode_bwd(jm._ray_sum(jnp.asarray(gd), S), sin_d, cos_d,
                           l_dir, 3))
    got = _port_encode_bwd(geo, z, (ge1, ge2, gd), l_pos, l_dir)
    for name, a, b in zip(("d_origins", "d_rays", "d_dirs"), got, want):
        assert a.shape == (N_RAYS, 3) and torch.isfinite(a).all()
        assert _rel_l2(a, np.asarray(b)) < 1e-5, (name, _rel_l2(a, b))


@pytest.mark.parametrize("S,l_pos,l_dir", ENC_CASES)
def test_encode_bwd_reference_vs_autograd(S, l_pos, l_dir):
    """Against torch autograd through the plain Kernel A's encodings
    (mlp_kernel._encodings_reference: the points o + r z, the direction
    encoding repeated per sample): relL2 < 1e-5."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    geo, z, (ge1, ge2, gd) = _encode_inputs(S, l_pos, l_dir, 5)
    x = [torch.from_numpy(np.ascontiguousarray(g)).requires_grad_()
         for g in geo]
    enc, denc = mk._encodings_reference(*x, torch.from_numpy(z), l_pos,
                                        l_dir)
    want = torch.autograd.grad(
        (enc, denc), x, (torch.from_numpy(ge1 + ge2), torch.from_numpy(gd)))
    got = _port_encode_bwd(geo, z, (ge1, ge2, gd), l_pos, l_dir)
    for name, a, b in zip(("d_origins", "d_rays", "d_dirs"), got, want):
        assert _rel_l2(a, b) < 1e-5, (name, _rel_l2(a, b))


def test_lane_sums_follow_the_warp():
    """mlp_kernel._lane_sums adds a ray's samples as a warp does: lane l
    sums samples l, l + 32, ... in order, then warp_sum's butterfly; on
    integers (exact in f32) it is the plain sum, and on values whose f32
    sum depends on the order it equals that order replayed in float32."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(6)
    ints = torch.from_numpy(rng.integers(-50, 50, size=(3, 77, 2))
                            .astype(np.float32))
    assert torch.equal(mk._lane_sums(ints), ints.sum(1))
    x = rng.normal(size=(2, 70, 1)).astype(np.float32) * np.float32(1e3)
    lanes = np.zeros((2, 32, 1), np.float32)
    for s in range(70):
        lanes[:, s % 32] = lanes[:, s % 32] + x[:, s]
    for off in (16, 8, 4, 2, 1):
        lanes = np.stack([lanes[:, i] + lanes[:, i ^ off] for i in range(32)],
                         1)
    assert torch.equal(mk._lane_sums(torch.from_numpy(x)),
                       torch.from_numpy(lanes[:, 0]))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """composite_bwd and encode_bwd on CPU tensors return their plain
    versions' values and count no launch."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    raw, z, deltas, cots = _composite_inputs(16, 7)
    flags = ("softplus", True, False, False)
    counters = (mk.COMPOSITE_BWD_LAUNCHES, mk.ENCODE_BWD_LAUNCHES)
    before = [c.count for c in counters]
    t = torch.from_numpy
    got = mk.composite_bwd(t(raw), t(z), t(deltas), *(t(c) for c in cots),
                           (True, True, False, False))
    assert torch.equal(got, _port_composite_bwd(raw, z, deltas, cots, *flags))
    geo, z2, ecots = _encode_inputs(16, 10, 4, 8)
    for a, b in zip(_port_encode_bwd(geo, z2, ecots, 10, 4, mk.encode_bwd),
                    _port_encode_bwd(geo, z2, ecots, 10, 4)):
        assert torch.equal(a, b)
    assert [c.count for c in counters] == before
