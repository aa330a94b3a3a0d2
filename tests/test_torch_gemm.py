"""The tensor-map arguments of the fused kernels (``mlp_kernel.tma_2d``),
the plain layer ``gemm_fwd_reference`` against the layer math of the MLP
chain, and the plain chain against the JAX Pallas kernel in interpret
mode. The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BF = torch.bfloat16


def _bf16_rows(rng, rows, k, ld):
    """bf16 (rows, k) values in a (rows, ld) buffer; the padding is NaN."""
    buf = torch.full((rows, ld), float("nan"), dtype=BF)
    buf[:, :k] = torch.tensor(rng.normal(size=(rows, k)), dtype=torch.float32)
    return buf


def test_tma_2d_arguments():
    """True width with the padded row stride, box one 128-byte row wide and
    as deep as asked, for the fused kernels' operands: the position
    encoding (63 of 64), the direction encoding (27 of 32), an activation
    (256), an f32 view, and the second half of a K-major weight."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(0)
    enc = _bf16_rows(rng, 300, 63, 64)
    denc = _bf16_rows(rng, 20, 27, 32)
    act = torch.zeros((300, 256), dtype=BF)
    f32 = torch.zeros((20, 128), dtype=torch.float32)
    wt = mk._padded_t(torch.zeros((319, 256)))
    cases = [(enc[:, :63], 128, (63, 300, 128, 64, 128)),
             (denc[:, :27], 128, (27, 20, 64, 64, 128)),
             (act, 64, (256, 300, 512, 64, 64)),
             (f32, 64, (128, 20, 512, 32, 64)),
             (wt[:, 256:319], 256, (63, 256, 640, 64, 256)),
             (wt[:, :256], 256, (256, 256, 640, 64, 256))]
    for view, box_rows, want in cases:
        args = mk.tma_2d(view, box_rows)
        assert args[0] == view.data_ptr() and args[0] % 16 == 0
        assert args[1:] == want
    assert mk.tma_2d(wt[:, 256:319], 256)[0] == wt.data_ptr() + 512


def test_tma_2d_rejects_what_tma_cannot_take():
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    act = torch.zeros((64, 256), dtype=BF)
    assert act.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte"):
        mk.tma_2d(act[:, 1:], 128)           # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        mk.tma_2d(torch.zeros((64, 63), dtype=BF), 128)  # 126-byte rows
    with pytest.raises(ValueError, match="row-major"):
        mk.tma_2d(act.t(), 128)
    with pytest.raises(ValueError, match="row-major"):
        mk.tma_2d(torch.zeros((64, 256), dtype=torch.float64), 128)
    with pytest.raises(ValueError, match="row-major"):
        mk.tma_2d(torch.zeros((4, 64, 8), dtype=BF), 128)


def _layer_inputs(seed, M=96, D=32, k_enc=63, k_dir=27, S=8):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)

    bf = lambda x: x.to(BF).float()  # noqa: E731
    return dict(h=bf(t(M, D).relu()), enc=bf(t(M, k_enc)),
                denc=bf(t(M // S, k_dir)), w=t(D, D, scale=D ** -0.5),
                w_skip=t(D + k_enc, D, scale=0.1),
                w_rgb=t(D + k_dir, D // 2, scale=0.1), b=t(1, D, scale=0.1),
                b_rgb=t(1, D // 2, scale=0.1), S=S, D=D)


@pytest.mark.parametrize("seed", [0, 1])
def test_gemm_fwd_reference_is_the_chain_layer_math(seed):
    """A plain layer and the skip layer equal the chain's former layer math
    (``_bf(relu(_mm(x, w) + b))`` on the concatenation) bit for bit; the
    row-term form of rgb_layer equals the concatenated product up to f32
    summation order (within one bf16 ulp), and a per-ray row term with
    div = S equals it repeated per point with div = 1 bit for bit."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    x = _layer_inputs(seed)
    h, enc, denc, D, S = x["h"], x["enc"], x["denc"], x["D"], x["S"]
    bf, mm = mk._bf, mk._mm
    torch.testing.assert_close(
        mk.gemm_fwd_reference(h, x["w"], bias=x["b"], relu=True),
        bf(torch.relu(mm(h, x["w"]) + x["b"])), rtol=0, atol=0)
    torch.testing.assert_close(
        mk.gemm_fwd_reference(h, x["w"], bias=x["b"]),
        bf(mm(h, x["w"]) + x["b"]), rtol=0, atol=0)
    ws = x["w_skip"]
    torch.testing.assert_close(
        mk.gemm_fwd_reference(h, ws[:D], enc, ws[D:], x["b"], True),
        bf(torch.relu(mm(torch.cat([h, enc], -1), ws) + x["b"])),
        rtol=0, atol=0)
    wr = x["w_rgb"]
    per_point = denc.repeat_interleave(S, dim=0)
    got = mk.gemm_fwd_reference(h, wr[:D], bias=x["b_rgb"], relu=True,
                                rowterm=mm(denc, wr[D:]), div=S)
    want = bf(torch.relu(mm(torch.cat([h, per_point], -1), wr) + x["b_rgb"]))
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(
        want.abs(), want.abs().max() / 256))) - 7)
    assert bool(torch.all((got - want).abs() <= ulp))
    torch.testing.assert_close(
        got, mk.gemm_fwd_reference(h, wr[:D], bias=x["b_rgb"], relu=True,
                                   rowterm=mm(per_point, wr[D:])),
        rtol=0, atol=0)
    rt32 = mk.gemm_fwd_reference(denc, wr[D:], out_dtype=torch.float32)
    torch.testing.assert_close(rt32, mm(denc, wr[D:]), rtol=0, atol=0)


def test_row_term_chain_against_pallas_interpret():
    """The rebuilt plain chain (rgb_layer as feat @ W[:D] + the direction
    row term) inside Kernel A's plain version, against the JAX Pallas kernel
    in interpret mode, in the stock softplus + occupancy regime with a
    white background: the bars tests/test_torch_render.py holds the two to
    (rgb atol 0.03, dist atol 0.03 x far 4, alpha rtol 0.08 / atol 0.05;
    every gradient relL2 0.02)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": 32, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": True}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(11), cfg))
    port = params_from_jax({"nerf": tree})["nerf"]
    rng = np.random.default_rng(9)
    N, S = 64, 16  # the Pallas kernel's ray block at S = 16
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    o = np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3))
    z = np.sort(rng.uniform(0.1, 4.0, size=(N, S)), axis=1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)
    cots = [rng.normal(size=s) / N for s in ((N, 3), (N, 1), (N, S))]
    static = (10, 4, "softplus", True, False, True, S)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    def jloss(w, o_, r_, d_):
        out = jmk.fused_mlp_composite(w, o_, r_, d_, jnp.asarray(f32(z)),
                                      jnp.asarray(f32(deltas)), *static)
        return sum(jnp.sum(a * jnp.asarray(f32(c)))
                   for a, c in zip(out, cots)), out

    jmk.INTERPRET = True
    try:
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
            jmk.collect_weights(jax.tree.map(jnp.asarray, tree)),
            *(jnp.asarray(f32(a)) for a in (o, rays, -rays)))
    finally:
        jmk.INTERPRET = False
    ws = [w.detach().clone().requires_grad_()
          for w in mk.collect_weights(port)]
    ins = [torch.tensor(f32(a)).requires_grad_() for a in (o, rays, -rays)]
    out = mk.fused_mlp_composite(ws, *ins, torch.tensor(f32(z)),
                                 torch.tensor(f32(deltas)), *static)
    sum(torch.sum(a * torch.tensor(f32(c))) for a, c in zip(out, cots)
        ).backward()
    np.testing.assert_allclose(out[0].detach().numpy(), jout[0], atol=0.03)
    np.testing.assert_allclose(out[1].detach().numpy(), jout[1],
                               atol=0.03 * 4.0)
    np.testing.assert_allclose(out[2].detach().numpy(), jout[2], rtol=0.08,
                               atol=0.05)
    for g, jgr in zip([w.grad for w in ws + ins],
                      list(jg[0]) + list(jg[1:])):
        g, jgr = g.numpy().astype(np.float64), np.asarray(jgr, np.float64)
        assert np.linalg.norm(g - jgr) <= 0.02 * max(np.linalg.norm(jgr),
                                                     1e-30)
