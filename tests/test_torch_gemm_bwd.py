"""The Python side of the backward's kernels -- the fused layer pass
(csrc/mlp_fused_bwd.cu: ``gemm_dwgrad``, each layer's input and weight
gradient in one pass, with ``heads_bwd_fused`` and the split reduction;
Kernel A's per-ray ``dir_weight_grad``) -- and of the chain backward that
runs on them: their tensor-map arguments and split rules, the plain
versions against the JAX kernels' ``_mm_t`` / ``_mm_acc`` and JAX autograd,
the wrappers' CPU paths, and ``_chain_bwd`` run whole on CPU tensors (every
step's plain version: buffer widths, f32 tails, bias sums) on the plain
chain's saves (tests/_mlp_saves.py) against autograd through the plain
chain and against the JAX Pallas backwards in interpret mode; and the
input-only backward (csrc/mlp_input_bwd.cu: ``bwd_route``, ``input_bwd``'s
plain version bit for bit the ten-pass input-only chain, its launch
arguments, what it refuses, its tile counter). The kernels themselves run
only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mlp_saves import plain_saves

torch.set_num_threads(1)

BF = torch.bfloat16
F32 = torch.float32


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nan_padded(rng, rows, k, scale=1.0):
    """bf16 (rows, k) normal values in a buffer padded to 8 columns of NaN;
    returns the buffer (its first k columns are the values)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    buf = torch.full((rows, mk._pad8(k)), float("nan"), dtype=BF)
    buf[:, :k] = torch.tensor(rng.normal(size=(rows, k)) * scale, dtype=F32)
    return buf


def test_tma_2d_arguments_of_the_fused_backward():
    """The fused pass's launch arguments: the cotangent and the groups'
    inputs as boxes of 128 rows, the weight rows as 64-row boxes of the
    untransposed bf16 weight (true width fan_out), the outputs as 64-row
    boxes (f32 for an encoding's), absent maps empty; the partials' and the
    rank-1 term's pointers; the ints (N, M, splits, tiles per split, gsig's
    row stride, the dW partial's rows, then per group its width, f32
    output, mask, weight gradient)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(1)
    D, M = 256, 300
    w10 = mk._padded(torch.zeros((D + 63, D)))
    g = torch.zeros((M, D), dtype=BF)
    a03 = _nan_padded(rng, M, D)[:, :D]
    enc = _nan_padded(rng, M, 63)[:, :63]
    out0 = torch.empty((M, D), dtype=BF)
    out1 = torch.empty((M, 64), dtype=F32)[:, :63]
    dw = torch.empty((D + 63, D))
    groups = [mk.DwGroup(w10[:D], out0, x=a03, mask=True,
                         colsum=torch.empty(D), dw=dw[:D]),
              mk.DwGroup(w10[D:D + 63], out1, x=enc, dw=dw[D:])]
    split = mk.dwgrad_split(M, 5, 132)
    parts = {"dw": torch.empty((split[1], D + 63, D)),
             "colsum": torch.empty((split[1], D))}
    maps, ptrs, ints = mk.dwgrad_args(g, groups, split, parts)
    want = [(D, M, 512, 64, 128), (D, M, 512, 64, 128), (63, M, 128, 64, 128),
            (D, D, 512, 64, 64), (D, 63, 512, 64, 64), (D, M, 512, 64, 64),
            (63, M, 256, 32, 64)]
    assert [m[1:] for m in maps] == want
    assert maps[4][0] == w10.data_ptr() + D * 512
    assert maps[2][0] == enc.data_ptr()
    assert ptrs[0] is parts["dw"] and ptrs[1] is parts["colsum"]
    assert ptrs[2:] == [None, None, None]
    assert ints == [D, M, split[1], split[0], 0, D + 63,
                    D, 0, 1, 1, 63, 1, 0, 1]
    # the input-only fc_feature pass: no partials, the rank-1 term's gsig
    # as a column of g_raw (row stride 4), no second group
    g_raw = torch.zeros((M, 4))
    wd = torch.zeros(D, dtype=BF)
    maps, ptrs, ints = mk.dwgrad_args(
        g, [mk.DwGroup(w10[:D], out0, x=a03, mask=True)], (3, 1), None,
        gsig=g_raw[:, 0], wd=wd)
    assert maps[2] == maps[4] == maps[6] == mk._NO_MAP
    assert ptrs[:3] == [None, None, None] and ptrs[4] is wd
    assert ptrs[3].data_ptr() == g_raw.data_ptr() and ptrs[3].stride() == (4,)
    assert ints == [D, M, 1, 3, 4, D, D, 0, 1, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("M", [200, 131072, 524288])
def test_dwgrad_split(M):
    """About one block per SM of an H100 (132) over the (splits x slices)
    grid, whole 128-row tiles per split, every split non-empty, the splits
    covering M."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    tiles = -(-M // mk.FUSED_BWD_TILE)
    for slices in (1, 2, 4, 5):
        per, splits = mk.dwgrad_split(M, slices, 132)
        assert splits * slices <= 132 and splits <= tiles
        assert splits * per >= tiles > (splits - 1) * per
    assert mk.dwgrad_split(131072, 4, 132) == (32, 32)
    assert mk.dwgrad_split(131072, 5, 132) == (40, 26)


def test_fused_backward_wrappers_cpu_path_is_the_plain_version():
    """gemm_dwgrad, heads_bwd_fused and dir_weight_grad on CPU tensors fill
    their outputs with the plain versions' values (the input gradient
    rounded to the output's type, the column sums taken before the
    rounding, the weight gradients of the groups that ask for one,
    fc_density's from the rank-1 term, the per-ray direction weight
    gradient equal to the per-point one up to f32 order) and launch
    nothing; the split sums of a CPU backward are empty; any other device
    raises."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(6)
    M, D = 96, 32
    g = _nan_padded(rng, M, D)[:, :D]
    act = _nan_padded(rng, M, D)[:, :D]
    enc = _nan_padded(rng, M, 27)[:, :27]
    w = mk._padded(torch.tensor(rng.normal(size=(D + 27, D)) * 0.2,
                                dtype=F32))
    g_raw = torch.tensor(rng.normal(size=(M, 4)), dtype=F32)
    wd = torch.tensor(rng.normal(size=(D,)), dtype=F32).to(BF)
    counters = (mk.MLP_FUSED_BWD_LAUNCHES, mk.WGRAD_LAUNCHES)
    n0 = [c.count for c in counters]
    out0, out1 = torch.empty((M, D), dtype=BF), torch.empty((M, 27))
    colsum, dw, dwd = torch.empty(D), torch.empty((D + 27, D)), torch.empty(
        (D, 1))
    sums = mk.SplitSums()
    mk.gemm_dwgrad(g, [mk.DwGroup(w[:D], out0, x=act, mask=True,
                                  colsum=colsum, dw=dw[:D]),
                       mk.DwGroup(w[D:], out1, x=enc, dw=dw[D:])],
                   gsig=g_raw[:, 0], wd=wd, dwd=dwd, sums=sums)
    y0, dw0 = mk.gemm_dwgrad_reference(g.float(), w[:D].float(), act.float(),
                                       act.float(), g_raw[:, 0], wd.float())
    y1, dw1 = mk.gemm_dwgrad_reference(g.float(), w[D:].float(), enc.float())
    torch.testing.assert_close(out0, y0.to(BF), rtol=0, atol=0)
    torch.testing.assert_close(colsum, y0.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(out1, y1, rtol=0, atol=0)
    torch.testing.assert_close(dw, torch.cat([dw0, dw1]), rtol=0, atol=0)
    torch.testing.assert_close(dwd, mk.gemm_wgrad_reference(
        act.float(), g_raw[:, :1]), rtol=0, atol=0)
    assert sums.entries == []

    hr = _nan_padded(rng, M, D)[:, :D]
    wc = torch.tensor(rng.normal(size=(D, 3)), dtype=F32).to(BF)
    b_rgb, dw_rgb, b_heads = torch.empty(D), torch.empty((D, 3)), torch.empty(4)
    g_hr = mk.heads_bwd_fused(g_raw, hr, wc, torch.empty((M, D), dtype=BF),
                              b_rgb, dw_rgb, b_heads, sums)
    want = mk.heads_bwd_reference(g_raw, hr.float(), wc.float())
    torch.testing.assert_close(g_hr, want.to(BF), rtol=0, atol=0)
    torch.testing.assert_close(b_rgb, want.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(dw_rgb, mk.gemm_wgrad_reference(
        hr.float(), g_raw[:, 1:]), rtol=0, atol=0)
    torch.testing.assert_close(b_heads, g_raw.sum(0), rtol=0, atol=0)
    S = 8
    denc = _nan_padded(rng, M // S, 27)[:, :27]
    out = torch.empty((27, D))
    assert mk.dir_weight_grad(denc, g, S, out) is out
    torch.testing.assert_close(out, mk.dir_weight_grad_reference(denc, g, S),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, mk.gemm_wgrad_reference(
        denc.float().repeat_interleave(S, 0), g.float()), rtol=1e-5,
        atol=1e-5)
    sums.run()  # nothing to add on the CPU: no launch
    assert [c.count for c in counters] == n0
    meta = lambda x: x.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        mk.gemm_dwgrad(meta(g), [mk.DwGroup(meta(w[:D]), meta(out0))])
    with pytest.raises(ValueError, match="unsupported device"):
        mk.heads_bwd_fused(meta(g_raw), meta(hr), meta(wc), meta(out0))
    with pytest.raises(ValueError, match="unsupported device"):
        mk.dir_weight_grad(meta(denc), meta(g), S, meta(out))


def _bf(x):
    return np.asarray(torch.tensor(np.asarray(x, np.float32)).to(BF).float())


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_gemm_references_match_jax(seed):
    """gemm_dgrad_reference against the JAX kernels' ``_mm_t`` (with the
    ReLU mask, and with fc_density's rank-1 term as the second ``_mm_t`` of
    l.310-312), gemm_wgrad_reference against ``_mm_acc``, and
    heads_bwd_reference against ``_mm_t(g_rgb, W_rgb) * mask``, on the same
    numpy inputs: bf16 operands, f32 sums in another order (rtol 1e-5)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(seed)
    M, D = 96, 64
    g = rng.normal(size=(M, D)).astype(np.float32)
    w = (rng.normal(size=(D + 27, D)) * D ** -0.5).astype(np.float32)
    act = _bf(np.maximum(rng.normal(size=(M, D + 27)), 0.0))
    gsig = rng.normal(size=(M, 1)).astype(np.float32)
    wd = rng.normal(size=(D + 27, 1)).astype(np.float32)
    wc = rng.normal(size=(D, 3)).astype(np.float32)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    mask = np.asarray(act) > 0
    close(mk.gemm_dgrad_reference(t(g), t(w)), jmk._mm_t(g, w))
    close(mk.gemm_dgrad_reference(t(g), t(w), mask=t(act)),
          jmk._mm_t(g, w) * mask)
    close(mk.gemm_dgrad_reference(t(g), t(w), mask=t(act), gsig=t(gsig[:, 0]),
                                  wd=t(wd[:, 0])),
          (jmk._mm_t(g, w) + jmk._mm_t(gsig, wd)) * mask)
    close(mk.gemm_wgrad_reference(t(act), t(g)), jmk._mm_acc(act, g))
    g_raw = np.concatenate([gsig, g_rgb], 1)
    close(mk.heads_bwd_reference(t(g_raw), t(act[:, :D]), t(wc)),
          jmk._mm_t(g_rgb, wc) * mask[:, :D])

    # the fused pass's plain version: exactly gemm_dgrad_reference and
    # gemm_wgrad_reference, and both halves against the JAX kernels' matmuls
    # and against JAX autograd of the layer x @ w (bf16-rounded operands,
    # f32: the VJP's cotangents are g @ w^T and x^T @ g)
    y, dw = mk.gemm_dwgrad_reference(t(g), t(w), t(act), mask=t(act),
                                     gsig=t(gsig[:, 0]), wd=t(wd[:, 0]))
    torch.testing.assert_close(y, mk.gemm_dgrad_reference(
        t(g), t(w), t(act), t(gsig[:, 0]), t(wd[:, 0])), rtol=0, atol=0)
    torch.testing.assert_close(dw, mk.gemm_wgrad_reference(t(act), t(g)),
                               rtol=0, atol=0)
    close(y, (jmk._mm_t(g, w) + jmk._mm_t(gsig, wd)) * mask)
    close(dw, jmk._mm_acc(act, g))
    _, vjp = jax.vjp(lambda x_, w_: x_ @ w_, jnp.asarray(act),
                     jnp.asarray(_bf(w)))
    d_act, d_wt = vjp(jnp.asarray(_bf(g)))
    y2, dw2 = mk.gemm_dwgrad_reference(t(g), t(w), t(act))
    close(y2, d_act)
    close(dw2, d_wt)
    assert mk.gemm_dwgrad_reference(t(g), t(w))[1] is None


def _chain_inputs(hidden, M, div, seed):
    """Random field weights (the port's init), NaN-padded bf16 encodings
    (per point, the direction one per ``div`` points) and the plain chain's
    forward on CPU tensors: (weights, enc, denc, the saves the backward
    reads (:func:`plain_saves`), dims, the kernel weights)."""
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": hidden, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    rng = np.random.default_rng(seed)
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg)
    weights = mk.collect_weights(params)
    enc = _nan_padded(rng, M, 63)
    denc = _nan_padded(rng, M // div, 27)
    dims = mk._dims(weights, 10, 4)
    _, Wb, Wh, _ = mk._kernel_weights(weights, True)
    sv = plain_saves(weights, enc, denc, div, dims)
    return weights, enc, denc, sv, dims, (Wb, Wh), rng


@pytest.mark.parametrize("hidden,M,div", [(32, 296, 8), (64, 296, 1),
                                          (64, 296, 8), (64, 200, 8),
                                          (32, 200, 1), (128, 300, 1),
                                          (128, 300, 4)])
def test_chain_bwd_matches_autograd(hidden, M, div):
    """_chain_bwd on CPU tensors (ragged M) against autograd through the
    plain chain on the same forward: every weight and bias gradient and the
    two encodings' cotangents to relL2 1e-5 (the same bf16 roundings; only
    the f32 order of the bias sums and of the per-ray direction weight
    gradient differs). The forward's raw heads are the plain chain's."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    weights, enc, denc, sv, dims, (Wb, Wh), rng = _chain_inputs(
        hidden, M, div, hidden + M + div)
    g_raw = torch.tensor(rng.normal(size=(M, 4)) / M, dtype=F32)
    d_w, (ge1, ge2), gd = mk._chain_bwd(Wb, Wh, g_raw, sv["enc"], sv["denc"],
                                        div, sv["feat"], sv["hr"], sv["acts"],
                                        M, dims)
    assert ge1.dtype == F32 and ge1.shape == (M, 63) and gd.shape == (M, 27)

    ws = [w.detach().clone().requires_grad_() for w in weights]
    enc_in = enc[:, :63].float().requires_grad_()
    denc_in = denc[:, :27].float().repeat_interleave(div, 0).requires_grad_()
    *_, rs, rr = mk._chain_reference(mk._weights_dict(ws), enc_in, denc_in)
    torch.testing.assert_close(sv["raw"], torch.cat([rs, rr], 1).detach(),
                               rtol=1e-6, atol=1e-6)
    torch.autograd.backward([rs, rr], [g_raw[:, :1], g_raw[:, 1:]])
    names = [f"{n}/{k}" for n in mk.W_NAMES for k in "wb"]
    for name, got, w in zip(names, d_w, ws):
        assert got.shape == w.shape, name
        assert _rel_l2(got, w.grad) <= 1e-5, (name, _rel_l2(got, w.grad))
    assert _rel_l2(ge1 + ge2, enc_in.grad) <= 1e-5
    assert _rel_l2(gd, denc_in.grad) <= 1e-5


def test_chain_bwd_input_only_is_bitwise():
    """Without the weight gradients the chain runs the same passes with
    their weight-gradient half off: the encodings' cotangents are bitwise
    those of the full backward, and no weight gradient is returned."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    M, div = 160, 8
    _, _, _, sv, dims, (Wb, Wh), rng = _chain_inputs(32, M, div, 5)
    enc, denc, acts, feat, hr = (sv[k] for k in ("enc", "denc", "acts",
                                                 "feat", "hr"))
    g_raw = torch.tensor(rng.normal(size=(M, 4)) / M, dtype=F32)
    full = mk._chain_bwd(Wb, Wh, g_raw, enc, denc, div, feat, hr, acts, M,
                         dims)
    inputs_only = mk._chain_bwd(Wb, Wh, g_raw, enc, denc, div, feat, hr,
                                acts, M, dims, weight_grads=False)
    assert all(x is None for x in inputs_only[0])
    for a, b in zip((*inputs_only[1], inputs_only[2]), (*full[1], full[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D,weight_grads,route", [
    (256, False, "input"), (128, False, "input"), (64, False, "input"),
    (256, True, "passes"), (128, True, "passes"), (64, True, "passes"),
    (32, False, "passes"), (512, False, "passes")])
def test_bwd_route(D, weight_grads, route):
    """The chain's backward takes the input-only launch when no weight
    needs a gradient at a width the fused forward (and the kernel) is built
    for, the ten fused passes otherwise."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    assert mk.bwd_route(D, weight_grads) == route


@pytest.mark.parametrize("hidden,M,div", [(32, 296, 8), (64, 200, 1),
                                          (64, 1030, 1), (128, 300, 4),
                                          (256, 260, 130)])
def test_input_bwd_cpu_path_is_the_input_only_chain(hidden, M, div):
    """input_bwd on CPU tensors runs its plain version, bit for bit
    ``_chain_bwd(..., weight_grads=False)`` on the same saves (ragged M
    included), launches nothing; _mlp_bwd takes the input-only route
    without weight gradients at the kernel's widths and the passes with
    them."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    _, _, _, sv, dims, (Wb, Wh), rng = _chain_inputs(hidden, M, div,
                                                     hidden + M)
    enc, denc, acts, feat, hr = (sv[k] for k in ("enc", "denc", "acts",
                                                 "feat", "hr"))
    g_raw = torch.tensor(rng.normal(size=(M, 4)) / M, dtype=F32)
    counters = (mk.MLP_INPUT_BWD_LAUNCHES, mk.MLP_FUSED_BWD_LAUNCHES)
    n0 = [c.count for c in counters]
    (g1, g2), g3 = mk.input_bwd(Wb, Wh, g_raw, hr, acts, dims)
    assert [c.count for c in counters] == n0
    _, (p1, p2), p3 = mk._chain_bwd(Wb, Wh, g_raw, enc, denc, div, feat, hr,
                                    acts, M, dims, weight_grads=False)
    assert g1.shape == (M, 63) and g3.shape == (M, 27)
    for a, b in zip((g1, g2, g3), (p1, p2, p3)):
        assert a.dtype == F32 and torch.equal(a, b)
    routed = mk._mlp_bwd(Wb, Wh, g_raw, enc, denc, div, feat, hr, acts, M,
                         dims, False)
    assert all(x is None for x in routed[0])
    for a, b in zip((*routed[1], routed[2]), (p1, p2, p3)):
        assert torch.equal(a, b)
    full = mk._mlp_bwd(Wb, Wh, g_raw, enc, denc, div, feat, hr, acts, M,
                       dims, True)
    assert all(x is not None for x in full[0])
    for a, b in zip((*full[1], full[2]), (p1, p2, p3)):
        assert torch.equal(a, b)


def _input_bwd_operands(D=256, M=300):
    """Zero operands of the input-only backward at width D on CPU tensors in
    the layouts the saving forward and _kernel_weights give them: (Wb, Wh,
    g_raw, hr, acts, dims, outs)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    n_pos, n_dir, H2 = 63, 27, D // 2
    shapes = {"rgb_layer": (D + n_dir, H2), "fc_feature": (D, D),
              "trunk1_0": (D + n_pos, D), "trunk0_0": (n_pos, D)}
    Wb = {n: mk._padded(torch.zeros(shapes.get(n, (D, D))))
          for n in mk.GEMM_LAYERS}
    Wh = {"fc_density": torch.zeros((D, 1), dtype=BF),
          "fc_rgb": torch.zeros((H2, 3), dtype=BF)}
    sv = mk.fused_fwd_saves(M, M, (n_pos, n_dir, D, H2), "cpu")
    outs = [torch.zeros((M, mk._pad8(n)))[:, :n] for n in (n_pos, n_pos, n_dir)]
    return (Wb, Wh, torch.zeros((M, 4)), sv["hr"], sv["acts"],
            (n_pos, n_dir, D, H2), outs)


def test_input_bwd_launch_arguments():
    """The input-only backward's launch arguments: the weights' K-major rows
    in the ring's order (box rows D, or 64 for an encoding's rows: rgb_layer's
    direction rows, trunk1_0's skip rows, trunk0_0), the 8 trunk outputs and
    hr as 64-row boxes, g_raw as 64 rows of one 16-byte box; wd, wc and the
    three outputs; D, M, the encodings' widths and the outputs' row
    strides."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    Wb, Wh, g_raw, hr, acts, dims, outs = _input_bwd_operands(256, 300)
    maps, ptrs, ints = mk.input_bwd_args(Wb, Wh, g_raw, hr, acts, dims, outs)
    assert len(maps) == 22 and len(ptrs) == 5
    assert ints == (256, 300, 63, 27, 32, 64, 64)
    want_w = [(128, 27, 64), (128, 256, 256), *[(256, 256, 256)] * 4,
              (256, 63, 64), *[(256, 256, 256)] * 4, (256, 63, 64)]
    for m, (width, rows, box) in zip(maps[:12], want_w):
        assert (m[1], m[2], m[4], m[5]) == (width, rows, 64, box)
    assert maps[0][0] == Wb["rgb_layer"][256].data_ptr()
    assert maps[6][0] == Wb["trunk1_0"][256].data_ptr()
    assert maps[1][3] == mk._pad8(128) * 2 and maps[2][3] == 512
    for m, x in zip(maps[12:21], (*acts, hr)):
        assert m == (x.data_ptr(), x.shape[1], 300, x.stride(0) * 2, 64, 64)
    assert maps[21] == (g_raw.data_ptr(), 4, 300, 16, 4, 64)
    assert ptrs == (Wh["fc_density"], Wh["fc_rgb"], outs[2], outs[0],
                    outs[1])


def _break(ops, fault):
    """The operands of :func:`_input_bwd_operands` with one fault."""
    Wb, Wh, g_raw, hr, acts, dims, outs = ops
    if fault == "g_raw dtype":
        g_raw = g_raw.double()
    elif fault == "g_raw shape":
        g_raw = torch.zeros((g_raw.shape[0], 3))
    elif fault == "act dtype":
        acts = [acts[0].float(), *acts[1:]]
    elif fault == "act rows":
        acts = [a[:-1] for a in acts]
    elif fault == "seven acts":
        acts = acts[:7]
    elif fault == "hr width":
        hr = torch.zeros((hr.shape[0], hr.shape[1] + 8), dtype=BF)
    elif fault == "weight dtype":
        Wb = dict(Wb, trunk0_2=Wb["trunk0_2"].float())
    elif fault == "weight shape":
        Wb = dict(Wb, trunk0_0=Wb["trunk0_0"][:32])
    elif fault == "head weight":
        Wh = dict(Wh, fc_rgb=Wh["fc_rgb"].float())
    elif fault == "width 32":
        dims = (dims[0], dims[1], 32, 16)
    elif fault == "rgb width":
        dims = (dims[0], dims[1], dims[2], dims[2])
    elif fault == "encoding 75":
        dims = (75, dims[1], dims[2], dims[3])
    elif fault == "output dtype":
        outs = [outs[0].to(BF), *outs[1:]]
    elif fault == "output stride":
        outs = [*outs[:2], torch.zeros((outs[2].shape[0], 27))]
    return Wb, Wh, g_raw, hr, acts, dims, outs


@pytest.mark.parametrize("fault", [
    "g_raw dtype", "g_raw shape", "act dtype", "act rows", "seven acts",
    "hr width", "weight dtype", "weight shape", "head weight", "width 32",
    "rgb width", "encoding 75", "output dtype", "output stride"])
def test_input_bwd_rejects_what_it_cannot_take(fault):
    """input_bwd_args raises on a wrong dtype, shape or width before any
    launch."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ops = _break(_input_bwd_operands(256, 300), fault)
    with pytest.raises(ValueError, match="input_bwd"):
        mk.input_bwd_args(*ops)


@pytest.mark.parametrize("D,M", [(256, 131072), (256, 1030), (128, 300),
                                 (64, 128)])
def test_input_bwd_counts_its_tiles(monkeypatch, D, M):
    """One launch of the input-only backward adds its 128-row tiles (a
    partial last one included) to the tracing counter
    ``mlp.input_bwd_tiles`` and one launch to MLP_INPUT_BWD_LAUNCHES (the C
    entry replaced by a recorder: the kernel runs only on the card)."""
    from nope_nerf_tpu_torch import tracing
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    launched = []
    monkeypatch.setattr(mk, "c_function",
                        lambda name, sig: lambda *a: launched.append(name)
                        or 0)
    monkeypatch.setattr(mk, "_stream", lambda t: 0)
    ops = _input_bwd_operands(D, M)
    tiles0 = tracing.counters().get("mlp.input_bwd_tiles", 0)
    n0 = mk.MLP_INPUT_BWD_LAUNCHES.count
    mk.input_bwd_launch(*ops)
    assert launched == ["nnt_mlp_input_bwd"]
    assert mk.MLP_INPUT_BWD_LAUNCHES.count == n0 + 1
    assert (tracing.counters()["mlp.input_bwd_tiles"] - tiles0
            == -(-M // 128))


@pytest.mark.parametrize("act,occ_alpha,hidden,M,S", [
    pytest.param("softplus", True, 32, 2048, 1, id="softplus-True"),
    pytest.param("relu", False, 32, 2048, 1, id="relu-False"),
    # hidden 128 on a ragged batch (not a multiple of 128; the JAX kernel
    # runs it padded to 1024 points whose cotangents are zero)
    pytest.param("softplus", True, 128, 1000, 1, id="hidden128-ragged"),
    # Kernel A: the direction encoding per ray (div = S = 24), 30 rays (720
    # points; the JAX kernel pads to its 40-ray block)
    pytest.param("softplus", True, 128, 720, 24, id="hidden128-rays"),
])
def test_chain_bwd_weight_grads_vs_pallas(act, occ_alpha, hidden, M, S):
    """_chain_bwd's 24 weight and bias gradients on CPU tensors against the
    JAX Pallas backward in interpret mode on the same numpy inputs and
    cotangents: Kernel C's (``fused_mlp``'s VJP, S = 1; g_raw from autograd
    through the plain head activations) or Kernel A's
    (``fused_mlp_composite``'s VJP under cotangents of rgb and depth; g_raw
    from autograd through the plain head activations and compositing, the
    direction encoding once per ray): the bar of
    tests/test_torch_kernels_cd.py::test_fused_mlp_reference_vs_pallas
    (relL2 0.02)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.ops.encoding import encode_position
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": hidden, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(7), cfg))
    weights = mk.collect_weights(params_from_jax({"nerf": tree})["nerf"])
    jw = jmk.collect_weights(jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(23)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    N = M // S
    d = rng.normal(size=(N, 3))
    dirs = f32(d / np.linalg.norm(d, axis=1, keepdims=True))
    if S == 1:
        pts = f32(rng.normal(size=(M, 3)))
        cots = (f32(rng.normal(size=(M, 3)) / M),
                f32(rng.normal(size=(M, 1)) / M))
        pad = -M % jmk.BM  # whole 1024-point blocks, zero cotangents

        def jloss(w):
            zp = lambda a: jnp.asarray(np.concatenate(  # noqa: E731
                [a, np.zeros((pad, a.shape[1]), np.float32)]))
            rgb, den = jmk.fused_mlp(w, zp(pts), zp(dirs), 10, 4, act,
                                     occ_alpha)
            return jnp.sum(rgb * zp(cots[0])) + jnp.sum(den * zp(cots[1]))
    else:
        o = f32(np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3)))
        rays = f32(-dirs)
        z = f32(np.sort(rng.uniform(0.1, 4.0, size=(N, S)), axis=1))
        deltas = f32(np.concatenate([np.diff(z, axis=1),
                                     np.full((N, 1), 1e10)], 1))
        pts = f32((o[:, None, :] + rays[:, None, :] * z[..., None])
                  .reshape(-1, 3))
        cots = (f32(rng.normal(size=(N, 3)) / N),
                f32(rng.normal(size=(N, 1)) / N))
        static = (10, 4, act, occ_alpha, False, False, S)
        pad = -N % jmk._rays_per_block(S)

        def jloss(w):
            zp = lambda a: jnp.asarray(np.concatenate(  # noqa: E731
                [a, np.repeat(a[-1:], pad, 0)]))
            zc = lambda a: jnp.asarray(np.concatenate(  # noqa: E731
                [a, np.zeros((pad, a.shape[1]), np.float32)]))
            rgbv, dist, _ = jmk.fused_mlp_composite(
                w, zp(o), zp(rays), zp(dirs), zp(z), zp(deltas), *static)
            return jnp.sum(rgbv * zc(cots[0])) + jnp.sum(dist * zc(cots[1]))

    jmk.INTERPRET = True
    try:
        jg = jax.grad(jloss)(jw)
    finally:
        jmk.INTERPRET = False

    def encoded(x, levels, n):
        buf = torch.full((x.shape[0], mk._pad8(n)), float("nan"), dtype=BF)
        buf[:, :n] = encode_position(torch.tensor(x), levels).to(BF)
        return buf

    enc, denc = encoded(pts, 10, 63), encoded(dirs, 4, 27)
    dims = mk._dims(weights, 10, 4)
    _, Wb, Wh, _ = mk._kernel_weights(weights, True)
    sv = plain_saves(weights, enc, denc, S, dims)
    enc, denc, acts, feat, hr, raw = (sv[k] for k in (
        "enc", "denc", "acts", "feat", "hr", "raw"))
    raw_sigma = raw[:, :1].clone().requires_grad_()
    raw_rgb = raw[:, 1:].clone().requires_grad_()
    rgb, den = mk._act_fwd(raw_sigma, raw_rgb, act, occ_alpha)
    if S == 1:
        outs = (rgb, den)
    else:  # the plain compositing of fused_mlp_composite_reference
        alpha = den.reshape(N, S)
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                         1.0 - alpha + 1e-6], 1), 1)[:, :-1]
        wts = alpha * trans
        outs = (torch.sum(wts[..., None] * rgb.reshape(N, S, 3), dim=1),
                torch.sum(wts * torch.tensor(z), dim=1, keepdim=True))
    g_sig, g_rgb = torch.autograd.grad(
        outs, (raw_sigma, raw_rgb), tuple(torch.tensor(c) for c in cots))
    g_raw = torch.cat([g_sig, g_rgb], 1)
    d_w, _, _ = mk._chain_bwd(Wb, Wh, g_raw, enc, denc, S, feat, hr, acts, M,
                              dims)
    names = [f"{n}/{k}" for n in mk.W_NAMES for k in "wb"]
    for name, got, want in zip(names, d_w, jg):
        assert got.shape == tuple(want.shape), name
        assert _rel_l2(got, want) < 0.02, (name, _rel_l2(got, want))
