"""Kernel A: the fused NeRF MLP + alpha compositing, forward and backward.

Port of ``nope_nerf_tpu/ops/pallas/mlp_kernel.py::fused_mlp_composite``
(Pallas kernels ``_make_fwd_composite_kernel`` l.668 and
``_make_bwd_composite_kernel`` l.702). The CUDA source is
``nope_nerf_tpu_torch/csrc/mlp_composite.cu``; its header says what bounds
the kernel on the H100 and how the design answers it.

* :func:`fused_mlp_composite` is the public wrapper. For CUDA tensors it runs
  :class:`FusedMLPComposite` (a fixed sequence of hand-written kernels
  forward, another backward) and counts the launches in
  :data:`FWD_LAUNCHES` / :data:`BWD_LAUNCHES`; for CPU tensors it runs
  :func:`fused_mlp_composite_reference`; any other device raises.
* :func:`fused_mlp_composite_reference` is the plain PyTorch version: bf16
  operands emulated as bf16-rounded f32 tensors with f32 matmuls, autograd
  for the backward (matmul cotangents rounded to bf16 as in the kernels).

Numerics (both versions): bf16 matmul operands, f32 accumulation, f32
biases, activations rounded to bf16 after the bias/ReLU epilogue, raw head
outputs in f32, stable softplus, exclusive cumprod of (1 - alpha + 1e-6).
z and deltas get no gradient (z never depends on parameters).
"""
from __future__ import annotations

import torch

from ..._build import c_function, check
from ...models.nerf import matmul_bf16
from ..encoding import encode_position
from . import LaunchCounter

# parameter layout: (name, (fan_in, fan_out)) in kernel argument order
W_NAMES = (
    "trunk0_0", "trunk0_1", "trunk0_2", "trunk0_3",
    "trunk1_0", "trunk1_1", "trunk1_2", "trunk1_3",
    "fc_density", "fc_feature", "rgb_layer", "fc_rgb",
)

FWD_LAUNCHES = LaunchCounter("mlp_composite_fwd")
BWD_LAUNCHES = LaunchCounter("mlp_composite_bwd")

_F32 = torch.float32
_BF = torch.bfloat16


def _rays_per_block(S, target=1024):
    """Ray-padding quantum of the reference package (R*S ~ target points,
    R a multiple of 8); kept so both packages pad ray batches alike."""
    return max(8, (target // S) // 8 * 8)


def collect_weights(params):
    """params dict -> flat tuple in kernel order (biases as (1, n))."""
    ws = []
    for name in W_NAMES:
        ws += [params[name]["w"], params[name]["b"].reshape(1, -1)]
    return tuple(ws)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


class _RoundBF16(torch.autograd.Function):
    """Round an activation to bf16 (kept in its dtype). The gradient passes
    through unrounded: the TPU kernel keeps cotangents in f32 and rounds
    them only where they enter a matmul (see :func:`matmul_bf16`)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(_BF).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


_bf = _RoundBF16.apply
_mm = matmul_bf16


def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _act_fwd(raw_sigma, raw_rgb, act, occ_alpha):
    d = _softplus(raw_sigma) if act == "softplus" else torch.relu(raw_sigma)
    if occ_alpha:
        d = 1.0 - torch.exp(-d)
    return torch.sigmoid(raw_rgb), d


def fused_mlp_composite_reference(weights, origins, rays, dirs, z, deltas,
                                  l_pos, l_dir, act, occ_alpha, dist_alpha,
                                  white_bg, S):
    """Plain PyTorch version of :func:`fused_mlp_composite` (same arguments
    and outputs): per-ray (N, 3) geometry and (N, S) z/deltas ->
    (rgb_values (N, 3), dist (N, 1), alpha (N, S))."""
    W = {name: (weights[2 * i], weights[2 * i + 1])
         for i, name in enumerate(W_NAMES)}
    N = origins.shape[0]
    pts = origins[:, None, :] + rays[:, None, :] * z[..., None]
    enc = _bf(encode_position(pts.reshape(-1, 3), l_pos))
    denc = _bf(encode_position(dirs, l_dir)).repeat_interleave(S, dim=0)
    h = enc
    for i in range(4):
        w, b = W[f"trunk0_{i}"]
        h = _bf(torch.relu(_mm(h, w) + b))
    h = torch.cat([h, enc], dim=-1)
    for i in range(4):
        w, b = W[f"trunk1_{i}"]
        h = _bf(torch.relu(_mm(h, w) + b))
    raw_sigma = _mm(h, W["fc_density"][0]) + W["fc_density"][1]
    feat = _bf(_mm(h, W["fc_feature"][0]) + W["fc_feature"][1])
    catr = torch.cat([feat, denc], dim=-1)
    hr = _bf(torch.relu(_mm(catr, W["rgb_layer"][0]) + W["rgb_layer"][1]))
    raw_rgb = _mm(hr, W["fc_rgb"][0]) + W["fc_rgb"][1]
    rgb, d = _act_fwd(raw_sigma, raw_rgb, act, occ_alpha)
    sig2d = d.reshape(N, S)
    if dist_alpha:
        alpha = 1.0 - torch.exp(-sig2d * deltas)
        alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], 1)
    else:
        alpha = sig2d
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-6], 1), 1
    )[:, :-1]
    w = alpha * trans
    rgbv = torch.sum(w[..., None] * rgb.reshape(N, S, 3), dim=1)
    dist = torch.sum(w * z, dim=1, keepdim=True)
    if white_bg:
        rgbv = rgbv + (1.0 - torch.sum(w, dim=1, keepdim=True))
    return rgbv, dist, alpha


# ---------------------------------------------------------------------------
# CUDA kernel path
# ---------------------------------------------------------------------------


def _ptr(t, offset=0):
    return t.data_ptr() + offset * t.element_size()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


class _Mat:
    """A row-major operand view: tensor, element offset, row stride, width."""

    def __init__(self, t, k, ld=None, offset=0, row_div=1):
        self.t, self.k, self.offset, self.row_div = t, k, offset, row_div
        self.ld = t.shape[-1] if ld is None else ld

    @property
    def ptr(self):
        return _ptr(self.t, self.offset)

    @property
    def is_f32(self):
        return int(self.t.dtype == _F32)


def _pad8(n):
    """Row strides padded to 8 elements keep every row 16-byte aligned, so
    the GEMMs read whole rows with vector loads."""
    return -(-n // 8) * 8


def _padded_t(w):
    """w^T (fan_out, fan_in) in a buffer whose row stride is padded to 8."""
    out = w.new_zeros((w.shape[1], _pad8(w.shape[0])))
    out[:, :w.shape[0]] = w.t()
    return out


def _gemm_nn(a1, b1, m, n, out, a2=None, b2=None, bias=None, relu=False,
             mask=None):
    """out (m, n) = epilogue(a1 @ b1 [+ a2 @ b2] [+ bias]); ``mask`` is a
    ``_Mat`` of a saved bf16 activation whose ReLU mask zeroes out[:, :k].
    b1 / b2 are bf16 (K, >= n) tensors, their row stride is shape[1]."""
    fn = c_function("nnt_gemm_nn", "piiipiiiipipipipiipiiiip")
    err = fn(
        a1.ptr, a1.is_f32, a1.ld, a1.k,
        a2.ptr if a2 else None, a2.is_f32 if a2 else 0, a2.ld if a2 else 0,
        a2.k if a2 else 0, a2.row_div if a2 else 1,
        _ptr(b1), b1.shape[1],
        _ptr(b2) if b2 is not None else None,
        b2.shape[1] if b2 is not None else 0,
        _ptr(bias) if bias is not None else None, int(relu),
        mask.ptr if mask else None, mask.ld if mask else 0,
        mask.k if mask else 0,
        _ptr(out), int(out.dtype == _F32), out.shape[1], m, n, _stream(out),
    )
    check(err, "gemm_nn")
    return out


def _split_rows(m, K, n, blocks=528):
    """Rows per split of a split-K weight-gradient GEMM: enough splits that
    the (K/128, n/128, splits) grid has about ``blocks`` blocks (4 per SM
    of an H100), a multiple of the 32-row GEMM step."""
    tiles = -(-K // 128) * -(-n // 128)
    splits = max(1, -(-blocks // tiles))
    return max(32, -(-m // (splits * 32)) * 32)


def _weight_grad(x1, g, m, x2=None):
    """dW = [x1 | x2]^T @ g as deterministic split-K partial sums + reduce.
    x1/x2 are bf16 ``_Mat``s, g an f32 ``_Mat``; returns f32 (K, n)."""
    K = x1.k + (x2.k if x2 else 0)
    n = g.k
    rps = _split_rows(m, K, n)
    splits = -(-m // rps)
    dev = g.t.device
    partial = torch.empty((splits, K, n), dtype=_F32, device=dev)
    err = c_function("nnt_gemm_tn", "piipiiipiiiipp")(
        x1.ptr, x1.ld, x1.k,
        x2.ptr if x2 else None, x2.ld if x2 else 0, x2.k if x2 else 0,
        x2.row_div if x2 else 1,
        g.ptr, g.ld, n, m, rps, _ptr(partial), _stream(partial),
    )
    check(err, "gemm_tn")
    return _reduce_splits(partial, (K, n))


def _bias_grad(g, m):
    """Column sums of an f32 ``_Mat`` (split + reduce); returns (1, n).
    256-row splits: one thread per column and split, so the sum needs many
    splits to fill the card."""
    rps = 256
    splits = -(-m // rps)
    partial = torch.empty((splits, g.k), dtype=_F32, device=g.t.device)
    err = c_function("nnt_colsum", "piiiipp")(
        g.ptr, g.ld, g.k, m, rps, _ptr(partial), _stream(partial))
    check(err, "colsum")
    return _reduce_splits(partial, (1, g.k))


def _reduce_splits(partial, shape):
    out = torch.empty(shape, dtype=_F32, device=partial.device)
    err = c_function("nnt_reduce_splits", "piipp")(
        _ptr(partial), partial.shape[0], out.numel(), _ptr(out),
        _stream(out))
    check(err, "reduce_splits")
    return out


def _dims(weights, l_pos, l_dir):
    n_pos = 3 * (2 * l_pos + 1)
    n_dir = 3 * (2 * l_dir + 1)
    D = weights[0].shape[1]
    H2 = weights[2 * W_NAMES.index("rgb_layer")].shape[1]
    want = {
        "trunk0_0": (n_pos, D), "trunk1_0": (D + n_pos, D),
        "fc_density": (D, 1), "fc_feature": (D, D),
        "rgb_layer": (D + n_dir, H2), "fc_rgb": (H2, 3),
    }
    for i in (1, 2, 3):
        want[f"trunk0_{i}"] = want[f"trunk1_{i}"] = (D, D)
    for i, name in enumerate(W_NAMES):
        if tuple(weights[2 * i].shape) != want[name]:
            raise ValueError(f"{name}: weight shape {tuple(weights[2 * i].shape)}"
                             f", expected {want[name]}")
    return n_pos, n_dir, D, H2


class FusedMLPComposite(torch.autograd.Function):
    """CUDA forward/backward of :func:`fused_mlp_composite`. ``cfg`` is
    (l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S)."""

    @staticmethod
    def forward(ctx, origins, rays, dirs, z, deltas, cfg, *weights):
        l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S = cfg
        n_pos, n_dir, D, H2 = _dims(weights, l_pos, l_dir)
        N = origins.shape[0]
        M = N * S
        dev = origins.device
        wb = [weights[2 * i].detach().to(_BF).contiguous()
              for i in range(len(W_NAMES))]
        bs = [weights[2 * i + 1].detach().reshape(-1).to(_F32).contiguous()
              for i in range(len(W_NAMES))]
        Wb = dict(zip(W_NAMES, wb))
        Bs = dict(zip(W_NAMES, bs))
        stream = _stream(origins)

        enc = torch.empty((M, _pad8(n_pos)), dtype=_BF, device=dev)
        denc = torch.empty((N, _pad8(n_dir)), dtype=_BF, device=dev)
        err = c_function("nnt_encode_fwd", "pppppipiiiiip")(
            _ptr(origins), _ptr(rays), _ptr(dirs), _ptr(z), _ptr(enc),
            enc.shape[1], _ptr(denc), denc.shape[1], N, S, l_pos, l_dir,
            stream)
        check(err, "encode_fwd")

        acts = []
        h = _Mat(enc, n_pos)
        for i in range(4):
            out = torch.empty((M, D), dtype=_BF, device=dev)
            _gemm_nn(h, Wb[f"trunk0_{i}"], M, D, out,
                     bias=Bs[f"trunk0_{i}"], relu=True)
            acts.append(out)
            h = _Mat(out, D)
        for i in range(4):
            out = torch.empty((M, D), dtype=_BF, device=dev)
            w = Wb[f"trunk1_{i}"]
            if i == 0:
                # skip concat [h, enc] as two operand pairs
                _gemm_nn(h, w[:D], M, D, out, a2=_Mat(enc, n_pos), b2=w[D:],
                         bias=Bs["trunk1_0"], relu=True)
            else:
                _gemm_nn(h, w, M, D, out, bias=Bs[f"trunk1_{i}"], relu=True)
            acts.append(out)
            h = _Mat(out, D)
        feat = torch.empty((M, D), dtype=_BF, device=dev)
        _gemm_nn(h, Wb["fc_feature"], M, D, feat, bias=Bs["fc_feature"])
        hr = torch.empty((M, H2), dtype=_BF, device=dev)
        wr = Wb["rgb_layer"]
        # [feat, denc] with the direction encoding read once per ray
        _gemm_nn(_Mat(feat, D), wr[:D], M, H2, hr,
                 a2=_Mat(denc, n_dir, row_div=S), b2=wr[D:],
                 bias=Bs["rgb_layer"], relu=True)
        raw = torch.empty((M, 4), dtype=_F32, device=dev)
        err = c_function("nnt_heads_fwd", "pppppppiiip")(
            _ptr(acts[7]), _ptr(hr), _ptr(Wb["fc_density"]),
            _ptr(Bs["fc_density"]), _ptr(Wb["fc_rgb"]), _ptr(Bs["fc_rgb"]),
            _ptr(raw), M, D, H2, stream)
        check(err, "heads_fwd")
        rgbv = torch.empty((N, 3), dtype=_F32, device=dev)
        dist = torch.empty((N, 1), dtype=_F32, device=dev)
        alpha = torch.empty((N, S), dtype=_F32, device=dev)
        err = c_function("nnt_composite_fwd", "ppppppiiiiiip")(
            _ptr(raw), _ptr(z), _ptr(deltas), _ptr(rgbv), _ptr(dist),
            _ptr(alpha), N, S, int(act == "softplus"), int(occ_alpha),
            int(dist_alpha), int(white_bg), stream)
        check(err, "composite_fwd")
        FWD_LAUNCHES.add()

        ctx.cfg = cfg
        ctx.dims = (n_pos, n_dir, D, H2)
        ctx.save_for_backward(origins, rays, dirs, z, deltas, enc, denc,
                              feat, hr, raw, *acts, *wb)
        return rgbv, dist, alpha

    @staticmethod
    def backward(ctx, g_rgbv, g_dist, g_alpha):
        l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S = ctx.cfg
        n_pos, n_dir, D, H2 = ctx.dims
        saved = ctx.saved_tensors
        origins, rays, dirs, z, deltas, enc, denc, feat, hr, raw = saved[:10]
        acts = saved[10:18]
        Wb = dict(zip(W_NAMES, saved[18:]))
        N = origins.shape[0]
        M = N * S
        dev = origins.device
        stream = _stream(origins)

        def cot(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=_F32, device=dev)
            return g.to(_F32).contiguous()

        g_rgbv = cot(g_rgbv, (N, 3))
        g_dist = cot(g_dist, (N, 1))
        g_alpha = cot(g_alpha, (N, S))

        # compositing + head activations -> cotangents of the raw heads
        g_raw = torch.empty((M, 4), dtype=_F32, device=dev)
        scratch = torch.empty((4, S, N), dtype=_F32, device=dev)
        err = c_function("nnt_composite_bwd", "ppppppppiiiiiip")(
            _ptr(raw), _ptr(z), _ptr(deltas), _ptr(g_rgbv), _ptr(g_dist),
            _ptr(g_alpha), _ptr(scratch), _ptr(g_raw), N, S,
            int(act == "softplus"), int(occ_alpha), int(dist_alpha),
            int(white_bg), stream)
        check(err, "composite_bwd")

        grads = {}
        Wt = {k: _padded_t(v) for k, v in Wb.items()
              if k not in ("fc_density", "fc_rgb")}
        # fc_rgb
        g_rgb = _Mat(g_raw, 3, ld=4, offset=1)
        grads["fc_rgb"] = (_weight_grad(_Mat(hr, H2), g_rgb, M),
                           _bias_grad(g_rgb, M))
        g_hr = torch.empty((M, H2), dtype=_F32, device=dev)
        err = c_function("nnt_heads_bwd", "ppppiip")(
            _ptr(g_raw), _ptr(hr), _ptr(Wb["fc_rgb"]), _ptr(g_hr), M, H2,
            stream)
        check(err, "heads_bwd")
        # rgb_layer: input [feat, denc]
        g_hr_m = _Mat(g_hr, H2)
        grads["rgb_layer"] = (
            _weight_grad(_Mat(feat, D), g_hr_m, M,
                         x2=_Mat(denc, n_dir, row_div=S)),
            _bias_grad(g_hr_m, M))
        g_catr = torch.empty((M, _pad8(D + n_dir)), dtype=_F32, device=dev)
        _gemm_nn(g_hr_m, Wt["rgb_layer"], M, D + n_dir, g_catr)
        g_feat = _Mat(g_catr, D)
        g_sig = _Mat(g_raw, 1, ld=4)
        a13 = _Mat(acts[7], D)
        grads["fc_feature"] = (_weight_grad(a13, g_feat, M),
                               _bias_grad(g_feat, M))
        grads["fc_density"] = (_weight_grad(a13, g_sig, M),
                               _bias_grad(g_sig, M))
        # d(a13) = g_feat @ Wf^T + g_sig @ Wd^T, masked by relu(a13); the
        # (D, 1) density weight is already (1, D) in memory when transposed
        g_h = torch.empty((M, D), dtype=_F32, device=dev)
        _gemm_nn(g_feat, Wt["fc_feature"], M, D, g_h, a2=g_sig,
                 b2=Wb["fc_density"].reshape(1, -1), mask=a13)
        # trunk1, last layer first
        for j in (3, 2, 1):
            x_in = _Mat(acts[4 + j - 1], D)
            g = _Mat(g_h, D)
            grads[f"trunk1_{j}"] = (_weight_grad(x_in, g, M),
                                    _bias_grad(g, M))
            g_h = _gemm_nn(g, Wt[f"trunk1_{j}"], M, D,
                           torch.empty((M, D), dtype=_F32, device=dev),
                           mask=x_in)
        g = _Mat(g_h, D)
        a03 = _Mat(acts[3], D)
        grads["trunk1_0"] = (_weight_grad(a03, g, M, x2=_Mat(enc, n_pos)),
                             _bias_grad(g, M))
        # d(cat): [d a03 (masked), d enc (skip branch, unmasked)]
        g_cat = torch.empty((M, _pad8(D + n_pos)), dtype=_F32, device=dev)
        _gemm_nn(g, Wt["trunk1_0"], M, D + n_pos, g_cat, mask=a03)
        g = _Mat(g_cat, D)
        for j in (3, 2, 1, 0):
            x_in = _Mat(acts[j - 1], D) if j > 0 else _Mat(enc, n_pos)
            grads[f"trunk0_{j}"] = (_weight_grad(x_in, g, M),
                                    _bias_grad(g, M))
            width = D if j > 0 else n_pos
            out = torch.empty((M, _pad8(width)), dtype=_F32, device=dev)
            _gemm_nn(g, Wt[f"trunk0_{j}"], M, width, out,
                     mask=x_in if j > 0 else None)
            g = _Mat(out, width)
        # encoding backward + ray sums
        d_o = torch.empty((N, 3), dtype=_F32, device=dev)
        d_r = torch.empty((N, 3), dtype=_F32, device=dev)
        d_d = torch.empty((N, 3), dtype=_F32, device=dev)
        err = c_function("nnt_encode_bwd", "ppppp" "ipipi" "pppiiiip")(
            _ptr(origins), _ptr(rays), _ptr(dirs), _ptr(z),
            _ptr(g_cat, D), g_cat.shape[1], _ptr(g.t), g.ld,
            _ptr(g_catr, D), g_catr.shape[1],
            _ptr(d_o), _ptr(d_r), _ptr(d_d), N, S, l_pos, l_dir, stream)
        check(err, "encode_bwd")
        BWD_LAUNCHES.add()

        d_weights = []
        for name in W_NAMES:
            d_weights += list(grads[name])
        return (d_o, d_r, d_d, None, None, None, *d_weights)


def fused_mlp_composite(weights, origins, rays, dirs, z, deltas,
                        l_pos, l_dir, act, occ_alpha, dist_alpha,
                        white_bg, S):
    """Fully fused render: per-RAY inputs (origins/rays/dirs (N, 3),
    z/deltas (N, S)) -> (rgb_values (N, 3), dist_pred (N, 1), alpha (N, S)).

    ``weights`` is the 24-tuple of :func:`collect_weights`. CUDA tensors run
    the hand-written kernels; CPU tensors run the plain version."""
    dev = origins.device
    if dev.type == "cpu":
        return fused_mlp_composite_reference(
            weights, origins, rays, dirs, z, deltas, l_pos, l_dir, act,
            occ_alpha, dist_alpha, white_bg, S)
    if dev.type != "cuda":
        raise ValueError(f"fused_mlp_composite: unsupported device {dev}")
    tensors = (origins, rays, dirs, z, deltas) + tuple(weights)
    for t in tensors:
        if t.device != dev or t.dtype != _F32:
            raise ValueError("fused_mlp_composite: every input must be f32 "
                             f"on {dev}")
    N = origins.shape[0]
    if any(t.shape != (N, 3) for t in (origins, rays, dirs)):
        raise ValueError(f"origins/rays/dirs must be ({N}, 3)")
    if z.shape != (N, S) or deltas.shape != (N, S):
        raise ValueError(f"z/deltas must be ({N}, {S})")
    cfg = (int(l_pos), int(l_dir), act, bool(occ_alpha), bool(dist_alpha),
           bool(white_bg), int(S))
    return FusedMLPComposite.apply(
        origins.contiguous(), rays.contiguous(), dirs.contiguous(),
        z.contiguous(), deltas.contiguous(), cfg, *weights)
