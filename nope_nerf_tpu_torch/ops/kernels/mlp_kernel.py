"""Kernels A and C: the fused NeRF MLP, forward and backward, with alpha
compositing (A) or per point (C).

Port of ``nope_nerf_tpu/ops/pallas/mlp_kernel.py``: ``fused_mlp_composite``
(Pallas kernels ``_make_fwd_composite_kernel`` l.668 and
``_make_bwd_composite_kernel`` l.702) and ``fused_mlp`` (``_make_fwd_kernel``
l.244 and ``_make_bwd_kernel`` l.258). The CUDA sources are
``nope_nerf_tpu_torch/csrc/mlp_fused_fwd.cu`` (both forwards, one launch
each), ``nope_nerf_tpu_torch/csrc/mlp_fused_bwd.cu`` (both backwards, one
pass per layer), ``nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu`` (the
layer-by-layer GEMMs, on no path) and
``nope_nerf_tpu_torch/csrc/mlp_composite.cu``; the headers say what bounds
the kernels on the H100 and how the design answers it.

* :func:`fused_mlp_composite` (Kernel A) and :func:`fused_mlp` (Kernel C)
  are the public wrappers. For CUDA tensors they run
  :class:`FusedMLPComposite` / :class:`FusedMLP` and count the launches in
  :data:`FWD_LAUNCHES` / :data:`BWD_LAUNCHES` and :data:`FWD_POINT_LAUNCHES`
  / :data:`BWD_POINT_LAUNCHES`. Each forward is one launch of the fused
  kernel (:func:`fused_fwd`, counted in :data:`MLP_FUSED_FWD_LAUNCHES`):
  encodings, the ten layer GEMMs on a tile kept in shared memory, the heads,
  and the compositing or the head activations; for an S that does not
  divide 128 (:func:`fused_route`) Kernel A's compositing runs after it in
  ``composite_fwd`` (:data:`COMPOSITE_AFTER_LAUNCHES`). Each backward runs
  ten fused layer passes (:func:`gemm_dwgrad`, counted in
  :data:`MLP_FUSED_BWD_LAUNCHES`); Kernel A's backward runs them between
  its compositing backward (:func:`composite_bwd`) and its encoding
  backward (:func:`encode_bwd`), each bitwise equal to the per-ray kernel
  it replaced (:func:`_composite_bwd_per_ray`, :func:`_encode_bwd_per_ray`,
  on no path). CPU tensors run the plain versions
  :func:`fused_mlp_composite_reference` / :func:`fused_mlp_reference`; any
  other device raises.
* What the graph needs, and no more: when nothing is to be differentiated
  (grad disabled, or no input requires grad: the eval render) the fused
  forward stores nothing but its outputs; otherwise it also stores what
  :func:`_chain_bwd` reads (:func:`fused_fwd_saves`). When no weight needs
  a gradient (test-time pose optimisation) the backward runs its passes
  with their weight-gradient half off and skips the launches that serve
  only the weight gradients (counted in :data:`WGRAD_LAUNCHES`). Either way
  the outputs and input gradients are bitwise those of the full path.
* The layer-by-layer forward the fused kernel replaced
  (:func:`_composite_fwd_layered`, :func:`_point_fwd_layered`: the encoding
  launches, :func:`_chain_fwd`'s eleven :func:`gemm_fwd` launches and the
  heads) runs on no path; chip_smoke.py holds the fused forward's saved
  tensors to it bit for bit and times it beside it.
* The backward (:func:`_chain_bwd`) keeps its cotangents bf16 after their
  ReLU masks and takes the bias gradients as f32 column sums in the passes'
  epilogues; every step has a plain version beside it, so it runs whole on
  CPU tensors too. The layer-by-layer backward it replaced
  (:func:`_chain_bwd_layered`: twelve :func:`gemm_dgrad` and eleven or
  twelve :func:`gemm_wgrad` launches with their reductions) runs on no
  path; chip_smoke.py holds the fused backward to it and times it beside
  it.
* The plain versions emulate bf16 operands as bf16-rounded f32 tensors with
  f32 matmuls and take the backward from autograd (matmul cotangents
  rounded to bf16 as in the kernels); both share :func:`_chain_reference`,
  whose layers are :func:`gemm_fwd_reference`, the plain version of
  :func:`gemm_fwd`.

Numerics (all versions): bf16 matmul operands, f32 accumulation, f32
biases, activations rounded to bf16 after the bias/ReLU epilogue, raw head
outputs in f32, stable softplus, exclusive cumprod of (1 - alpha + 1e-6).
z and deltas get no gradient (z never depends on parameters).
"""
from __future__ import annotations

import ctypes

import torch

from ... import tracing
from ..._build import c_function, check
from ...models.nerf import matmul_bf16
from ..encoding import encode_position
from . import LaunchCounter

BM = 1024  # point-padding quantum of the reference package's fused_mlp

# parameter layout: (name, (fan_in, fan_out)) in kernel argument order
W_NAMES = (
    "trunk0_0", "trunk0_1", "trunk0_2", "trunk0_3",
    "trunk1_0", "trunk1_1", "trunk1_2", "trunk1_3",
    "fc_density", "fc_feature", "rgb_layer", "fc_rgb",
)

FWD_LAUNCHES = LaunchCounter("mlp_composite_fwd")
BWD_LAUNCHES = LaunchCounter("mlp_composite_bwd")
FWD_POINT_LAUNCHES = LaunchCounter("mlp_point_fwd")
BWD_POINT_LAUNCHES = LaunchCounter("mlp_point_bwd")
# the launches of Kernels A and C's backwards that run only for the weight
# gradients: WGRAD_PER_BWD[kernel] per backward that computes them (the one
# split reduction at its end, and A's per-ray direction half of rgb_layer's),
# none in one that needs only the input gradients. The layer-by-layer
# backward (_chain_bwd_layered) counts its weight-gradient GEMMs here too
WGRAD_LAUNCHES = LaunchCounter("mlp_weight_grad_gemm")
WGRAD_PER_BWD = {"A": 2, "C": 1}
# the fused backward pass of one layer (csrc/mlp_fused_bwd.cu):
# FUSED_BWD_PER_BWD per backward, with or without the weight gradients
MLP_FUSED_BWD_LAUNCHES = LaunchCounter("mlp_fused_bwd")
FUSED_BWD_PER_BWD = 10
# the fused forward of Kernels A and C (csrc/mlp_fused_fwd.cu): one launch
# per forward; Kernel A's raw route (fused_route) runs composite_fwd after it
MLP_FUSED_FWD_LAUNCHES = LaunchCounter("mlp_fused_fwd")
COMPOSITE_AFTER_LAUNCHES = LaunchCounter("mlp_composite_after_fused")
# the layer-by-layer forward's GEMM (csrc/mlp_gemm_sm90.cu, 11 per forward:
# the ten layer GEMMs and the direction row term of rgb_layer); no path
# launches it since the fused forward (chip_smoke.py times it beside it)
GEMM_SM90_LAUNCHES = LaunchCounter("mlp_gemm_sm90")
# the layer-by-layer backward's input-gradient GEMMs on
# csrc/mlp_gemm_sm90.cu: DGRAD_PER_BWD per backward of _chain_bwd_layered,
# with or without the weight gradients; no path launches them since the
# fused backward (chip_smoke.py times them beside it)
GEMM_DGRAD_LAUNCHES = LaunchCounter("mlp_gemm_dgrad")
DGRAD_PER_BWD = 12
# its weight-gradient GEMMs on csrc/mlp_gemm_sm90.cu (wgmma): 11 per full
# backward of A, 12 of C
GEMM_WGRAD_LAUNCHES = LaunchCounter("mlp_gemm_wgrad")
# the WMMA GEMM of csrc/mlp_composite.cu that the GEMMs above replaced; no
# path launches it (chip_smoke.py times it beside them)
GEMM_NN_LAUNCHES = LaunchCounter("mlp_gemm_nn")
# Kernel A's compositing backward and encoding backward
# (csrc/mlp_composite.cu: composite_bwd_group, encode_bwd_staged), once each
# per backward; the one-thread- and one-warp-per-ray kernels they replaced
# bit for bit run on no path (chip_smoke.py times them beside them)
COMPOSITE_BWD_LAUNCHES = LaunchCounter("composite_bwd")
ENCODE_BWD_LAUNCHES = LaunchCounter("encode_bwd")
COMPOSITE_BWD_PER_RAY_LAUNCHES = LaunchCounter("composite_bwd_per_ray")
ENCODE_BWD_PER_RAY_LAUNCHES = LaunchCounter("encode_bwd_per_ray")
# the layers that run as GEMMs (the two narrow heads run in heads_fwd)
GEMM_LAYERS = tuple(n for n in W_NAMES if n not in ("fc_density", "fc_rgb"))
HEAD_LAYERS = ("fc_density", "fc_rgb")

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


def _weights_dict(weights):
    return {name: (weights[2 * i], weights[2 * i + 1])
            for i, name in enumerate(W_NAMES)}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
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


def gemm_fwd_reference(a1, b1, a2=None, b2=None, bias=None, relu=False,
                       rowterm=None, div=1, out_dtype=_BF):
    """Plain version of :func:`gemm_fwd` with the weights as (K, N):
    act((bf16(a1) @ bf16(b1) [+ bf16(a2) @ bf16(b2)] [+ rowterm[row // div]])
    [+ bias]), f32 accumulation (TF32 off), rounded to bf16 (kept in f32) for
    ``out_dtype`` bf16. Two inputs are one product over the concatenation,
    as the kernel's one accumulator over A1's k-tiles, then A2's."""
    x, w = a1, b1
    if a2 is not None:
        x, w = torch.cat([a1, a2], dim=-1), torch.cat([b1, b2], dim=0)
    y = _mm(x, w)
    if rowterm is not None:
        if div != 1:
            rowterm = rowterm[torch.arange(y.shape[0], device=y.device) // div]
        y = y + rowterm
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return _bf(y) if out_dtype == _BF else y


def gemm_dgrad_reference(a, b, mask=None, gsig=None, wd=None):
    """Plain version of :func:`gemm_dgrad`, in f32 and before the output's
    rounding: mask(bf16(a) @ bf16(b)^T [+ bf16(gsig) bf16(wd)^T]), the
    entries whose ``mask`` activation is <= 0 set to 0. ``b`` is the layer's
    (fan_in, fan_out) weight; the rank-1 term is a product over K = 1 (exact
    in f32), added as autograd adds the two heads' shares of d(a13)."""
    y = _mm(a, b.t())
    if gsig is not None:
        y = y + _mm(gsig.reshape(-1, 1), wd.reshape(1, -1))
    if mask is not None:
        y = torch.where(mask > 0, y, torch.zeros_like(y))
    return y


def gemm_wgrad_reference(x, g):
    """Plain version of :func:`gemm_wgrad`: bf16(x)^T @ bf16(g), f32."""
    return _mm(x.t(), g)


def heads_bwd_reference(g_raw, hr, wc):
    """Plain version of :func:`heads_bwd`, in f32 before the rounding:
    relu_mask(hr) * (bf16(g_raw[:, 1:4]) @ bf16(wc)^T)."""
    y = _mm(g_raw[:, 1:4], wc.t())
    return torch.where(hr > 0, y, torch.zeros_like(y))


def dir_weight_grad_reference(denc, g, div):
    """Plain version of :func:`dir_weight_grad`: denc^T @ (each ray's sum
    of its ``div`` rows of the bf16 g), both f32 (the ray sums are not
    rounded)."""
    gsum = g.float().reshape(denc.shape[0], div, -1).sum(1)
    return denc.float().t() @ gsum


def _chain_reference(W, enc, denc):
    """The MLP from the bf16-rounded encodings (M, 63) / (M, 27) to the raw
    heads: (raw_sigma (M, 1), raw_rgb (M, 3)), f32. The layers are those of
    the kernels' chain: rgb_layer's input [feat, denc] is split into feat @
    W[:D] and the direction row term denc @ W[D:], added before the bias.
    The row term is taken per point here (denc comes per point), so its
    weight gradient sums the bf16-rounded per-point cotangents, as the
    kernels' backward does."""
    h = enc
    for i in range(4):
        w, b = W[f"trunk0_{i}"]
        h = gemm_fwd_reference(h, w, bias=b, relu=True)
    D = h.shape[1]
    for i in range(4):
        w, b = W[f"trunk1_{i}"]
        if i == 0:
            h = gemm_fwd_reference(h, w[:D], enc, w[D:], bias=b, relu=True)
        else:
            h = gemm_fwd_reference(h, w, bias=b, relu=True)
    raw_sigma = _mm(h, W["fc_density"][0]) + W["fc_density"][1]
    feat = gemm_fwd_reference(h, W["fc_feature"][0], bias=W["fc_feature"][1])
    wr, br = W["rgb_layer"]
    hr = gemm_fwd_reference(feat, wr[:D], bias=br, relu=True,
                            rowterm=_mm(denc, wr[D:]))
    raw_rgb = _mm(hr, W["fc_rgb"][0]) + W["fc_rgb"][1]
    return raw_sigma, raw_rgb


def fused_mlp_reference(weights, pts, dirs, l_pos=10, l_dir=4,
                        act="softplus", occ_alpha=False):
    """Plain PyTorch version of :func:`fused_mlp` (same arguments and
    outputs): pts, dirs (M, 3) -> (rgb (M, 3), density (M, 1))."""
    enc = _bf(encode_position(pts, l_pos))
    denc = _bf(encode_position(dirs, l_dir))
    raw_sigma, raw_rgb = _chain_reference(_weights_dict(weights), enc, denc)
    return _act_fwd(raw_sigma, raw_rgb, act, occ_alpha)


def fused_mlp_composite_reference(weights, origins, rays, dirs, z, deltas,
                                  l_pos, l_dir, act, occ_alpha, dist_alpha,
                                  white_bg, S):
    """Plain PyTorch version of :func:`fused_mlp_composite` (same arguments
    and outputs): per-ray (N, 3) geometry and (N, S) z/deltas ->
    (rgb_values (N, 3), dist (N, 1), alpha (N, S))."""
    enc, denc = _encodings_reference(origins, rays, dirs, z, l_pos, l_dir)
    raw_sigma, raw_rgb = _chain_reference(_weights_dict(weights), _bf(enc),
                                          _bf(denc))
    return _composite_reference(raw_sigma, raw_rgb, z, deltas, act,
                                occ_alpha, dist_alpha, white_bg)


def _encodings_reference(origins, rays, dirs, z, l_pos, l_dir):
    """The encodings of :func:`fused_mlp_composite_reference` before their
    bf16 rounding: the position encoding of the N * S points o + r z (M,
    n_pos) and the direction encoding of each ray repeated for its S
    samples (M, n_dir), f32."""
    S = z.shape[1]
    pts = origins[:, None, :] + rays[:, None, :] * z[..., None]
    enc = encode_position(pts.reshape(-1, 3), l_pos)
    denc = encode_position(dirs, l_dir).repeat_interleave(S, dim=0)
    return enc, denc


def _composite_reference(raw_sigma, raw_rgb, z, deltas, act, occ_alpha,
                         dist_alpha, white_bg):
    """The head activations and the compositing of
    :func:`fused_mlp_composite_reference`: raw heads (M, 1) / (M, 3) and
    (N, S) z, deltas -> (rgb_values (N, 3), dist (N, 1), alpha (N, S))."""
    N, S = z.shape
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


def _sigmoid(x):
    """The kernels' sigmoid, 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def composite_bwd_reference(raw, z, deltas, g_rgbv, g_dist, g_alpha, flags):
    """Plain version of :func:`composite_bwd`, step for step as the kernel
    computes it in f32: the cotangents of the raw heads (M, 4) = [sigma,
    rgb] from those of rgb_values (N, 3), dist (N, 1) and alpha (N, S),
    given the raw heads (M, 4) and (N, S) z and deltas. ``flags`` is
    (softplus, occ_alpha, dist_alpha, white_bg). The transmittance is the
    exclusive product of (1 - alpha + 1e-6) and rsum the suffix sum of gw *
    w after each sample, both one sample at a time."""
    softplus_act, occ_alpha, dist_alpha, white_bg = (bool(f) for f in flags)
    N, S = z.shape
    raw = raw.reshape(N, S, 4)
    rs = raw[..., 0]
    d0 = _softplus(rs) if softplus_act else torch.clamp_min(rs, 0.0)
    d = 1.0 - torch.exp(-d0) if occ_alpha else d0
    last = torch.arange(S, device=z.device) == S - 1
    if dist_alpha:
        alpha = torch.where(last, torch.ones_like(d),
                            1.0 - torch.exp(-d * deltas))
    else:
        alpha = d
    sig = [_sigmoid(raw[..., 1 + c]) for c in range(3)]
    gr, gg, gb = (g_rgbv[:, c:c + 1] for c in range(3))
    gw = gr * sig[0] + gg * sig[1] + gb * sig[2] + g_dist * z
    if white_bg:
        gw = gw - (gr + gg + gb)
    factor = 1.0 - alpha + 1e-6
    trans = torch.empty_like(alpha)
    t = torch.ones_like(alpha[:, 0])
    for s in range(S):
        trans[:, s] = t
        t = t * factor[:, s]
    w = alpha * trans
    rsum = torch.empty_like(alpha)
    r = torch.zeros_like(alpha[:, 0])
    for s in range(S - 1, -1, -1):
        rsum[:, s] = r
        r = r + gw[:, s] * w[:, s]
    ga = gw * trans - rsum / (1.0 - alpha + 1e-6) + g_alpha
    if dist_alpha:
        g_sig = torch.where(last, torch.zeros_like(ga),
                            ga * deltas * torch.exp(-d * deltas))
    else:
        g_sig = ga
    dd = _sigmoid(rs) if softplus_act else (rs > 0).to(rs.dtype)
    if occ_alpha:
        dd = dd * torch.exp(-d0)
    g_raw = torch.stack([g_sig * dd] + [w * g * s * (1.0 - s) for g, s in
                                        zip((gr, gg, gb), sig)], -1)
    return g_raw.reshape(N * S, 4)


def _lane_sums(x):
    """Per-ray sums of (N, S, c) over the samples as the kernels' warps take
    them: lane l adds samples l, l + 32, ... in order, then the butterfly
    of ``warp_sum`` (lane 0's operands at each stage)."""
    N, S, c = x.shape
    acc = torch.zeros((N, 32, c), dtype=x.dtype, device=x.device)
    for c0 in range(0, S, 32):
        n = min(32, S - c0)
        acc[:, :n] = acc[:, :n] + x[:, c0:c0 + n]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0]


def encode_bwd_reference(origins, rays, dirs, z, ge1, ge2, gd, l_pos, l_dir):
    """Plain version of :func:`encode_bwd`, step for step as the kernel
    computes it in f32: the backward of the position encoding of o + r z
    from its cotangent ge1 + ge2 ((M, >= n_pos) each) and of the direction
    encoding from gd ((M, >= n_dir), per point) -> (d_origins, d_rays,
    d_dirs), each (N, 3). Each per-ray sum is taken as the kernels' warps
    take it (:func:`_lane_sums`); the direction cotangent is summed over
    the ray before its encoding backward."""
    N, S = z.shape
    n_pos, n_dir = 3 * (2 * l_pos + 1), 3 * (2 * l_dir + 1)
    g = (ge1[:, :n_pos] + ge2[:, :n_pos]).reshape(N, S, n_pos)
    pts = origins[:, None, :] + rays[:, None, :] * z[..., None]
    dp = g[..., :3]
    for lvl in range(l_pos):
        f = 2.0 ** lvl
        ks, kc = 3 * (1 + 2 * lvl), 3 * (2 + 2 * lvl)
        dp = dp + (g[..., ks:ks + 3] * torch.cos(pts * f)
                   - g[..., kc:kc + 3] * torch.sin(pts * f)) * f
    d_o = _lane_sums(dp)
    d_r = _lane_sums(dp * z[..., None])
    gds = _lane_sums(gd[:, :n_dir].reshape(N, S, n_dir))
    dd = gds[:, :3]
    for lvl in range(l_dir):
        f = 2.0 ** lvl
        ks, kc = 3 * (1 + 2 * lvl), 3 * (2 + 2 * lvl)
        dd = dd + (gds[:, ks:ks + 3] * torch.cos(dirs * f)
                   - gds[:, kc:kc + 3] * torch.sin(dirs * f)) * f
    return d_o, d_r, dd


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
        self.ld = t.stride(0) if ld is None else ld

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
    """bf16 w^T (fan_out, fan_in) in a zeroed buffer whose row stride is
    padded to 8: the K-major weight of the forward's GEMMs."""
    out = torch.zeros((w.shape[1], _pad8(w.shape[0])), dtype=_BF,
                      device=w.device)
    out[:, :w.shape[0]] = w.t()
    return out


def _padded(w):
    """bf16 w (fan_in, fan_out), untransposed, row stride padded to 8: the
    B operand of the backward's input-gradient GEMMs (:func:`gemm_dgrad`),
    whose rows are the layer's inputs and whose columns its K."""
    out = torch.zeros((w.shape[0], _pad8(w.shape[1])), dtype=_BF,
                      device=w.device)
    out[:, :w.shape[1]] = w
    return out[:, :w.shape[1]]


# every tensor-map box is one 128-byte swizzle row wide; boxes are 128 rows
# (A), N rows (B) and 64 rows (C, one consumer warpgroup's) deep
TMA_BOX_BYTES = 128
GEMM_BM, GEMM_STORE_ROWS = 128, 64
# the output widths csrc/mlp_gemm_sm90.cu is built for
GEMM_WIDTHS = {_BF: (32, 64, 128, 256), _F32: (32, 64, 128)}
# the row term rides in registers beside the accumulators up to this width
ROWTERM_MAX_N = 128


def tma_2d(t, box_rows):
    """The tensor-map arguments of a row-major 2D view ``t`` for
    csrc/mlp_gemm_sm90.cu: (address, width, rows, row stride in bytes, box
    width, box rows). The width is the view's true width, not the padded
    row stride: TMA zero-fills the box's columns past it on a load (the
    padding of an encoding is uninitialised, and NaN x 0 is NaN) and clips
    them on a store. Raises unless the address and the row stride are
    16-byte aligned, as TMA requires."""
    if t.dim() != 2 or t.stride(1) != 1 or t.dtype not in GEMM_WIDTHS:
        raise ValueError("a TMA operand is a row-major 2D bf16 or f32 view, "
                         f"got {tuple(t.shape)} strides {t.stride()} {t.dtype}")
    es = t.element_size()
    stride = t.stride(0) * es
    if t.data_ptr() % 16 or stride % 16:
        raise ValueError(f"TMA needs 16-byte alignment: address {t.data_ptr()}"
                         f", row stride {stride} bytes")
    return (t.data_ptr(), t.shape[1], t.shape[0], stride,
            TMA_BOX_BYTES // es, box_rows)


_NO_MAP = (None, 0, 0, 0, 0, 0)


def gemm_fwd(a1, w1t, a2=None, w2t=None, bias=None, relu=False, rowterm=None,
             div=1, out=None):
    """One layer of the forward chain: out (M, N) = act(a1 @ w1t^T [+ a2 @
    w2t^T] [+ rowterm[row // div]] [+ bias]) on the TMA + wgmma GEMM
    (csrc/mlp_gemm_sm90.cu), counted in :data:`GEMM_SM90_LAUNCHES`.

    a1, a2: bf16 (M, K) views; w1t, w2t: the K-major bf16 weights (N, K)
    (:func:`_padded_t` columns); bias f32 (N,); rowterm f32 (ceil(M / div),
    N); out bf16 or f32 (M, N), allocated bf16 when None. CPU tensors run
    :func:`gemm_fwd_reference`; on the card an operand the kernel cannot take
    raises."""
    M, N = a1.shape[0], w1t.shape[0]
    dtype = _BF if out is None else out.dtype
    if a1.device.type == "cpu":
        res = gemm_fwd_reference(
            a1.float(), w1t.float().t(), None if a2 is None else a2.float(),
            None if w2t is None else w2t.float().t(), bias, relu, rowterm,
            div, dtype)
        if out is None:
            return res.to(dtype)
        return out.copy_(res)
    if a1.device.type != "cuda":
        raise ValueError(f"gemm_fwd: unsupported device {a1.device}")
    if out is None:
        out = torch.empty((M, N), dtype=_BF, device=a1.device)
    if N not in GEMM_WIDTHS[dtype] or out.shape != (M, N):
        raise ValueError(f"gemm_fwd: output {tuple(out.shape)} {dtype} for "
                         f"({M}, {N}); widths {GEMM_WIDTHS[dtype]}")
    if any(x is not None and x.dtype != _BF for x in (a1, w1t, a2, w2t)):
        raise ValueError("gemm_fwd: A and B operands must be bf16")
    if bias is not None and (bias.dtype != _F32 or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"gemm_fwd: bias must be contiguous f32 ({N},)")
    if rowterm is not None and (
            N > ROWTERM_MAX_N or rowterm.dtype != _F32 or rowterm.dim() != 2
            or rowterm.shape != (-(-M // div), N) or rowterm.stride(1) != 1):
        raise ValueError(f"gemm_fwd: rowterm must be f32 ({-(-M // div)}, "
                         f"{N}) rows, N <= {ROWTERM_MAX_N}")
    if (a2 is None) != (w2t is None):
        raise ValueError("gemm_fwd: a2 and w2t come together")
    maps = (tma_2d(a1, GEMM_BM),
            _NO_MAP if a2 is None else tma_2d(a2, GEMM_BM),
            tma_2d(w1t, N), _NO_MAP if w2t is None else tma_2d(w2t, N),
            tma_2d(out, GEMM_STORE_ROWS))
    fn = c_function("nnt_gemm_sm90", "piiiii" * 5 + "ipipiip")
    err = fn(*[x for m in maps for x in m], int(dtype == _F32),
             _ptr(bias) if bias is not None else None, int(relu),
             _ptr(rowterm) if rowterm is not None else None,
             rowterm.stride(0) if rowterm is not None else 0, int(div),
             _stream(out))
    check(err, "gemm_sm90")
    GEMM_SM90_LAUNCHES.add()
    return out


def _device(name, t):
    """'cpu' or 'cuda' for a wrapper's operand; raises on any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tile_width(n, dtype):
    """The tile width of csrc/mlp_gemm_sm90.cu that holds an output n wide."""
    for w in GEMM_WIDTHS[dtype]:
        if n <= w:
            return w
    raise ValueError(f"no GEMM tile holds {n} {dtype} columns; widths "
                     f"{GEMM_WIDTHS[dtype]}")


def gemm_dgrad(a, b, out, mask=None, gsig=None, wd=None, colsum=False):
    """One input-gradient GEMM of the backward chain: out (M, N) =
    mask(a @ b^T [+ bf16(gsig) wd^T]) on the TMA + wgmma GEMM
    (csrc/mlp_gemm_sm90.cu), counted in :data:`GEMM_DGRAD_LAUNCHES`.

    a: the bf16 cotangent (M, K) view; b: bf16 rows of a layer's weight as
    :func:`_padded` stores it, (N, K = fan_out); out: bf16 (a cotangent, N
    a tile width) or f32 (an encoding's cotangent, N <= 128) (M, N) view;
    mask: a bf16 (M, N) activation whose entries <= 0 zero the output; gsig
    f32 (M,) (any stride) and wd bf16 (N,): the rank-1 term. Returns (out,
    the f32 column sums of the values before rounding (N,), with
    ``colsum``, else None). CPU tensors run :func:`gemm_dgrad_reference`; on
    the card an operand the kernel cannot take raises."""
    M, N = out.shape
    if _device("gemm_dgrad", a) == "cpu":
        y = gemm_dgrad_reference(
            a.float(), b.float(), None if mask is None else mask.float(),
            gsig, None if wd is None else wd.float())
        out.copy_(y)
        return out, (y.sum(0) if colsum else None)
    bn = _tile_width(N, out.dtype)
    if a.dtype != _BF or b.dtype != _BF or a.shape != (M, b.shape[1]) \
            or b.shape[0] != N:
        raise ValueError(f"gemm_dgrad: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype} for out {tuple(out.shape)}"
                         "; a and b must be bf16 (M, K) and (N, K)")
    if mask is not None and (mask.dtype != _BF or mask.shape != (M, N)
                             or out.dtype != _BF or N != bn):
        raise ValueError("gemm_dgrad: a mask is a bf16 (M, N) activation of a "
                         "bf16 output N a tile width wide")
    if (gsig is None) != (wd is None) or (gsig is not None and (
            gsig.dtype != _F32 or gsig.shape != (M,) or wd.dtype != _BF
            or wd.shape != (N,) or not wd.is_contiguous() or N != bn)):
        raise ValueError("gemm_dgrad: the rank-1 term is f32 gsig (M,) with "
                         "contiguous bf16 wd (N,), N a tile width")
    if colsum and N != bn:
        raise ValueError(f"gemm_dgrad: column sums need N a tile width, not {N}")
    # persistent blocks: one per 128-row tile, up to one per SM; each
    # warpgroup's column sums are one row of ``sums``
    grid = max(1, min(-(-M // GEMM_BM), _sm_count(out.device)))
    sums = (torch.empty((2 * grid, N), dtype=_F32, device=out.device)
            if colsum else None)
    maps = (tma_2d(a, GEMM_BM), tma_2d(b, bn), tma_2d(out, GEMM_STORE_ROWS))
    mask_map = _NO_MAP if mask is None else tma_2d(mask, GEMM_STORE_ROWS)
    fn = c_function("nnt_gemm_dgrad", "piiiii" * 3 + "i" + "piiiii" + "pippip")
    err = fn(*[x for m in maps for x in m], int(out.dtype == _F32), *mask_map,
             _ptr(gsig) if gsig is not None else None,
             gsig.stride(0) if gsig is not None else 0,
             _ptr(wd) if wd is not None else None,
             _ptr(sums) if sums is not None else None, grid, _stream(out))
    check(err, "gemm_dgrad")
    GEMM_DGRAD_LAUNCHES.add()
    if sums is None:
        return out, None
    return out, _reduce_splits(sums, torch.empty(N, dtype=_F32,
                                                 device=out.device))


# rows per ring stage of the weight-gradient GEMM, and the rows of dW a block
# owns (two warpgroups x 64)
WGRAD_CHUNK, WGRAD_ROWS = 64, 128


def wgrad_rows_per_split(m, k_in, sms):
    """Rows each block of :func:`gemm_wgrad` sums: about one block per SM
    over the (dW row tiles x splits) grid, a multiple of the 64-row chunk."""
    splits = max(1, sms // -(-k_in // WGRAD_ROWS))
    return -(-m // (splits * WGRAD_CHUNK)) * WGRAD_CHUNK


def gemm_wgrad(x, g, out=None):
    """One weight-gradient GEMM of the backward chain: out (K_in, N) f32 =
    x^T @ g summed over the M rows, on wgmma (csrc/mlp_gemm_sm90.cu) as
    deterministic split-K partial sums + :func:`_reduce_splits`, counted in
    :data:`GEMM_WGRAD_LAUNCHES` and :data:`WGRAD_LAUNCHES`.

    x: the saved bf16 activation (M, K_in) view; g: the bf16 cotangent (M, N)
    view, N a multiple of 8 up to 256; out: a contiguous f32 (K_in, N) (rows
    of a larger dW), allocated when None. CPU tensors run
    :func:`gemm_wgrad_reference`; on the card an operand the kernel cannot
    take raises."""
    (M, K), N = x.shape, g.shape[1]
    if out is None:
        out = torch.empty((K, N), dtype=_F32, device=x.device)
    if _device("gemm_wgrad", x) == "cpu":
        return out.copy_(gemm_wgrad_reference(x.float(), g.float()))
    if x.dtype != _BF or g.dtype != _BF or g.shape[0] != M or N % 8 \
            or N > 256 or out.dtype != _F32 or out.shape != (K, N) \
            or not out.is_contiguous():
        raise ValueError(f"gemm_wgrad: x {tuple(x.shape)} {x.dtype}, g "
                         f"{tuple(g.shape)} {g.dtype}, out {tuple(out.shape)}"
                         f" {out.dtype}: x and g bf16 with M rows, N a "
                         "multiple of 8 <= 256, out contiguous f32 (K_in, N)")
    if M == 0:
        return out.zero_()
    rps = wgrad_rows_per_split(M, K, _sm_count(x.device))
    partial = torch.empty((-(-M // rps), K, N), dtype=_F32, device=x.device)
    err = c_function("nnt_gemm_wgrad", "piiiii" * 2 + "ipp")(
        *tma_2d(x, WGRAD_CHUNK), *tma_2d(g, WGRAD_CHUNK), rps, _ptr(partial),
        _stream(partial))
    check(err, "gemm_wgrad")
    GEMM_WGRAD_LAUNCHES.add()
    WGRAD_LAUNCHES.add()
    return _reduce_splits(partial, out)


# rows per block of heads_bwd_kernel, rays per split of dir_wgrad_kernel and
# rows per split of head_wgrad_kernel (the partial sums' row counts)
HEADS_BWD_ROWS, DIR_WGRAD_RAYS, HEAD_WGRAD_ROWS = 64, 32, 256


def heads_bwd(g_raw, hr, wc, out, colsum=False):
    """The rgb head's backward: out (M, H2) bf16 = relu_mask(hr) *
    (bf16(g_raw[:, 1:4]) @ wc^T), from g_raw (M, 4) f32, the saved bf16 hr
    and the bf16 fc_rgb weight wc (H2, 3). Returns (out, the f32 column sums
    before rounding (H2,): rgb_layer's bias gradient, with ``colsum``, else
    None). CPU tensors run :func:`heads_bwd_reference`."""
    M, H2 = hr.shape
    if _device("heads_bwd", g_raw) == "cpu":
        y = heads_bwd_reference(g_raw, hr.float(), wc.float())
        out.copy_(y)
        return out, (y.sum(0) if colsum else None)
    if out.dtype != _BF or out.shape != (M, H2) or not out.is_contiguous() \
            or not hr.is_contiguous() or not g_raw.is_contiguous():
        raise ValueError("heads_bwd: contiguous g_raw, hr and a bf16 out")
    sums = (torch.empty((-(-M // HEADS_BWD_ROWS), H2), dtype=_F32,
                        device=out.device) if colsum else None)
    err = c_function("nnt_heads_bwd", "pppppiiip")(
        _ptr(g_raw), _ptr(hr), _ptr(wc), _ptr(out),
        _ptr(sums) if sums is not None else None, M, H2, HEADS_BWD_ROWS,
        _stream(out))
    check(err, "heads_bwd")
    if sums is None:
        return out, None
    return out, _reduce_splits(sums, torch.empty(H2, dtype=_F32,
                                                 device=out.device))


def dir_weight_grad(denc, g, div, out):
    """Kernel A's direction half of rgb_layer's weight gradient, with the
    direction encoding per ray: out (k, N) f32 = denc^T @ (the per-ray sums
    of the bf16 g (M = rays x ``div``, N)), both steps in f32 (csrc/
    mlp_composite.cu: ray_sum_kernel, dir_wgrad_kernel), counted in
    :data:`WGRAD_LAUNCHES`. It equals the per-point sum of the plain version
    up to f32 order. CPU tensors run :func:`dir_weight_grad_reference`."""
    if _device("dir_weight_grad", denc) == "cpu":
        return out.copy_(dir_weight_grad_reference(denc, g, div))
    rays, k = denc.shape
    N = g.shape[1]
    if denc.stride(1) != 1 or g.stride(1) != 1 or g.shape[0] != rays * div \
            or out.shape != (k, N) or not out.is_contiguous():
        raise ValueError("dir_weight_grad: row-major denc (rays, k), g "
                         "(rays x div, N) and a contiguous out (k, N)")
    gsum = torch.empty((rays, N), dtype=_F32, device=out.device)
    partial = torch.empty((-(-rays // DIR_WGRAD_RAYS), k, N), dtype=_F32,
                          device=out.device)
    err = c_function("nnt_dir_wgrad", "piipiiiiipppp")(
        _ptr(denc), denc.stride(0), k, _ptr(g), g.stride(0), N, rays, div,
        DIR_WGRAD_RAYS, _ptr(gsum), _ptr(partial), _ptr(out), _stream(out))
    check(err, "dir_wgrad")
    WGRAD_LAUNCHES.add()
    return out


def head_weight_grad(x, g):
    """The weight gradient of a narrow head (fc_rgb, fc_density): (K, n)
    f32 = x^T @ bf16(g) with x the saved bf16 (M, K) activation and g an f32
    (M, n <= 4) view of g_raw's columns (csrc/mlp_composite.cu
    head_wgrad_kernel, split over rows + :func:`_reduce_splits`), counted in
    :data:`WGRAD_LAUNCHES`. CPU tensors run :func:`gemm_wgrad_reference`."""
    (M, K), n = x.shape, g.shape[1]
    if _device("head_weight_grad", x) == "cpu":
        return gemm_wgrad_reference(x.float(), g)
    if x.dtype != _BF or g.dtype != _F32 or g.shape[0] != M or n > 4 \
            or x.stride(1) != 1 or g.stride(1) != 1 or K % 2 or K > 512 \
            or x.stride(0) % 2 or x.data_ptr() % 4:
        raise ValueError("head_weight_grad: row-major bf16 x (M, K <= 512), K"
                         " and its row stride even, and f32 g (M, n <= 4)")
    partial = torch.empty((-(-M // HEAD_WGRAD_ROWS), K, n), dtype=_F32,
                          device=x.device)
    err = c_function("nnt_head_wgrad", "piipiiiipp")(
        _ptr(x), x.stride(0), K, _ptr(g), g.stride(0), n, M, HEAD_WGRAD_ROWS,
        _ptr(partial), _stream(partial))
    check(err, "head_wgrad")
    WGRAD_LAUNCHES.add()
    return _reduce_splits(partial, torch.empty((K, n), dtype=_F32,
                                               device=x.device))


def _gemm_nn(a1, b1, m, n, out, a2=None, b2=None, bias=None, relu=False,
             mask=None):
    """out (m, n) = epilogue(a1 @ b1 [+ a2 @ b2] [+ bias]) on the WMMA
    gemm_nn that gemm_fwd and gemm_dgrad replaced, kept for chip_smoke.py's
    timing beside them; ``mask`` is a ``_Mat`` of a saved bf16 activation
    whose ReLU mask zeroes out[:, :k]. b1 / b2 are bf16 (K, >= n) tensors,
    their row stride is shape[1]."""
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
    GEMM_NN_LAUNCHES.add()
    return out


def _split_rows(m, K, n, blocks=528):
    """Rows per split of a split-K weight-gradient GEMM: enough splits that
    the (K/128, n/128, splits) grid has about ``blocks`` blocks (4 per SM
    of an H100), a multiple of the 32-row GEMM step."""
    tiles = -(-K // 128) * -(-n // 128)
    splits = max(1, -(-blocks // tiles))
    return max(32, -(-m // (splits * 32)) * 32)


def _weight_grad(x1, g, m, x2=None):
    """dW = [x1 | x2]^T @ bf16(g) on the WMMA gemm_tn as deterministic
    split-K partial sums + reduce: the weight-gradient GEMM that gemm_wgrad
    replaced, kept for chip_smoke.py's timing beside it. x1/x2 are bf16
    ``_Mat``s (x2 may be read per ray, row / row_div), g an f32 ``_Mat``;
    returns f32 (K, n)."""
    K = x1.k + (x2.k if x2 else 0)
    n = g.k
    dev = g.t.device
    rps = _split_rows(m, K, n)
    splits = -(-m // rps)
    partial = torch.empty((splits, K, n), dtype=_F32, device=dev)
    err = c_function("nnt_gemm_tn", "piipiiipiiiipp")(
        x1.ptr, x1.ld, x1.k,
        x2.ptr if x2 else None, x2.ld if x2 else 0, x2.k if x2 else 0,
        x2.row_div if x2 else 1,
        g.ptr, g.ld, n, m, rps, _ptr(partial), _stream(partial),
    )
    check(err, "gemm_tn")
    WGRAD_LAUNCHES.add()
    return _reduce_splits(partial, torch.empty((K, n), dtype=_F32,
                                               device=dev))


def _bias_grad(g):
    """Column sums (1, n) of an f32 (M, n) view (split + reduce): the
    biases of the two narrow heads, from g_raw's four columns. 256-row
    splits, one thread per column and split. CPU tensors run the plain
    version."""
    m, n = g.shape
    if _device("bias_grad", g) == "cpu":
        return g.sum(0, keepdim=True)
    rps = 256
    splits = -(-m // rps)
    partial = torch.empty((splits, n), dtype=_F32, device=g.device)
    err = c_function("nnt_colsum", "piiiipp")(
        _ptr(g), g.stride(0), n, m, rps, _ptr(partial), _stream(partial))
    check(err, "colsum")
    return _reduce_splits(partial, torch.empty((1, n), dtype=_F32,
                                               device=g.device))


def _reduce_splits(partial, out):
    """out (contiguous, partial[0]'s size) = the sum over partial's first
    dimension, in order."""
    err = c_function("nnt_reduce_splits", "piipp")(
        _ptr(partial), partial.shape[0], out.numel(), _ptr(out),
        _stream(out))
    check(err, "reduce_splits")
    return out


def heads_fwd(h, hr, wd, bd, wc, bc):
    """The two narrow heads: raw (M, 4) f32 = [h @ wd + bd, hr @ wc + bc]
    (bf16 operands, f32 sums; csrc/mlp_composite.cu heads_fwd_kernel). CPU
    tensors run the plain version."""
    M, D = h.shape
    if _device("heads_fwd", h) == "cpu":
        return torch.cat([_mm(h.float(), wd.float()) + bd,
                          _mm(hr.float(), wc.float()) + bc], 1)
    raw = torch.empty((M, 4), dtype=_F32, device=h.device)
    err = c_function("nnt_heads_fwd", "pppppppiiip")(
        _ptr(h), _ptr(hr), _ptr(wd), _ptr(bd), _ptr(wc), _ptr(bc), _ptr(raw),
        M, D, hr.shape[1], _stream(raw))
    check(err, "heads_fwd")
    return raw


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


def _kernel_weights(weights, save):
    """The weights as the kernels read them: the K-major bf16 weights of the
    forward's GEMM layers (:func:`_padded_t`), with ``save`` the untransposed
    bf16 weights of the backward's input-gradient GEMMs (:func:`_padded`;
    else None), the bf16 (K, N) head weights and the f32 bias vectors (all
    dicts)."""
    W = _weights_dict(weights)
    wt = {name: _padded_t(W[name][0].detach()) for name in GEMM_LAYERS}
    wb = ({name: _padded(W[name][0].detach()) for name in GEMM_LAYERS}
          if save else None)
    wh = {name: W[name][0].detach().to(_BF).contiguous()
          for name in HEAD_LAYERS}
    bs = {name: b.detach().reshape(-1).to(_F32).contiguous()
          for name, (_, b) in W.items()}
    return wt, wb, wh, bs


def _chain_fwd(Wt, Wh, Bs, enc, denc, denc_div, M, dims, save=True):
    """The GEMM chain from the bf16 encodings to the raw heads, its ten layer
    GEMMs and the direction row term on :func:`gemm_fwd`. ``denc`` rows
    are read once per ``denc_div`` points (per ray in Kernel A, per point in
    C): rgb_layer = feat @ W[:D] + (denc @ W[D:])[row // denc_div] + b.
    Returns (acts (the 8 trunk outputs), feat, hr, raw (M, 4) f32 =
    [raw_sigma, raw_rgb]).

    With ``save`` False (nothing will be differentiated) the trunk runs on
    two ping-pong buffers and ``feat`` reuses the free one: only
    ``acts[-1]`` is then still the trunk output it names, and the outputs
    are bitwise those of the saving chain (the same GEMMs on the same
    inputs)."""
    n_pos, n_dir, D, H2 = dims
    dev = enc.device
    acts = []
    bufs = (None if save else
            [torch.empty((M, D), dtype=_BF, device=dev) for _ in range(2)])

    def trunk_out(i):
        if save:
            return torch.empty((M, D), dtype=_BF, device=dev)
        return bufs[i % 2]

    pos = enc[:, :n_pos]  # true width: the padding column is never read
    h = pos
    for i in range(4):
        w = Wt[f"trunk0_{i}"]
        h = gemm_fwd(h, w[:, :h.shape[1]], bias=Bs[f"trunk0_{i}"], relu=True,
                     out=trunk_out(i))
        acts.append(h)
    for i in range(4):
        w = Wt[f"trunk1_{i}"]
        # the skip concat [h, enc] as two operand pairs
        skip = dict(a2=pos, w2t=w[:, D:D + n_pos]) if i == 0 else {}
        h = gemm_fwd(h, w[:, :D], bias=Bs[f"trunk1_{i}"], relu=True,
                     out=trunk_out(4 + i), **skip)
        acts.append(h)
    feat = gemm_fwd(h, Wt["fc_feature"][:, :D], bias=Bs["fc_feature"],
                    out=trunk_out(8))
    wr = Wt["rgb_layer"]
    # [feat, denc] without building the concat: the direction half once per
    # denc row, added in the epilogue of the per-point GEMM
    rowterm = gemm_fwd(denc[:, :n_dir], wr[:, D:D + n_dir],
                       out=torch.empty((denc.shape[0], H2), dtype=_F32,
                                       device=dev))
    hr = gemm_fwd(feat, wr[:, :D], bias=Bs["rgb_layer"], relu=True,
                  rowterm=rowterm, div=denc_div,
                  out=torch.empty((M, H2), dtype=_BF, device=dev))
    raw = heads_fwd(acts[-1], hr, Wh["fc_density"], Bs["fc_density"],
                    Wh["fc_rgb"], Bs["fc_rgb"])
    return acts, feat, hr, raw


# the fused forward (csrc/mlp_fused_fwd.cu): the hidden widths it is built
# for (rgb_layer's output D / 2), its point tile, the widest encoding (one
# 64-column k-tile) and what it computes after the heads
FUSED_WIDTHS = (64, 128, 256)
FUSED_TILE = 128
FUSED_MAX_ENC = 64
MODE_COMPOSITE, MODE_RAW, MODE_POINTS = 0, 1, 2
# the weight k-tile maps in the order the kernel's ring streams them:
# (layer, first column, width: "D", "pos" or "dir")
FUSED_WEIGHT_MAPS = (
    ("trunk0_0", 0, "pos"), ("trunk0_1", 0, "D"), ("trunk0_2", 0, "D"),
    ("trunk0_3", 0, "D"), ("trunk1_0", 0, "D"), ("trunk1_0", "D", "pos"),
    ("trunk1_1", 0, "D"), ("trunk1_2", 0, "D"), ("trunk1_3", 0, "D"),
    ("fc_feature", 0, "D"), ("rgb_layer", "D", "dir"), ("rgb_layer", 0, "D"))
FUSED_SAVE_MAPS = 12  # acts (8), feat, hr, enc, denc


def fused_route(S):
    """How Kernel A's forward composites S samples a ray, chosen by shape:
    ``"fused"`` when a 128-point tile holds whole rays (128 % S == 0: the
    stock 128 and the recovery scripts' 64), inside the fused kernel;
    ``"raw"`` otherwise: the fused kernel writes the raw heads and
    ``composite_fwd`` (csrc/mlp_composite.cu) runs after it. Both routes
    are kernels; neither stands in for the other."""
    return "fused" if FUSED_TILE % S == 0 else "raw"


def fused_fwd_saves(M, denc_rows, dims, dev):
    """The tensors a saving fused forward writes, in the shapes, dtypes and
    row strides :func:`_chain_bwd` reads (those the layer-by-layer forward
    allocated): enc (M, pad8(n_pos)) and denc (denc_rows, pad8(n_dir)) bf16
    (their padding column is never written), the 8 trunk outputs, feat
    (M, D) and hr (M, H2) bf16, raw (M, 4) f32."""
    n_pos, n_dir, D, H2 = dims
    bf = dict(dtype=_BF, device=dev)
    return {"enc": torch.empty((M, _pad8(n_pos)), **bf),
            "denc": torch.empty((denc_rows, _pad8(n_dir)), **bf),
            "acts": [torch.empty((M, D), **bf) for _ in range(8)],
            "feat": torch.empty((M, D), **bf),
            "hr": torch.empty((M, H2), **bf),
            "raw": torch.empty((M, 4), dtype=_F32, device=dev)}


def fused_fwd_maps(Wt, dims, saves, points):
    """The fused kernel's tensor-map arguments (:func:`tma_2d` tuples): the
    12 weight k-tile maps of :data:`FUSED_WEIGHT_MAPS` (each a view of the
    K-major :func:`_padded_t` weight at its true width, box rows D, or D / 2
    for rgb_layer's two), then the :data:`FUSED_SAVE_MAPS` save maps (box
    rows 64, one consumer warpgroup's): the 8 trunk outputs, feat, hr, the
    position encoding at its true width, and the direction encoding for C
    (``points``; A's is per ray and written row by row). Without ``saves``
    the save maps are empty."""
    n_pos, n_dir, D, H2 = dims
    width = {"D": D, "pos": n_pos, "dir": n_dir}
    maps = []
    for name, k0, w in FUSED_WEIGHT_MAPS:
        k0 = D if k0 == "D" else k0
        maps.append(tma_2d(Wt[name][:, k0:k0 + width[w]],
                           H2 if name == "rgb_layer" else D))
    if saves is None:
        return maps + [_NO_MAP] * FUSED_SAVE_MAPS
    views = [*saves["acts"], saves["feat"], saves["hr"],
             saves["enc"][:, :n_pos]]
    maps += [tma_2d(v, GEMM_STORE_ROWS) for v in views]
    maps.append(tma_2d(saves["denc"][:, :n_dir], GEMM_STORE_ROWS) if points
                else _NO_MAP)
    return maps


def fused_fwd(Wt, Wh, Bs, dims, mode, levels, S, inputs, outs, flags,
              saves=None, raw=None):
    """One launch of the fused forward (csrc/mlp_fused_fwd.cu), counted in
    :data:`MLP_FUSED_FWD_LAUNCHES`.

    ``Wt``/``Wh``/``Bs``: :func:`_kernel_weights`' K-major weights, head
    weights and biases; ``mode``: :data:`MODE_COMPOSITE` (Kernel A, 128 %
    S == 0), :data:`MODE_RAW` (Kernel A, the raw heads only) or
    :data:`MODE_POINTS` (Kernel C, S = 1); ``levels`` (l_pos, l_dir);
    ``inputs`` (x0, x1, dirs, z, deltas): A's per-ray origins, directions
    and view directions and its (N, S) z and deltas, or C's points and view
    directions with None for the rest; ``outs`` (out0, out1, alpha): A's
    rgbv (N, 3), dist (N, 1), alpha (N, S) (None on the raw route) or C's
    rgb (M, 3), density (M, 1), None; ``flags`` (softplus, occ_alpha,
    dist_alpha, white_bg); ``saves``: :func:`fused_fwd_saves` to write, or
    None; ``raw`` (M, 4) f32 to write (with ``saves`` its own). Inputs are
    contiguous f32 on one card; raises on anything the kernel cannot
    take."""
    n_pos, n_dir, D, H2 = dims
    x0 = inputs[0]
    points = mode == MODE_POINTS
    M = x0.shape[0] if points else x0.shape[0] * S
    n_rays = M if points else x0.shape[0]
    if D not in FUSED_WIDTHS or H2 != D // 2:
        raise ValueError(f"fused_fwd: hidden width {D} with rgb width {H2}; "
                         f"the kernel takes D in {FUSED_WIDTHS}, D / 2")
    if max(n_pos, n_dir) > FUSED_MAX_ENC:
        raise ValueError(f"fused_fwd: encodings {n_pos} and {n_dir} wide; at "
                         f"most {FUSED_MAX_ENC} (levels <= 10)")
    if mode == MODE_COMPOSITE and fused_route(S) != "fused":
        raise ValueError(f"fused_fwd: {S} samples a ray do not tile "
                         f"{FUSED_TILE} points; take the raw route")
    if M >= 2 ** 31:
        raise ValueError(f"fused_fwd: {M} points; fewer than 2^31")
    tensors = [t for t in (*inputs, *outs, raw) if t is not None]
    if any(t.device != x0.device or t.dtype != _F32
           or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_fwd: inputs and outputs must be contiguous "
                         f"f32 on {x0.device}")
    if raw is None and (mode == MODE_RAW or saves is not None):
        raise ValueError("fused_fwd: the raw route and a saving forward "
                         "write raw")
    if M == 0:
        return
    maps = fused_fwd_maps(Wt, dims, saves, points)
    specs = (ctypes.c_int64 * (6 * len(maps)))(
        *[int(v or 0) for m in maps for v in m])
    heads = (Wh["fc_density"], Bs["fc_density"], Wh["fc_rgb"], Bs["fc_rgb"])
    denc_rays = saves["denc"] if saves is not None and not points else None
    ptrs = (*inputs, *(Bs[name] for name in GEMM_LAYERS), *heads, *outs, raw,
            denc_rays)
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    ints = (ctypes.c_int * 13)(
        D, M, n_rays, S, levels[0], levels[1], mode, int(saves is not None),
        *(int(f) for f in flags),
        0 if denc_rays is None else denc_rays.stride(0))
    err = c_function("nnt_mlp_fused_fwd", "pppp")(
        ctypes.addressof(specs), ctypes.addressof(ptr_arr),
        ctypes.addressof(ints), _stream(x0))
    check(err, "mlp_fused_fwd")
    MLP_FUSED_FWD_LAUNCHES.add()


# ---------------------------------------------------------------------------
# The fused backward (csrc/mlp_fused_bwd.cu): one pass per layer
# ---------------------------------------------------------------------------

# fan-in columns per block of the fused backward pass, rows per tile (the
# cotangent's and the inputs' tensor-map boxes; an output box is one
# warpgroup's 64 rows), and the cotangent widths (the layers' fan_out) it is
# built for
FUSED_BWD_SLICE, FUSED_BWD_TILE = 64, 128
FUSED_BWD_WIDTHS = (32, 64, 128, 256)


def gemm_dwgrad_reference(g, w, x=None, mask=None, gsig=None, wd=None):
    """Plain version of one group of :func:`gemm_dwgrad`: (the input
    gradient in f32 before its rounding, :func:`gemm_dgrad_reference`; the
    weight gradient x^T g, :func:`gemm_wgrad_reference`, or None without
    ``x``)."""
    y = gemm_dgrad_reference(g, w, mask, gsig, wd)
    return y, (None if x is None else gemm_wgrad_reference(x, g))


class DwGroup:
    """One group of columns of a layer's input in :func:`gemm_dwgrad`.

    w: the layer's bf16 weight rows of the group, a (K, N) view of
    :func:`_padded`; out: its input gradient, a (M, K) bf16 (a cotangent)
    or f32 (an encoding's) view; x: the saved bf16 (M, K) input of the
    group, or None when nothing reads it; mask: the output is zeroed where
    x <= 0 (the ReLU of the layer below); colsum: an f32 (K,) tensor for the
    column sums of the masked values before rounding (the bias gradient of
    the layer below), or None; dw: a contiguous f32 (K, N) tensor for x^T g,
    or None."""

    __slots__ = ("w", "out", "x", "mask", "colsum", "dw")

    def __init__(self, w, out, x=None, mask=False, colsum=None, dw=None):
        self.w, self.out, self.x, self.mask = w, out, x, mask
        self.colsum, self.dw = colsum, dw


def dwgrad_split(m, slices, sms):
    """(row tiles per split, splits) of :func:`gemm_dwgrad` on ``m`` rows
    whose input has ``slices`` 64-column slices: about one block per SM over
    the (splits x slices) grid, every split non-empty."""
    tiles = -(-m // FUSED_BWD_TILE)
    splits = max(1, min(tiles, sms // slices))
    per = -(-tiles // splits)
    return per, -(-tiles // per)


class SplitSums:
    """The split partial sums of a backward's weight and bias gradients,
    added in one launch of reduce_segments (csrc/mlp_fused_bwd.cu) at its
    end, counted in :data:`WGRAD_LAUNCHES`: each entry an f32 partial whose
    split s starts at element s * stride, and the contiguous output its sum
    over the splits fills."""

    MAX = 32

    def __init__(self):
        self.entries = []

    def add(self, partial, out, splits, stride):
        if not out.is_contiguous() or out.dtype != _F32:
            raise ValueError("SplitSums: outputs are contiguous f32")
        self.entries.append((partial, out, splits, stride))

    def run(self):
        if not self.entries:
            return
        if len(self.entries) > self.MAX:
            raise ValueError(f"SplitSums: {len(self.entries)} entries; at "
                             f"most {self.MAX} a launch")
        n = len(self.entries)
        parts = (ctypes.c_uint64 * n)(*[p.data_ptr() for p, _, _, _ in self.entries])
        outs = (ctypes.c_uint64 * n)(*[o.data_ptr() for _, o, _, _ in self.entries])
        strides = (ctypes.c_int64 * n)(*[s for _, _, _, s in self.entries])
        splits = (ctypes.c_int * n)(*[k for _, _, k, _ in self.entries])
        sizes = (ctypes.c_int * n)(*[o.numel() for _, o, _, _ in self.entries])
        out = self.entries[0][1]
        err = c_function("nnt_reduce_segments", "pppppip")(
            ctypes.addressof(parts), ctypes.addressof(outs),
            ctypes.addressof(strides), ctypes.addressof(splits),
            ctypes.addressof(sizes), n, _stream(out))
        check(err, "reduce_segments")
        WGRAD_LAUNCHES.add()
        self.entries = []


def _check_dwgrad(g, groups, gsig, wd, dwd):
    """Raise unless :func:`gemm_dwgrad`'s kernel takes these operands."""
    M, N = g.shape
    if g.dtype != _BF or N not in FUSED_BWD_WIDTHS or M >= 2 ** 31:
        raise ValueError(f"gemm_dwgrad: g {tuple(g.shape)} {g.dtype}; a bf16 "
                         f"cotangent N in {FUSED_BWD_WIDTHS} wide")
    if not 1 <= len(groups) <= 2:
        raise ValueError("gemm_dwgrad: one or two groups of columns")
    for i, grp in enumerate(groups):
        K = grp.w.shape[0]
        if grp.w.dtype != _BF or grp.w.shape[1] != N:
            raise ValueError(f"gemm_dwgrad: weight rows {tuple(grp.w.shape)} "
                             f"{grp.w.dtype}; bf16 (K, {N})")
        if grp.out.shape != (M, K) or grp.out.dtype not in (_BF, _F32):
            raise ValueError(f"gemm_dwgrad: output {tuple(grp.out.shape)} "
                             f"{grp.out.dtype}; bf16 or f32 ({M}, {K})")
        if grp.x is not None and (grp.x.dtype != _BF or grp.x.shape != (M, K)):
            raise ValueError(f"gemm_dwgrad: input {tuple(grp.x.shape)} "
                             f"{grp.x.dtype}; bf16 ({M}, {K})")
        if (grp.mask or grp.colsum is not None) and (
                i != 0 or grp.out.dtype != _BF):
            raise ValueError("gemm_dwgrad: a mask and column sums belong to "
                             "the first group, with a bf16 output")
        if grp.mask and grp.x is None:
            raise ValueError("gemm_dwgrad: a mask reads the group's input")
        if grp.colsum is not None and (
                grp.colsum.shape != (K,) or grp.colsum.dtype != _F32
                or not grp.colsum.is_contiguous()):
            raise ValueError(f"gemm_dwgrad: column sums are contiguous f32 "
                             f"({K},)")
        if grp.dw is not None and (grp.x is None or grp.dw.shape != (K, N)
                                   or grp.dw.dtype != _F32
                                   or not grp.dw.is_contiguous()):
            raise ValueError(f"gemm_dwgrad: a weight gradient reads the "
                             f"group's input into a contiguous f32 ({K}, {N})")
    x0, K0 = groups[0].x, groups[0].w.shape[0]
    if (gsig is None) != (wd is None) or (gsig is not None and (
            gsig.dtype != _F32 or gsig.shape != (M,) or wd.dtype != _BF
            or wd.shape != (K0,) or not wd.is_contiguous())):
        raise ValueError("gemm_dwgrad: the rank-1 term is f32 gsig (M,) with "
                         f"contiguous bf16 wd ({K0},)")
    if dwd is not None and (gsig is None or x0 is None or dwd.shape != (K0, 1)
                            or dwd.dtype != _F32 or not dwd.is_contiguous()):
        raise ValueError("gemm_dwgrad: the rank-1 weight gradient reads gsig "
                         f"and the first group's input into f32 ({K0}, 1)")


def dwgrad_args(g, groups, split, partials=None, gsig=None, wd=None):
    """The arguments of one :func:`gemm_dwgrad` launch (csrc/mlp_fused_bwd.cu
    ``nnt_mlp_fused_bwd``): (the 7 tensor-map tuples of :func:`tma_2d`: g
    and the groups' inputs (box rows 128), weight rows (64) and outputs (64),
    :data:`_NO_MAP` for an absent one; the 5 pointers: the dW, column-sum
    and rank-1 partials, gsig and wd, None for an absent one; the 14 ints:
    N, M, splits, tiles per split, gsig's row stride, the rows of a split's
    dW partial, then per group its width, f32 output, mask and weight
    gradient (zeros for no second group)). ``split`` is
    :func:`dwgrad_split`'s pair; ``partials`` the dict of the partial
    tensors ("dw", "colsum", "rowdot", any may be None)."""
    M, N = g.shape
    partials = partials or {}
    two = list(groups) + [None] * (2 - len(groups))
    xs = [_NO_MAP if grp is None or grp.x is None
          else tma_2d(grp.x, FUSED_BWD_TILE) for grp in two]
    ws = [_NO_MAP if grp is None else tma_2d(grp.w, FUSED_BWD_SLICE)
          for grp in two]
    outs = [_NO_MAP if grp is None else tma_2d(grp.out, GEMM_STORE_ROWS)
            for grp in two]
    maps = [tma_2d(g, FUSED_BWD_TILE), *xs, *ws, *outs]
    ptrs = [partials.get("dw"), partials.get("colsum"), partials.get("rowdot"),
            gsig, wd]
    ints = [N, M, split[1], split[0],
            gsig.stride(0) if gsig is not None else 0,
            sum(grp.w.shape[0] for grp in groups)]
    for grp in two:
        ints += ([0, 0, 0, 0] if grp is None else
                 [grp.w.shape[0], int(grp.out.dtype == _F32), int(grp.mask),
                  int(grp.dw is not None)])
    return maps, ptrs, ints


def gemm_dwgrad(g, groups, gsig=None, wd=None, dwd=None, sums=None):
    """One layer's backward pass on the fused kernel (csrc/mlp_fused_bwd.cu),
    counted in :data:`MLP_FUSED_BWD_LAUNCHES`: from its masked bf16
    cotangent g (M, N), for each :class:`DwGroup` of its input's columns the
    input gradient out = mask(g @ w^T [+ bf16(gsig) wd^T]) (rounded to the
    output's type), and where asked the column sums (``colsum``) and the
    weight gradient x^T g (``dw``); with ``dwd`` (K0, 1) also the first
    group's x^T bf16(gsig) (fc_density's weight gradient, from fc_feature's
    pass). g and each group's input are read once.

    The weight and bias gradients are split partial sums: with ``sums`` (a
    :class:`SplitSums`) they are added there, at the end of the backward,
    else by one launch before returning. A group without ``dw`` runs the
    input gradient alone: the same values either way. CPU tensors run
    :func:`gemm_dwgrad_reference`; on the card an operand the kernel cannot
    take raises."""
    M, N = g.shape
    if _device("gemm_dwgrad", g) == "cpu":
        for i, grp in enumerate(groups):
            rank1 = i == 0 and gsig is not None
            y, dw = gemm_dwgrad_reference(
                g.float(), grp.w.float(),
                None if grp.dw is None else grp.x.float(),
                grp.x.float() if grp.mask else None,
                gsig if rank1 else None, wd.float() if rank1 else None)
            grp.out.copy_(y)
            if grp.colsum is not None:
                grp.colsum.copy_(y.sum(0))
            if dw is not None:
                grp.dw.copy_(dw)
        if dwd is not None:
            dwd.copy_(gemm_wgrad_reference(groups[0].x.float(),
                                           gsig.reshape(-1, 1)))
        return
    _check_dwgrad(g, groups, gsig, wd, dwd)
    if M == 0:
        for t in (dwd, *(x for grp in groups for x in (grp.colsum, grp.dw))):
            if t is not None:
                t.zero_()
        return
    slices = sum(-(-grp.w.shape[0] // FUSED_BWD_SLICE) for grp in groups)
    split = dwgrad_split(M, slices, _sm_count(g.device))
    splits = split[1]
    K = [grp.w.shape[0] for grp in groups]
    f32 = dict(dtype=_F32, device=g.device)
    partials = {}
    if any(grp.dw is not None for grp in groups):
        partials["dw"] = torch.empty((splits, sum(K), N), **f32)
    if groups[0].colsum is not None:
        partials["colsum"] = torch.empty((splits, K[0]), **f32)
    if dwd is not None:
        partials["rowdot"] = torch.empty((splits, K[0]), **f32)
    maps, ptrs, ints = dwgrad_args(g, groups, split, partials, gsig, wd)
    specs = (ctypes.c_int64 * (6 * len(maps)))(
        *[int(v or 0) for m in maps for v in m])
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    int_arr = (ctypes.c_int * len(ints))(*ints)
    err = c_function("nnt_mlp_fused_bwd", "pppp")(
        ctypes.addressof(specs), ctypes.addressof(ptr_arr),
        ctypes.addressof(int_arr), _stream(g))
    check(err, "mlp_fused_bwd")
    MLP_FUSED_BWD_LAUNCHES.add()
    own = sums is None
    sums = SplitSums() if own else sums
    row = 0
    for grp, k in zip(groups, K):
        if grp.dw is not None:
            sums.add(partials["dw"][:, row:], grp.dw, splits, sum(K) * N)
        row += k
    if groups[0].colsum is not None:
        sums.add(partials["colsum"], groups[0].colsum, splits, K[0])
    if dwd is not None:
        sums.add(partials["rowdot"], dwd, splits, K[0])
    if own:
        sums.run()


def heads_rows_per_block(m, sms):
    """Rows per block of :func:`heads_bwd_fused`: about four blocks per SM,
    a multiple of 64."""
    return max(64, -(-m // (4 * sms * 64)) * 64)


def heads_bwd_fused(g_raw, hr, wc, out, b_rgb=None, dw_rgb=None,
                    b_heads=None, sums=None):
    """The rgb head's backward with the heads' weight-gradient work folded
    in (csrc/mlp_fused_bwd.cu heads_bwd_fused_kernel): out (M, H2) bf16 =
    relu_mask(hr) * (bf16(g_raw[:, 1:4]) @ wc^T) as :func:`heads_bwd`, and
    with the three f32 outputs: ``b_rgb`` (H2,) its column sums before the
    rounding (rgb_layer's bias gradient), ``dw_rgb`` (H2, 3) = hr^T
    bf16(g_raw[:, 1:4]) (fc_rgb's), ``b_heads`` (4,) = g_raw's column sums
    (fc_density's and fc_rgb's biases): split partial sums added by
    ``sums`` (:class:`SplitSums`) or, without it, before returning. CPU
    tensors run the plain versions."""
    M, H2 = hr.shape
    wgrad = b_rgb is not None
    if _device("heads_bwd_fused", g_raw) == "cpu":
        y = heads_bwd_reference(g_raw, hr.float(), wc.float())
        out.copy_(y)
        if wgrad:
            b_rgb.copy_(y.sum(0))
            dw_rgb.copy_(gemm_wgrad_reference(hr.float(), g_raw[:, 1:]))
            b_heads.copy_(g_raw.sum(0))
        return out
    if (b_rgb is None) != (dw_rgb is None) or (b_rgb is None) != (
            b_heads is None):
        raise ValueError("heads_bwd_fused: the three weight-gradient outputs "
                         "come together")
    if out.dtype != _BF or out.shape != (M, H2) or hr.dtype != _BF \
            or hr.stride(1) != 1 or out.stride(1) != 1 \
            or not g_raw.is_contiguous() or g_raw.shape != (M, 4) \
            or wc.shape != (H2, 3) or wc.dtype != _BF \
            or not wc.is_contiguous():
        raise ValueError("heads_bwd_fused: contiguous f32 g_raw (M, 4), "
                         "row-major bf16 hr and out (M, H2), bf16 wc (H2, 3)")
    if wgrad and any(t.dtype != _F32 or not t.is_contiguous() or t.shape != s
                     for t, s in ((b_rgb, (H2,)), (dw_rgb, (H2, 3)),
                                  (b_heads, (4,)))):
        raise ValueError("heads_bwd_fused: contiguous f32 outputs (H2,), "
                         "(H2, 3), (4,)")
    rows = heads_rows_per_block(M, _sm_count(out.device))
    blocks = -(-M // rows)
    parts = ([torch.empty((blocks, n), dtype=_F32, device=out.device)
              for n in (H2, 3 * H2, 4)] if wgrad else [None] * 3)
    err = c_function("nnt_heads_bwd_fused", "ppippiiiipppp")(
        _ptr(g_raw), _ptr(hr), hr.stride(0), _ptr(wc), _ptr(out),
        out.stride(0), M, H2, rows, *[None if p is None else _ptr(p)
                                      for p in parts], _stream(out))
    check(err, "heads_bwd_fused")
    if wgrad and M:
        own = sums is None
        sums = SplitSums() if own else sums
        for p, o in zip(parts, (b_rgb, dw_rgb, b_heads)):
            sums.add(p, o, blocks, p.shape[1])
        if own:
            sums.run()
    elif wgrad:
        for t in (b_rgb, dw_rgb, b_heads):
            t.zero_()
    return out


def _chain_bwd(Wb, Wh, g_raw, enc, denc, denc_div, feat, hr, acts, M, dims,
               weight_grads=True):
    """Backward of :func:`_chain_fwd` from the cotangents of the raw heads,
    g_raw (M, 4) f32 = [sigma, rgb]: the rgb head's backward
    (:func:`heads_bwd_fused`), then one fused pass per layer
    (:func:`gemm_dwgrad`, ten in all) from rgb_layer ([feat | denc]) and
    fc_feature (with fc_density's rank-1 term and weight gradient) down the
    trunk (trunk1_0 as [a03 | enc]) to trunk0_0, each reading its cotangent
    and its saved input once for both its input gradient and its weight
    gradient; Kernel A's per-ray direction half of rgb_layer's weight
    gradient on :func:`dir_weight_grad`; the split partial sums of every
    weight and bias gradient added in one launch at the end
    (:class:`SplitSums`).

    Every cotangent that a matmul reads is stored bf16, after its ReLU mask:
    the rounding the plain version (and the TPU kernel) applies where it
    enters the matmul, and rounding commutes with the mask. Each bias
    gradient is the f32 column sum of a masked cotangent before rounding;
    the encodings' cotangents stay f32.

    Returns (the 24 weight and bias gradients in kernel order, or 24 Nones
    without ``weight_grads``; the cotangent of the position encoding as two
    f32 (M, n_pos) summands; that of the direction encoding, f32 (M, n_dir),
    per point). Without ``weight_grads`` the same passes run with their
    weight-gradient half off, so the input cotangents are bitwise equal
    either way. Runs on CPU tensors too (every step's plain version)."""
    n_pos, n_dir, D, H2 = dims
    dev = g_raw.device
    wg = weight_grads

    def buf(width, dtype=_BF):
        # rows padded to 16 bytes, as TMA needs; the view has the true width
        return torch.empty((M, _pad8(width)), dtype=dtype, device=dev)[:, :width]

    def new(*shape):
        return torch.empty(shape, dtype=_F32, device=dev) if wg else None

    dw = {n: new(*W[n].shape) for W, names in ((Wb, GEMM_LAYERS),
                                               (Wh, HEAD_LAYERS))
          for n in names}
    b = {n: new(Wb[n].shape[1]) for n in GEMM_LAYERS}
    heads_b = new(4)  # [fc_density, fc_rgb]
    sums = SplitSums()
    g_hr = heads_bwd_fused(g_raw, hr, Wh["fc_rgb"], buf(H2), b["rgb_layer"],
                           dw["fc_rgb"], heads_b, sums)
    wr = Wb["rgb_layer"]
    g_feat, g_denc = buf(D), buf(n_dir, _F32)
    per_point = denc_div == 1
    dw_r = (None,) * 2 if not wg else (dw["rgb_layer"][:D], dw["rgb_layer"][D:])
    gemm_dwgrad(g_hr, (
        DwGroup(wr[:D], g_feat, x=feat if wg else None,
                colsum=b["fc_feature"], dw=dw_r[0]),
        DwGroup(wr[D:D + n_dir], g_denc,
                x=denc[:, :n_dir] if wg and per_point else None,
                dw=dw_r[1] if per_point else None)), sums=sums)
    if wg and not per_point:
        dir_weight_grad(denc[:, :n_dir], g_hr, denc_div, dw_r[1])
    # g[name]: the masked cotangent of a trunk layer's output
    g = {"trunk1_3": buf(D)}
    gemm_dwgrad(g_feat, (DwGroup(Wb["fc_feature"], g["trunk1_3"], x=acts[7],
                                 mask=True, colsum=b["trunk1_3"],
                                 dw=dw["fc_feature"]),),
                gsig=g_raw[:, 0], wd=Wh["fc_density"].reshape(-1),
                dwd=dw["fc_density"], sums=sums)
    pos = enc[:, :n_pos]
    for name in ("trunk1_3", "trunk1_2", "trunk1_1", "trunk1_0",
                 "trunk0_3", "trunk0_2", "trunk0_1", "trunk0_0"):
        stack, j = int(name[5]), int(name[-1])
        if j:  # its input is the layer below's output, masked by its ReLU
            lower = f"trunk{stack}_{j - 1}"
            g[lower] = buf(D)
            groups = [DwGroup(Wb[name], g[lower], x=acts[4 * stack + j - 1],
                              mask=True, colsum=b[lower], dw=dw[name])]
        elif stack:  # trunk1_0: [a03 | enc]
            g["trunk0_3"], g_enc_skip = buf(D), buf(n_pos, _F32)
            w10 = Wb[name]
            groups = [DwGroup(w10[:D], g["trunk0_3"], x=acts[3], mask=True,
                              colsum=b["trunk0_3"],
                              dw=dw[name][:D] if wg else None),
                      DwGroup(w10[D:D + n_pos], g_enc_skip,
                              x=pos if wg else None,
                              dw=dw[name][D:] if wg else None)]
        else:  # trunk0_0: enc
            g_enc = buf(n_pos, _F32)
            groups = [DwGroup(Wb[name], g_enc, x=pos if wg else None,
                              dw=dw[name])]
        gemm_dwgrad(g[name], groups, sums=sums)
    sums.run()
    enc_cots = (g_enc_skip, g_enc)
    if not wg:
        return [None] * (2 * len(W_NAMES)), enc_cots, g_denc
    b["fc_density"], b["fc_rgb"] = heads_b[:1], heads_b[1:]
    d_weights = [t for name in W_NAMES
                 for t in (dw[name], b[name].reshape(1, -1))]
    return d_weights, enc_cots, g_denc


def _chain_bwd_layered(Wb, Wh, g_raw, enc, denc, denc_div, feat, hr, acts,
                       M, dims, weight_grads=True):
    """The layer-by-layer backward that :func:`_chain_bwd` replaced: the
    same contract, on about 55 launches. No path runs it; chip_smoke.py
    holds the fused backward to it and times the two in turns.

    Every cotangent that a matmul reads is stored bf16, after its ReLU mask:
    the rounding the plain version (and the TPU kernel) applies where it
    enters the matmul, and rounding commutes with the mask. Each bias
    gradient is the f32 column sum of a masked cotangent before rounding,
    taken in the epilogue that produces it; the encodings' cotangents stay
    f32. The twelve input-gradient GEMMs run on :func:`gemm_dgrad`: the
    direction half of rgb_layer and its feature half, fc_feature with
    fc_density's rank-1 term, the trunk (trunk1_0 as its activation half and
    its encoding half) down to trunk0_0.

    Returns (the 24 weight and bias gradients in kernel order, or 24 Nones
    without ``weight_grads``; the cotangent of the position encoding as two
    f32 (M, n_pos) summands; that of the direction encoding, f32 (M, n_dir),
    per point). Without ``weight_grads`` the same GEMMs run without their
    column sums, so the input cotangents are bitwise equal either way. Runs
    on CPU tensors too (every step's plain version)."""
    n_pos, n_dir, D, H2 = dims
    dev = g_raw.device
    sums = weight_grads

    def buf(width, dtype=_BF):
        # rows padded to 16 bytes, as TMA needs; the view has the true width
        return torch.empty((M, _pad8(width)), dtype=dtype, device=dev)[:, :width]

    b = {}  # bias gradients
    g_hr, b["rgb_layer"] = heads_bwd(g_raw, hr, Wh["fc_rgb"], buf(H2), sums)
    wr = Wb["rgb_layer"]
    g_feat, b["fc_feature"] = gemm_dgrad(g_hr, wr[:D], buf(D), colsum=sums)
    g_denc, _ = gemm_dgrad(g_hr, wr[D:D + n_dir], buf(n_dir, _F32))
    a13 = acts[7]
    # g[name]: the masked cotangent of a trunk layer's output
    g = {}
    g["trunk1_3"], b["trunk1_3"] = gemm_dgrad(
        g_feat, Wb["fc_feature"], buf(D), mask=a13, gsig=g_raw[:, 0],
        wd=Wh["fc_density"].reshape(-1), colsum=sums)
    for j in (3, 2, 1):
        lower = f"trunk1_{j - 1}"
        g[lower], b[lower] = gemm_dgrad(g[f"trunk1_{j}"], Wb[f"trunk1_{j}"],
                                        buf(D), mask=acts[4 + j - 1],
                                        colsum=sums)
    w10 = Wb["trunk1_0"]  # its input is [a03, enc]
    g["trunk0_3"], b["trunk0_3"] = gemm_dgrad(
        g["trunk1_0"], w10[:D], buf(D), mask=acts[3], colsum=sums)
    g_enc_skip, _ = gemm_dgrad(g["trunk1_0"], w10[D:D + n_pos],
                               buf(n_pos, _F32))
    for j in (3, 2, 1):
        lower = f"trunk0_{j - 1}"
        g[lower], b[lower] = gemm_dgrad(g[f"trunk0_{j}"], Wb[f"trunk0_{j}"],
                                        buf(D), mask=acts[j - 1], colsum=sums)
    g_enc, _ = gemm_dgrad(g["trunk0_0"], Wb["trunk0_0"], buf(n_pos, _F32))
    enc_cots = (g_enc_skip, g_enc)
    if not weight_grads:
        return [None] * (2 * len(W_NAMES)), enc_cots, g_denc

    pos = enc[:, :n_pos]
    heads_b = _bias_grad(g_raw)  # [fc_density, fc_rgb]
    b["fc_density"], b["fc_rgb"] = heads_b[0, :1], heads_b[0, 1:]
    dw = {"fc_rgb": head_weight_grad(hr, g_raw[:, 1:]),
          "fc_density": head_weight_grad(a13, g_raw[:, :1])}
    dw["rgb_layer"] = torch.empty((D + n_dir, H2), dtype=_F32, device=dev)
    gemm_wgrad(feat, g_hr, dw["rgb_layer"][:D])
    if denc_div == 1:
        gemm_wgrad(denc[:, :n_dir], g_hr, dw["rgb_layer"][D:])
    else:
        dir_weight_grad(denc[:, :n_dir], g_hr, denc_div, dw["rgb_layer"][D:])
    dw["fc_feature"] = gemm_wgrad(a13, g_feat)
    for j in (3, 2, 1):
        dw[f"trunk1_{j}"] = gemm_wgrad(acts[4 + j - 1], g[f"trunk1_{j}"])
    dw["trunk1_0"] = torch.empty((D + n_pos, D), dtype=_F32, device=dev)
    gemm_wgrad(acts[3], g["trunk1_0"], dw["trunk1_0"][:D])
    gemm_wgrad(pos, g["trunk1_0"], dw["trunk1_0"][D:])
    for j in (3, 2, 1):
        dw[f"trunk0_{j}"] = gemm_wgrad(acts[j - 1], g[f"trunk0_{j}"])
    dw["trunk0_0"] = gemm_wgrad(pos, g["trunk0_0"])
    d_weights = [t for name in W_NAMES
                 for t in (dw[name], b[name].reshape(1, -1))]
    return d_weights, enc_cots, g_denc


def _weight_list(Wb, Wh):
    """The kernel weights a backward reads, as saved tensors."""
    return [Wb[n] for n in GEMM_LAYERS] + [Wh[n] for n in HEAD_LAYERS]


def _weight_dicts(saved):
    """Inverse of :func:`_weight_list`: (Wb, Wh)."""
    n = len(GEMM_LAYERS)
    return (dict(zip(GEMM_LAYERS, saved[:n])),
            dict(zip(HEAD_LAYERS, saved[n:])))


def _cotangent(g, shape, dev):
    if g is None:
        return torch.zeros(shape, dtype=_F32, device=dev)
    return g.to(_F32).contiguous()


# composite_bwd's points a block (its rays: COMPOSITE_BWD_POINTS // S, at
# least 1) and the shared memory a block may take (the H100's opt-in limit)
COMPOSITE_BWD_POINTS = 512
SMEM_LIMIT = 227 * 1024


def _composite_bwd_args(raw, z, deltas, g_rgbv, g_dist, g_alpha, name):
    """Checks of the compositing backward's operands: (N, S)."""
    N, S = z.shape
    want = {"raw": (N * S, 4), "deltas": (N, S), "g_rgbv": (N, 3),
            "g_dist": (N, 1), "g_alpha": (N, S)}
    for key, t in zip(want, (raw, deltas, g_rgbv, g_dist, g_alpha)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{want[key]} for z {(N, S)}")
    tensors = (raw, z, deltas, g_rgbv, g_dist, g_alpha)
    if any(t.device != z.device or t.dtype != _F32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous f32 on "
                         f"{z.device}")
    return N, S


def composite_bwd(raw, z, deltas, g_rgbv, g_dist, g_alpha, flags):
    """Kernel A's compositing and head-activation backward: the cotangents
    of the raw heads, g_raw (M, 4) f32 = [sigma, rgb], from those of
    rgb_values (N, 3), dist (N, 1) and alpha (N, S), given the raw heads
    (M = N * S, 4) and the (N, S) z and deltas; ``flags`` (softplus,
    occ_alpha, dist_alpha, white_bg). CUDA tensors launch
    ``composite_bwd_group`` (csrc/mlp_composite.cu: a block per group of
    whole rays; counted in :data:`COMPOSITE_BWD_LAUNCHES`), bitwise equal
    to the one-thread-per-ray kernel it replaced
    (:func:`_composite_bwd_per_ray`); CPU tensors run
    :func:`composite_bwd_reference`. Raises on a shape the kernel cannot
    take."""
    if z.device.type == "cpu":
        return composite_bwd_reference(raw, z, deltas, g_rgbv, g_dist,
                                       g_alpha, flags)
    _device("composite_bwd", z)
    N, S = _composite_bwd_args(raw, z, deltas, g_rgbv, g_dist, g_alpha,
                               "composite_bwd")
    rays = max(1, COMPOSITE_BWD_POINTS // S)
    if 16 * ((S | 1) + 1) > SMEM_LIMIT:
        raise ValueError(f"composite_bwd: {S} samples a ray; a ray's four "
                         f"arrays must fit {SMEM_LIMIT} bytes of shared "
                         "memory")
    g_raw = torch.empty((N * S, 4), dtype=_F32, device=z.device)
    if N:
        err = c_function("nnt_composite_bwd_group", "pppppppiiiiiiip")(
            _ptr(raw), _ptr(z), _ptr(deltas), _ptr(g_rgbv), _ptr(g_dist),
            _ptr(g_alpha), _ptr(g_raw), N, S, rays,
            *(int(bool(f)) for f in flags), _stream(z))
        check(err, "composite_bwd")
        COMPOSITE_BWD_LAUNCHES.add()
    return g_raw


def _composite_bwd_per_ray(raw, z, deltas, g_rgbv, g_dist, g_alpha, flags):
    """The compositing backward :func:`composite_bwd` replaced, one thread
    per ray through a global scratch buffer (4 x S x N f32); the same
    contract, CUDA tensors only (counted in
    :data:`COMPOSITE_BWD_PER_RAY_LAUNCHES`). No path runs it;
    chip_smoke.py holds the new kernel to it bit for bit and times the two
    in turns."""
    if z.device.type != "cuda":
        raise ValueError("composite_bwd_per_ray: CUDA tensors only")
    N, S = _composite_bwd_args(raw, z, deltas, g_rgbv, g_dist, g_alpha,
                               "composite_bwd_per_ray")
    g_raw = torch.empty((N * S, 4), dtype=_F32, device=z.device)
    scratch = torch.empty((4, S, N), dtype=_F32, device=z.device)
    err = c_function("nnt_composite_bwd", "ppppppppiiiiiip")(
        _ptr(raw), _ptr(z), _ptr(deltas), _ptr(g_rgbv), _ptr(g_dist),
        _ptr(g_alpha), _ptr(scratch), _ptr(g_raw), N, S,
        *(int(bool(f)) for f in flags), _stream(z))
    check(err, "composite_bwd_per_ray")
    COMPOSITE_BWD_PER_RAY_LAUNCHES.add()
    return g_raw


# the direction encoding's widest cotangent the encoding backward takes
MAX_ENC = 3 * (2 * 16 + 1)
# the warps of encode_bwd_staged's block, one block a ray
ENCODE_BWD_WARPS = 2


def _encode_bwd_args(origins, rays, dirs, z, ge1, ge2, gd, l_pos, l_dir,
                     name):
    """Checks of the encoding backward's operands: (N, S, n_pos, n_dir)."""
    N, S = z.shape
    n_pos, n_dir = 3 * (2 * l_pos + 1), 3 * (2 * l_dir + 1)
    if min(l_pos, l_dir) < 0 or n_dir > MAX_ENC:
        raise ValueError(f"{name}: levels {l_pos} / {l_dir}; the direction "
                         f"encoding may be at most {MAX_ENC} wide")
    for key, t in (("origins", origins), ("rays", rays), ("dirs", dirs)):
        if tuple(t.shape) != (N, 3) or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous ({N}, 3)")
    if not z.is_contiguous():
        raise ValueError(f"{name}: z must be contiguous")
    for key, t, k in (("ge1", ge1, n_pos), ("ge2", ge2, n_pos),
                      ("gd", gd, n_dir)):
        if t.shape[0] != N * S or t.shape[1] < k or t.stride(1) != 1:
            raise ValueError(f"{name}: {key} must be ({N * S}, >= {k}) with "
                             "unit column stride")
    if any(t.device != z.device or t.dtype != _F32
           for t in (origins, rays, dirs, z, ge1, ge2, gd)):
        raise ValueError(f"{name}: operands must be f32 on {z.device}")
    return N, S, n_pos, n_dir


def encode_bwd(origins, rays, dirs, z, ge1, ge2, gd, l_pos, l_dir):
    """Kernel A's encoding backward with the ray sums: the cotangent of the
    position encoding of the points o + r z as two f32 summands ge1, ge2
    (M, >= n_pos) and that of the direction encoding per point, gd (M, >=
    n_dir) -> (d_origins, d_rays, d_dirs), each (N, 3) f32. CUDA tensors
    launch ``encode_bwd_staged`` (csrc/mlp_composite.cu: a block of two
    warps per ray, the rows staged through shared memory with coalesced
    loads, the sums in the old lanes' order; counted in
    :data:`ENCODE_BWD_LAUNCHES`), bitwise equal to the kernel it replaced
    (:func:`_encode_bwd_per_ray`); it reads ge1 and ge2 as float4 up to
    their padding, so their base must be 16-byte aligned and their row
    strides multiples of 4 columns covering ceil(n_pos / 4) * 4. CPU
    tensors run :func:`encode_bwd_reference`. Raises on what the kernel
    cannot take."""
    if z.device.type == "cpu":
        return encode_bwd_reference(origins, rays, dirs, z, ge1, ge2, gd,
                                    l_pos, l_dir)
    _device("encode_bwd", z)
    N, S, n_pos, n_dir = _encode_bwd_args(origins, rays, dirs, z, ge1, ge2,
                                          gd, l_pos, l_dir, "encode_bwd")
    row = -(-n_pos // 4) * 4
    for key, t in (("ge1", ge1), ("ge2", ge2)):
        end = (t.storage_offset() + (t.shape[0] - 1) * t.stride(0) + row) * 4
        if (t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(0) < row
                or end > t.untyped_storage().nbytes()):
            raise ValueError(f"encode_bwd: {key} must be 16-byte aligned, "
                             f"its row stride a multiple of 4 and at least "
                             f"{row}, and its storage hold the last row's "
                             f"{row} columns")
    smem = 4 * (ENCODE_BWD_WARPS * 32 * (row + 4) + 33 * n_dir)
    if smem > SMEM_LIMIT:
        raise ValueError(f"encode_bwd: {n_pos} position channels need "
                         f"{smem} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    outs = [torch.empty((N, 3), dtype=_F32, device=z.device)
            for _ in range(3)]
    if N:
        err = c_function("nnt_encode_bwd_staged", "ppppp" "ipipi" "pppiiiip")(
            _ptr(origins), _ptr(rays), _ptr(dirs), _ptr(z),
            _ptr(ge1), ge1.stride(0), _ptr(ge2), ge2.stride(0), _ptr(gd),
            gd.stride(0), *(_ptr(t) for t in outs), N, S, l_pos, l_dir,
            _stream(z))
        check(err, "encode_bwd")
        ENCODE_BWD_LAUNCHES.add()
    return tuple(outs)


def _encode_bwd_per_ray(origins, rays, dirs, z, ge1, ge2, gd, l_pos, l_dir):
    """The encoding backward :func:`encode_bwd` replaced, one warp per ray
    whose lanes read whole rows alone; the same contract, CUDA tensors only
    (counted in :data:`ENCODE_BWD_PER_RAY_LAUNCHES`). No path runs it;
    chip_smoke.py holds the new kernel to it bit for bit and times the two
    in turns."""
    if z.device.type != "cuda":
        raise ValueError("encode_bwd_per_ray: CUDA tensors only")
    N, S, _, _ = _encode_bwd_args(origins, rays, dirs, z, ge1, ge2, gd,
                                  l_pos, l_dir, "encode_bwd_per_ray")
    outs = [torch.empty((N, 3), dtype=_F32, device=z.device)
            for _ in range(3)]
    err = c_function("nnt_encode_bwd", "ppppp" "ipipi" "pppiiiip")(
        _ptr(origins), _ptr(rays), _ptr(dirs), _ptr(z),
        _ptr(ge1), ge1.stride(0), _ptr(ge2), ge2.stride(0), _ptr(gd),
        gd.stride(0), *(_ptr(t) for t in outs), N, S, l_pos, l_dir,
        _stream(z))
    check(err, "encode_bwd_per_ray")
    ENCODE_BWD_PER_RAY_LAUNCHES.add()
    return tuple(outs)


def _composite_fwd(origins, rays, dirs, z, deltas, cfg, weights, save):
    """Kernel A's forward: one fused launch (:func:`fused_fwd`), and on the
    raw route (:func:`fused_route`) composite_fwd after it. Returns
    (rgbv, dist, alpha), the widths, and with ``save`` the tensors its
    backward reads (None without)."""
    l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S = cfg
    dims = _dims(weights, l_pos, l_dir)
    N = origins.shape[0]
    M = N * S
    dev = origins.device
    Wt, Wb, Wh, Bs = _kernel_weights(weights, save)
    route = fused_route(S)
    sv = fused_fwd_saves(M, N, dims, dev) if save else None
    raw = (sv["raw"] if save else
           torch.empty((M, 4), dtype=_F32, device=dev) if route == "raw"
           else None)
    rgbv = torch.empty((N, 3), dtype=_F32, device=dev)
    dist = torch.empty((N, 1), dtype=_F32, device=dev)
    alpha = torch.empty((N, S), dtype=_F32, device=dev)
    flags = (act == "softplus", occ_alpha, dist_alpha, white_bg)
    fused_fwd(Wt, Wh, Bs, dims, MODE_COMPOSITE if route == "fused"
              else MODE_RAW, (l_pos, l_dir), S,
              (origins, rays, dirs, z, deltas),
              (rgbv, dist, alpha) if route == "fused" else (None,) * 3,
              flags, sv, raw)
    if route == "raw" and N:
        err = c_function("nnt_composite_fwd", "ppppppiiiiiip")(
            _ptr(raw), _ptr(z), _ptr(deltas), _ptr(rgbv), _ptr(dist),
            _ptr(alpha), N, S, *(int(f) for f in flags), _stream(origins))
        check(err, "composite_fwd")
        COMPOSITE_AFTER_LAUNCHES.add()
    FWD_LAUNCHES.add()
    saved = ((origins, rays, dirs, z, deltas, sv["enc"], sv["denc"],
              sv["feat"], sv["hr"], sv["raw"], *sv["acts"],
              *_weight_list(Wb, Wh)) if save else None)
    return (rgbv, dist, alpha), dims, saved


def _composite_fwd_layered(origins, rays, dirs, z, deltas, cfg, weights,
                           save):
    """The layer-by-layer forward of Kernel A that :func:`_composite_fwd`
    replaced (encode_fwd, :func:`_chain_fwd`, composite_fwd; no launch
    counter of its own): (rgbv, dist, alpha) and, with ``save``, the
    tensors its backward reads. No path runs it; chip_smoke.py holds the
    fused forward to it."""
    l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S = cfg
    dims = _dims(weights, l_pos, l_dir)
    n_pos, n_dir = dims[:2]
    N = origins.shape[0]
    M = N * S
    dev = origins.device
    Wt, Wb, Wh, Bs = _kernel_weights(weights, save)
    stream = _stream(origins)

    enc = torch.empty((M, _pad8(n_pos)), dtype=_BF, device=dev)
    denc = torch.empty((N, _pad8(n_dir)), dtype=_BF, device=dev)
    err = c_function("nnt_encode_fwd", "pppppipiiiiip")(
        _ptr(origins), _ptr(rays), _ptr(dirs), _ptr(z), _ptr(enc),
        enc.shape[1], _ptr(denc), denc.shape[1], N, S, l_pos, l_dir,
        stream)
    check(err, "encode_fwd")
    acts, feat, hr, raw = _chain_fwd(Wt, Wh, Bs, enc, denc, S, M, dims,
                                     save)
    rgbv = torch.empty((N, 3), dtype=_F32, device=dev)
    dist = torch.empty((N, 1), dtype=_F32, device=dev)
    alpha = torch.empty((N, S), dtype=_F32, device=dev)
    err = c_function("nnt_composite_fwd", "ppppppiiiiiip")(
        _ptr(raw), _ptr(z), _ptr(deltas), _ptr(rgbv), _ptr(dist),
        _ptr(alpha), N, S, int(act == "softplus"), int(occ_alpha),
        int(dist_alpha), int(white_bg), stream)
    check(err, "composite_fwd")
    saved = ((origins, rays, dirs, z, deltas, enc, denc, feat, hr, raw,
              *acts, *_weight_list(Wb, Wh)) if save else None)
    return (rgbv, dist, alpha), dims, saved


class FusedMLPComposite(torch.autograd.Function):
    """CUDA forward/backward of :func:`fused_mlp_composite` (Kernel A).
    ``cfg`` is (l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S).
    The backward computes the weight gradients only when a weight needs
    one (test-time pose optimisation needs only d_origins / d_rays /
    d_dirs). Inside a traced step the backward is the section
    ``step.backward.field`` (``tracing.py``), after which ``step.backward``
    resumes."""

    @staticmethod
    def forward(ctx, origins, rays, dirs, z, deltas, cfg, *weights):
        outs, dims, saved = _composite_fwd(origins, rays, dirs, z, deltas,
                                           cfg, weights, save=True)
        ctx.cfg = cfg
        ctx.dims = dims
        ctx.save_for_backward(*saved)
        return outs

    @staticmethod
    def backward(ctx, g_rgbv, g_dist, g_alpha):
        tracing.section("step.backward.field")
        l_pos, l_dir, act, occ_alpha, dist_alpha, white_bg, S = ctx.cfg
        saved = ctx.saved_tensors
        origins, rays, dirs, z, deltas, enc, denc, feat, hr, raw = saved[:10]
        acts = saved[10:18]
        Wb, Wh = _weight_dicts(saved[18:])
        N = origins.shape[0]
        M = N * S
        dev = origins.device
        g_rgbv = _cotangent(g_rgbv, (N, 3), dev)
        g_dist = _cotangent(g_dist, (N, 1), dev)
        g_alpha = _cotangent(g_alpha, (N, S), dev)

        # compositing + head activations -> cotangents of the raw heads
        g_raw = composite_bwd(raw, z, deltas, g_rgbv, g_dist, g_alpha,
                              (act == "softplus", occ_alpha, dist_alpha,
                               white_bg))
        d_weights, (ge1, ge2), gd = _chain_bwd(
            Wb, Wh, g_raw, enc, denc, S, feat, hr, acts, M, ctx.dims,
            weight_grads=any(ctx.needs_input_grad[6:]))
        # encoding backward + ray sums
        d_o, d_r, d_d = encode_bwd(origins, rays, dirs, z, ge1, ge2, gd,
                                   l_pos, l_dir)
        BWD_LAUNCHES.add()
        tracing.section("step.backward")
        return (d_o, d_r, d_d, None, None, None, *d_weights)


def _point_fwd(pts, dirs, cfg, weights, save):
    """Kernel C's forward: one fused launch (:func:`fused_fwd`). Returns
    (rgb, density), the widths, and with ``save`` the tensors its backward
    reads (None without)."""
    l_pos, l_dir, act, occ_alpha = cfg
    dims = _dims(weights, l_pos, l_dir)
    M = pts.shape[0]
    dev = pts.device
    Wt, Wb, Wh, Bs = _kernel_weights(weights, save)
    sv = fused_fwd_saves(M, M, dims, dev) if save else None
    rgb = torch.empty((M, 3), dtype=_F32, device=dev)
    density = torch.empty((M, 1), dtype=_F32, device=dev)
    fused_fwd(Wt, Wh, Bs, dims, MODE_POINTS, (l_pos, l_dir), 1,
              (pts, None, dirs, None, None), (rgb, density, None),
              (act == "softplus", occ_alpha, False, False), sv,
              sv["raw"] if save else None)
    FWD_POINT_LAUNCHES.add()
    saved = ((pts, dirs, sv["enc"], sv["denc"], sv["feat"], sv["hr"],
              sv["raw"], *sv["acts"], *_weight_list(Wb, Wh)) if save
             else None)
    return (rgb, density), dims, saved


def _point_fwd_layered(pts, dirs, cfg, weights, save):
    """The layer-by-layer forward of Kernel C that :func:`_point_fwd`
    replaced (encode_points, :func:`_chain_fwd`, head_act_fwd; no launch
    counter of its own). No path runs it; chip_smoke.py holds the fused
    forward to it."""
    l_pos, l_dir, act, occ_alpha = cfg
    dims = _dims(weights, l_pos, l_dir)
    n_pos, n_dir = dims[:2]
    M = pts.shape[0]
    dev = pts.device
    Wt, Wb, Wh, Bs = _kernel_weights(weights, save)
    stream = _stream(pts)

    encs = []
    for x, levels, n in ((pts, l_pos, n_pos), (dirs, l_dir, n_dir)):
        e = torch.empty((M, _pad8(n)), dtype=_BF, device=dev)
        err = c_function("nnt_encode_points", "ppiiip")(
            _ptr(x), _ptr(e), e.shape[1], M, levels, stream)
        check(err, "encode_points")
        encs.append(e)
    enc, denc = encs
    acts, feat, hr, raw = _chain_fwd(Wt, Wh, Bs, enc, denc, 1, M, dims,
                                     save)
    rgb = torch.empty((M, 3), dtype=_F32, device=dev)
    density = torch.empty((M, 1), dtype=_F32, device=dev)
    err = c_function("nnt_head_act_fwd", "pppiiip")(
        _ptr(raw), _ptr(rgb), _ptr(density), M, int(act == "softplus"),
        int(occ_alpha), stream)
    check(err, "head_act_fwd")
    saved = ((pts, dirs, enc, denc, feat, hr, raw, *acts,
              *_weight_list(Wb, Wh)) if save else None)
    return (rgb, density), dims, saved


class FusedMLP(torch.autograd.Function):
    """CUDA forward/backward of :func:`fused_mlp` (Kernel C). ``cfg`` is
    (l_pos, l_dir, act, occ_alpha). Weight gradients as in
    :class:`FusedMLPComposite`: only when a weight needs one."""

    @staticmethod
    def forward(ctx, pts, dirs, cfg, *weights):
        outs, dims, saved = _point_fwd(pts, dirs, cfg, weights, save=True)
        ctx.cfg = cfg
        ctx.dims = dims
        ctx.save_for_backward(*saved)
        return outs

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        l_pos, l_dir, act, occ_alpha = ctx.cfg
        saved = ctx.saved_tensors
        pts, dirs, enc, denc, feat, hr, raw = saved[:7]
        acts = saved[7:15]
        Wb, Wh = _weight_dicts(saved[15:])
        M = pts.shape[0]
        dev = pts.device
        stream = _stream(pts)
        g_rgb = _cotangent(g_rgb, (M, 3), dev)
        g_density = _cotangent(g_density, (M, 1), dev)

        g_raw = torch.empty((M, 4), dtype=_F32, device=dev)
        err = c_function("nnt_head_act_bwd", "ppppiiip")(
            _ptr(raw), _ptr(g_rgb), _ptr(g_density), _ptr(g_raw), M,
            int(act == "softplus"), int(occ_alpha), stream)
        check(err, "head_act_bwd")
        d_weights, (ge1, ge2), gd = _chain_bwd(
            Wb, Wh, g_raw, enc, denc, 1, feat, hr, acts, M, ctx.dims,
            weight_grads=any(ctx.needs_input_grad[3:]))
        d_pts = torch.empty((M, 3), dtype=_F32, device=dev)
        d_dirs = torch.empty((M, 3), dtype=_F32, device=dev)
        for x, g1, g2, levels, out in ((pts, ge1, ge2, l_pos, d_pts),
                                       (dirs, gd, None, l_dir, d_dirs)):
            err = c_function("nnt_encode_points_bwd", "ppipipiip")(
                _ptr(x), _ptr(g1), g1.stride(0),
                _ptr(g2) if g2 is not None else None,
                g2.stride(0) if g2 is not None else 0, _ptr(out), M, levels,
                stream)
            check(err, "encode_points_bwd")
        BWD_POINT_LAUNCHES.add()
        return (d_pts, d_dirs, None, *d_weights)


def _needs_graph(tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_inputs(name, dev, tensors):
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != _F32:
            raise ValueError(f"{name}: every input must be f32 on {dev}")


def fused_mlp_composite(weights, origins, rays, dirs, z, deltas,
                        l_pos, l_dir, act, occ_alpha, dist_alpha,
                        white_bg, S):
    """Fully fused render (Kernel A): per-RAY inputs (origins/rays/dirs
    (N, 3), z/deltas (N, S)) -> (rgb_values (N, 3), dist_pred (N, 1),
    alpha (N, S)).

    ``weights`` is the 24-tuple of :func:`collect_weights`. CUDA tensors run
    the hand-written kernels; CPU tensors run the plain version."""
    dev = origins.device
    if dev.type == "cpu":
        return fused_mlp_composite_reference(
            weights, origins, rays, dirs, z, deltas, l_pos, l_dir, act,
            occ_alpha, dist_alpha, white_bg, S)
    _check_inputs("fused_mlp_composite", dev,
                  (origins, rays, dirs, z, deltas) + tuple(weights))
    N = origins.shape[0]
    if any(t.shape != (N, 3) for t in (origins, rays, dirs)):
        raise ValueError(f"origins/rays/dirs must be ({N}, 3)")
    if z.shape != (N, S) or deltas.shape != (N, S):
        raise ValueError(f"z/deltas must be ({N}, {S})")
    cfg = (int(l_pos), int(l_dir), act, bool(occ_alpha), bool(dist_alpha),
           bool(white_bg), int(S))
    args = (origins.contiguous(), rays.contiguous(), dirs.contiguous(),
            z.contiguous(), deltas.contiguous())
    if not _needs_graph(args + tuple(weights)):
        # nothing to differentiate (e.g. the eval render): save nothing
        return _composite_fwd(*args, cfg, weights, save=False)[0]
    return FusedMLPComposite.apply(*args, cfg, *weights)


def fused_mlp(weights, pts, dirs, l_pos=10, l_dir=4, act="softplus",
              occ_alpha=False):
    """Per-point fused field (Kernel C): ``weights`` (the 24-tuple of
    :func:`collect_weights`), pts, dirs (M, 3) f32 -> (rgb (M, 3)
    post-sigmoid, density (M, 1) post-activation: softplus or relu, then
    1 - exp(-d) with ``occ_alpha``). Any M; callers pad to :data:`BM` to
    match the reference package's batches. CUDA tensors run the
    hand-written kernels; CPU tensors run the plain version."""
    dev = pts.device
    if dev.type == "cpu":
        return fused_mlp_reference(weights, pts, dirs, l_pos, l_dir, act,
                                   occ_alpha)
    _check_inputs("fused_mlp", dev, (pts, dirs) + tuple(weights))
    M = pts.shape[0]
    if pts.shape != (M, 3) or dirs.shape != (M, 3):
        raise ValueError(f"pts/dirs must be ({M}, 3)")
    cfg = (int(l_pos), int(l_dir), act, bool(occ_alpha))
    args = (pts.contiguous(), dirs.contiguous())
    if not _needs_graph(args + tuple(weights)):
        return _point_fwd(*args, cfg, weights, save=False)[0]
    return FusedMLP.apply(*args, cfg, *weights)
