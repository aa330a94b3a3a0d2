"""The plain MLP chain laid out as Kernels A and C's saving forward lays out
what their backward reads, shared by the CPU tests of the backward
(tests/test_torch_gemm_bwd.py, tests/test_torch_fused_fwd.py,
tests/test_torch_tracing.py) and by the checks on the card that hold the
fused forward's saves to the plain chain (tests/test_torch_cuda.py,
chip_smoke.py). No JAX.
"""
import torch

from nope_nerf_tpu_torch.ops.encoding import encode_position
from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

# the 13 tensors a saving forward stores, in the order of its saved tuple
SAVE_NAMES = ("enc", "denc", "feat", "hr", "raw",
              *(f"trunk_out{i}" for i in range(8)))
# the fused forward's saves against the plain chain's, relL2 a tensor: the
# bf16 activations differ where the kernel's f32 sums, in another order,
# round to the other neighbour, and the flips carry into the layers above.
# On an H100 (700 W) the kernel reads at most 2.61e-4 (the last trunk output
# at the stock width) over the card tests' shapes; a planted fault that moves
# every other value of a save one bf16 ulp toward zero, as a round-toward-
# zero epilogue would, reads 3.46e-3 or more. The bar sits between them.
SAVES_RELL2 = 1e-3


def plain_saves(weights, enc, denc, div, dims):
    """``mk.fused_fwd_saves``' tensors filled from the plain chain
    (``mk._chain_reference``), on ``enc``'s device: enc (M, >= n_pos) and
    denc (M / ``div``, >= n_dir), the bf16 encodings (the direction one per
    ``div`` points), copied in at their true widths; the 8 trunk outputs,
    feat and hr, the plain chain's bf16-rounded f32 values stored bf16
    (exactly); raw = [raw_sigma, raw_rgb] f32. ``weights`` is the 24-tuple
    of ``mk.collect_weights``, ``dims`` that of ``mk._dims``."""
    n_pos, n_dir = dims[:2]
    sv = mk.fused_fwd_saves(enc.shape[0], denc.shape[0], dims, enc.device)
    sv["enc"][:, :n_pos] = enc[:, :n_pos]
    sv["denc"][:, :n_dir] = denc[:, :n_dir]
    with torch.no_grad():
        acts, feat, hr, raw_sigma, raw_rgb = mk._chain_reference(
            mk._weights_dict(weights), enc[:, :n_pos].float(),
            denc[:, :n_dir].float().repeat_interleave(div, 0))
    for dst, src in zip([*sv["acts"], sv["feat"], sv["hr"]],
                        [*acts, feat, hr]):
        dst.copy_(src)
    sv["raw"].copy_(torch.cat([raw_sigma, raw_rgb], 1))
    return sv


def plain_forward(weights, args, kernel):
    """The plain version's outputs and the plain chain's saves on the
    arguments of ``mk._composite_fwd`` (Kernel A: origins, rays, dirs, z,
    deltas, cfg) or ``mk._point_fwd`` (Kernel C: pts, dirs, cfg)."""
    if kernel == "A":
        o, r, d, z, deltas, cfg = args
        outs = mk.fused_mlp_composite_reference(weights, o, r, d, z, deltas,
                                                *cfg)
        pts = (o[:, None, :] + r[:, None, :] * z[..., None]).reshape(-1, 3)
        div = cfg[-1]
    else:
        pts, d, cfg = args
        outs = mk.fused_mlp_reference(weights, pts, d, *cfg)
        div = 1
    l_pos, l_dir = cfg[:2]
    dims = mk._dims(weights, l_pos, l_dir)
    with torch.no_grad():
        enc = encode_position(pts, l_pos).to(torch.bfloat16)
        denc = encode_position(d, l_dir).to(torch.bfloat16)
        outs = [o.detach() for o in outs]
    return outs, plain_saves(weights, enc, denc, div, dims)


def saves_rel_l2(saved, plain, first, dims):
    """{name: relL2} of the 13 tensors a saving forward stored
    (``saved[first:first + 13]``) against ``plain`` (:func:`plain_saves`),
    each at its true width; raises unless each has the plain saves' shape,
    dtype and strides and is finite."""
    n_pos, n_dir = dims[:2]
    want = [plain[k] for k in SAVE_NAMES[:5]] + list(plain["acts"])
    rels = {}
    for name, x, y in zip(SAVE_NAMES, saved[first:first + 13], want):
        if (x.shape, x.dtype, x.stride()) != (y.shape, y.dtype, y.stride()):
            raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype} "
                                 f"{x.stride()}, plain {tuple(y.shape)} "
                                 f"{y.dtype} {y.stride()}")
        width = {"enc": n_pos, "denc": n_dir}.get(name, x.shape[1])
        x, y = x[:, :width].double(), y[:, :width].double()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: not finite")
        rels[name] = float(torch.linalg.vector_norm(x - y)
                           / torch.clamp_min(torch.linalg.vector_norm(y),
                                             1e-30))
    return rels
