"""Depth Anything V2 on the port's depth-prior path (``dpt_depth.depth_batch``
with ``depth.type: DepthAnythingV2``) against the benchmark's plain
reference (``benchmark/reference/depth_anything_v2.py``) on the CPU at a
tiny size with seeded weights; the position embedding's resize against an
independent float64 bicubic; the fusion onto an odd grid; the
'lower_bound' transform's sizes; DPT-Hybrid's transform and forward bit
for bit as they were before the helpers they share were generalised; the
``dpt.*`` spans and counters; the benchmark's FLOP counts against
``torch.utils.flop_counter``; the cell's metric readers; the converter of
the published checkpoint; and the CLI."""
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import counts_da2, weights_da2, weights_dpt
from benchmark.reference import depth_anything_v2 as ref
from nope_nerf_tpu_torch import convert_depth_anything as conv_da
from nope_nerf_tpu_torch import dpt_depth, tracing
from nope_nerf_tpu_torch.models import depth_anything as da
from nope_nerf_tpu_torch.models import dpt

torch.set_num_threads(1)

# Both sides compute in float32 on the CPU with the same operations in
# other forms and orders (F.linear against x @ w.T + b, the norms and GELU
# by hand, attention as einsum, LayerScale's product on the other side):
# about seventy layers of f32 rounding, measured at up to 8.6e-7 relative
# L2 (the pre-ReLU output; the depth 1.3e-7); about ten times that is the
# bar. The planted faults read 1.8e-3 and 0.14.
REF_RELL2 = 1e-5
# width 128 (2 heads of 64), 12 blocks (tapped after 2, 5, 8, 11, as
# ViT-S and B are), a 5x5 position grid, out_channels 16..64, 32 features;
# 70x126 frames at input_size 70 keep their size: a 5x9 grid, 46 tokens
TINY = {"dim": 128, "blocks": 12, "mlp_dim": 512, "patch": 14,
        "pos_embed_grid": 5, "out_channels": [16, 32, 64, 64],
        "features": 32}
FRAME_HW = (70, 126)
# a head bias that puts about half the head's output (~-0.04..0.06) below
# 0, and a tail that spreads the depth over ~9..20, so that the ReLU and
# the tail both matter
HEAD_BIAS = 0.025
CFG = {"type": "DepthAnythingV2", "scale": 1.0, "shift": 0.05,
       "invert": True, "non_negative": True, "input_size": 70}
OUTPUTS = {"depth": {},
           "inverse": {"invert": False},
           "pre_relu": {"invert": False, "non_negative": False}}
FULL = {"dim": 1024, "blocks": 24, "mlp_dim": 4096, "patch": 14,
        "pos_embed_grid": 37, "out_channels": [256, 512, 1024, 1024],
        "features": 256}


def rel_l2(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def params():
    p = weights_da2.da2_weights(TINY, 31, "cpu")
    p["head"]["conv3"]["b"] = torch.full((1,), HEAD_BIAS)
    return p


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(32)
    return torch.rand((2, *FRAME_HW, 3), generator=g)


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("output", list(OUTPUTS))
def test_depth_batch_matches_the_plain_reference(params, frames, output):
    """The depth, the inverse depth after the ReLU and the head's output
    before it: within REF_RELL2 of the reference, with pixels on both
    sides of the ReLU."""
    cfg = dict(CFG, **OUTPUTS[output])
    got = dpt_depth.depth_batch(params, frames, cfg)
    want, pre = ref.forward(params, frames, cfg)
    assert got.shape == want.shape == (2, *FRAME_HW)
    assert got.dtype == torch.float32
    clamped = float((pre < 0).double().mean())
    assert 0.1 < clamped < 0.9
    assert rel_l2(got, want) <= REF_RELL2


def test_depth_batch_returns_the_pre_relu_output_of_its_kernels(params,
                                                               frames):
    """``pre_relu`` adds the head's output before its ReLU: the depth bit
    for bit the call without it, both within REF_RELL2 of the reference;
    a planted fault of the reference lies far outside it."""
    depth, pre = dpt_depth.depth_batch(params, frames, CFG, pre_relu=True)
    torch.testing.assert_close(
        depth, dpt_depth.depth_batch(params, frames, CFG), rtol=0, atol=0)
    want, want_pre = ref.forward(params, frames, CFG)
    assert rel_l2(depth, want) <= REF_RELL2
    assert rel_l2(pre, want_pre) <= REF_RELL2
    for fault in ref.FAULTS:
        _, bad = ref.forward(params, frames, CFG, fault=fault)
        assert rel_l2(pre, bad) > 100 * REF_RELL2, fault


def _cubic(x, a=-0.75):
    x = abs(x)
    if x <= 1:
        return ((a + 2) * x - (a + 3)) * x * x + 1
    if x < 2:
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return 0.0


def _resize_axis(arr, n_out, coord_scale):
    """Bicubic along axis 0 of a float64 array: output d samples the input
    at (d + 0.5) * coord_scale - 0.5, borders clamped."""
    n_in = arr.shape[0]
    out = np.zeros((n_out,) + arr.shape[1:])
    for d in range(n_out):
        src = (d + 0.5) * coord_scale - 0.5
        i0 = math.floor(src)
        t = src - i0
        for k in range(-1, 3):
            out[d] += _cubic(k - t) * arr[min(max(i0 + k, 0), n_in - 1)]
    return out


@pytest.mark.parametrize("hw", [(518, 924), (70, 126), (924, 518)])
def test_pos_embed_resize_is_dinov2s_offset_bicubic(hw):
    """The grid of a 37x37 (5x5) position embedding resized as DINOv2 does:
    within 2e-6 relative L2 (f32 against float64) of a float64 bicubic (A
    = -0.75) whose source coordinates follow the scale factors ((gh +
    0.1) / g, (gw + 0.1) / g); a resize to the size (gh, gw) lands on other
    points and lies farther than 1e-2 from it."""
    g = 37 if hw[0] > 100 else 5
    gh, gw = hw[0] // 14, hw[1] // 14
    pos = torch.randn((1, 1 + g * g, 8),
                      generator=torch.Generator().manual_seed(g))
    got = da.resize_pos_embed(pos, *hw)
    assert got.shape == (1, 1 + gh * gw, 8)
    torch.testing.assert_close(got[:, :1], pos[:, :1], rtol=0, atol=0)
    grid = pos[0, 1:].double().numpy().reshape(g, g, 8)
    want = _resize_axis(grid, gh, g / (gh + 0.1))
    want = _resize_axis(want.transpose(1, 0, 2), gw, g / (gw + 0.1))
    want = want.transpose(1, 0, 2).reshape(gh * gw, 8)
    assert rel_l2(got[0, 1:], want) < 2e-6
    by_size = F.interpolate(pos[:, 1:].reshape(1, g, g, 8).permute(0, 3, 1, 2),
                            size=(gh, gw), mode="bicubic",
                            align_corners=False)
    by_size = by_size.flatten(2).transpose(1, 2)[0]
    assert rel_l2(by_size, want) > 1e-2
    square = da.resize_pos_embed(pos, g * 14, g * 14)
    assert square is pos


def test_fusion_onto_odd_grids_at_full_size():
    """Layer 4's 19x33 grid fuses onto layer 3's 37x66 (not 38x66), and on
    to 74x132, 148x264 and, by 2, 296x528; the head resizes that to
    518x924 (shapes, on meta tensors at the published widths)."""
    meta = {k: torch.empty(v, device="meta") for k, v in
            (("w", (256, 256, 3, 3)), ("b", (256,)))}
    fus = {"rcu1": {"conv1": meta, "conv2": meta},
           "rcu2": {"conv1": meta, "conv2": meta},
           "out_conv": {"w": torch.empty((256, 256, 1, 1), device="meta"),
                        "b": meta["b"]}}
    x = torch.empty((2, 256, 19, 33), device="meta")
    sizes = [(37, 66), (74, 132), (148, 264)]
    for size in sizes:
        skip = torch.empty((2, 256, *size), device="meta")
        x = dpt._apply_fusion(fus, x, size=size)
        assert x.shape == (2, 256, *size)
        x = x + skip
    assert dpt._apply_fusion(fus, x, x).shape == (2, 256, 296, 528)
    tree = _meta_tree(da.param_shapes())
    feats = [torch.empty((1, 1024, 37, 66), device="meta")] * 4
    assert da._apply_decoder(tree, feats, 37, 66).shape == (1, 518, 924)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta_tree(v) for v in shapes]
    return torch.empty(shapes, device="meta")


@pytest.mark.parametrize("hw,size,want", [
    ((540, 960), 518, (518, 924)), ((960, 540), 518, (924, 518)),
    ((756, 1008), 518, (518, 686)), ((518, 518), 518, (518, 518)),
    ((540, 960), 510, (518, 910)), ((70, 126), 70, (70, 126)),
    ((24, 32), 28, (28, 42))])
def test_lower_bound_transform_sizes(hw, size, want):
    """'lower_bound' to multiples of 14: the larger scale, each side
    rounded half to even, rounded up where that falls under the target
    (540x960 at 510: 510 / 14 rounds to 36, 504 < 510, so 518); the
    values within float32 rounding of the reference's transform."""
    assert dpt.transform_hw(*hw, size, 14, "lower_bound") == want
    assert tuple(ref.network_size(*hw, size)) == want
    if size == 518:
        assert counts_da2.network_hw(*hw) == want
    if max(hw) < 200:
        imgs = torch.rand((2, *hw, 3), generator=torch.Generator(
        ).manual_seed(hw[0]))
        got = da.depth_anything_input_transform_batched(imgs, size)
        assert got.shape == (2, *want, 3) and got.dtype == torch.float32
        mine = ref.transform(imgs, size).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, mine, rtol=0, atol=5e-7)


# --- DPT-Hybrid as it was before its helpers were generalised -------------

def _parent_vit_block(p, x):
    B, T, D = x.shape
    h = dpt._layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    qkv = F.linear(h, p["qkv"]["w"], p["qkv"]["b"])
    qkv = qkv.reshape(B, T, 3, 12, D // 12).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax(q @ k.transpose(-1, -2) * (D // 12) ** -0.5, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B, T, D)
    x = x + F.linear(out, p["proj"]["w"], p["proj"]["b"])
    h = dpt._layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = F.gelu(F.linear(h, p["mlp1"]["w"], p["mlp1"]["b"]))
    return x + F.linear(h, p["mlp2"]["w"], p["mlp2"]["b"])


def _parent_fusion(p, x, res=None):
    if res is not None:
        x = x + dpt._apply_rcu(p["rcu1"], res)
    x = dpt._apply_rcu(p["rcu2"], x)
    x = dpt._resize_bilinear_ac(x, (x.shape[2] * 2, x.shape[3] * 2))
    return dpt._conv(x, p["out_conv"]["w"], p["out_conv"]["b"])


def _parent_forward(params, x, scale=0.000305, shift=0.1378):
    B, _, H, W = x.shape
    gh, gw = H // 16, W // 16
    tap1, tap2, feat = dpt._apply_resnet(params["resnet"], x)
    tokens = dpt._conv(feat, params["patch_proj"]["w"],
                       params["patch_proj"]["b"]).flatten(2).transpose(1, 2)
    x = torch.cat([params["cls_token"].expand(B, 1, 768), tokens], dim=1)
    x = x + dpt._resize_pos_embed(params["pos_embed"], gh, gw)
    hooks = {}
    for i, bp in enumerate(params["blocks"]):
        x = _parent_vit_block(bp, x)
        if i in (8, 11):
            hooks[i] = x
    l3 = dpt._readout(hooks[8], params["readout3"], gh, gw)
    l4 = dpt._readout(hooks[11], params["readout4"], gh, gw)
    l3 = dpt._conv(l3, params["post3_conv"]["w"], params["post3_conv"]["b"])
    l4 = dpt._conv(l4, params["post4_conv1"]["w"],
                   params["post4_conv1"]["b"])
    l4 = dpt._conv(l4, params["post4_conv2"]["w"],
                   params["post4_conv2"]["b"], stride=2, padding=1)
    sc = params["scratch"]
    r = [dpt._conv(t, sc[f"layer{i + 1}_rn"]["w"])
         for i, t in enumerate((tap1, tap2, l3, l4))]
    p4 = _parent_fusion(params["refinenet4"], r[3])
    p3 = _parent_fusion(params["refinenet3"], p4, r[2])
    p2 = _parent_fusion(params["refinenet2"], p3, r[1])
    p1 = _parent_fusion(params["refinenet1"], p2, r[0])
    hp = params["head"]
    h = dpt._conv(p1, hp["conv1"]["w"], hp["conv1"]["b"])
    h = dpt._resize_bilinear_ac(h, (h.shape[2] * 2, h.shape[3] * 2))
    h = F.relu(dpt._conv(h, hp["conv2"]["w"], hp["conv2"]["b"]))
    h = dpt._conv(h, hp["conv3"]["w"], hp["conv3"]["b"])[:, 0]
    inv = F.relu(h)
    return 1.0 / torch.clamp_min(scale * inv + shift, 1e-8), h


def _parent_transform(frames):
    H, W = frames.shape[1:3]
    scale_h, scale_w = 384 / H, 384 / W
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    new_h = int(np.round(scale * H / 32) * 32)
    new_w = int(np.round(scale * W / 32) * 32)
    x = frames.to(torch.float64).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(new_h, new_w), mode="bicubic",
                        align_corners=False)
    return ((out.permute(0, 2, 3, 1) - 0.5) / 0.5).to(torch.float32)


def test_dpt_hybrid_is_unchanged_bit_for_bit():
    """DPT-Hybrid's transform, ViT block, fusion and whole forward (depth
    and pre-ReLU output) at the published widths on a fixed 24x400 frame:
    bit for bit the code before the shared helpers took LayerScale, q
    scaled before ``q k^T`` (by 64^-0.5, a power of two), a target size,
    the resize method and the normalisation."""
    net = {"resnet_layers": [3, 4, 9], "resnet_widths": [256, 512, 1024],
           "vit_dim": 768, "vit_blocks": 12, "vit_mlp_dim": 3072,
           "pos_embed_grid": 24, "features": 256,
           "reassemble": [256, 512, 768, 768]}
    params = weights_dpt.dpt_weights(net, 41, "cpu")
    frames = torch.rand((1, 24, 400, 3),
                        generator=torch.Generator().manual_seed(42))
    x = dpt.dpt_input_transform_batched(frames)
    assert torch.equal(x, _parent_transform(frames))
    tok = torch.randn((1, 7, 768), generator=torch.Generator().manual_seed(3))
    assert torch.equal(dpt._apply_vit_block(params["blocks"][0], tok),
                       _parent_vit_block(params["blocks"][0], tok))
    depth, pre = dpt.apply_dpt_batched(params, x, pre_relu=True)
    with torch.no_grad():
        want, want_pre = _parent_forward(params, x.permute(0, 3, 1, 2))
    assert torch.equal(depth, want) and torch.equal(pre, want_pre)


# --- spans, counters, counts, readers -------------------------------------

def test_depth_batch_leaves_its_spans_and_counters(params, frames):
    """One call on the CPU: the host span ``dpt.batch`` with
    ``dpt.transform``, ``dpt.dinov2`` holding one ``dpt.dinov2.attn`` a
    block, and ``dpt.decoder``; the frame, batch and token counters (2 x
    46 tokens here; 2,443 a 540x960 frame); no device time."""
    dpt_depth.depth_batch(params, frames, CFG)
    recs = tracing.spans()
    names = [(r.name, r.parent) for r in recs]
    assert names == ([("dpt.transform", "dpt.batch")]
                     + [("dpt.dinov2.attn", "dpt.dinov2")] * 12
                     + [("dpt.dinov2", "dpt.batch"),
                        ("dpt.decoder", "dpt.batch"), ("dpt.batch", None)])
    assert tracing.counters() == {"dpt.frames": 2, "dpt.batches": 1,
                                  "dpt.tokens": 2 * (5 * 9 + 1)}
    assert tracing.section_ms(dpt_depth.PHASE, eager=True) is None
    assert counts_da2.tokens(518, 924) == 37 * 66 + 1 == 2443


def test_the_counts_match_the_flop_counter():
    """The shape-only counts equal ``FlopCounterMode`` over the port's
    forward on meta tensors at the published widths: 2,583,110,724,096 a
    518x924 frame."""
    from torch.utils.flop_counter import FlopCounterMode

    tree = _meta_tree(da.param_shapes())
    for hw in ((518, 924), (70, 126)):
        with FlopCounterMode(display=False) as fc:
            da._apply_depth_anything_nchw(
                tree, torch.empty(2, 3, *hw, device="meta"))
        assert fc.get_total_flops() == 2 * counts_da2.flops(*hw)
    assert counts_da2.flops(518, 924) == 2_583_110_724_096


def test_the_benchmark_layout_is_the_ports():
    """The cell's weights have every key and shape of ``param_shapes``,
    in order, at the published widths and at the tiny ones."""
    for net, kw in ((FULL, {}),
                    (TINY, {"dim": 128, "blocks": 12, "mlp": 512,
                            "pos_grid": 5, "out_channels": (16, 32, 64, 64),
                            "features": 32})):
        bench = torch.utils._pytree.tree_flatten_with_path(
            weights_da2.layout(net), is_leaf=lambda x: isinstance(x, tuple))
        port = torch.utils._pytree.tree_flatten_with_path(
            da.param_shapes(**kw), is_leaf=lambda x: isinstance(x, tuple))
        assert [(k, v[1]) for k, v in bench[0]] == [
            (k, tuple(v)) for k, v in port[0]]


def test_da2_cell_readers_on_planted_readings():
    """The cell's eight per-layer metrics from planted readings, and none
    of them in a DPT-Hybrid run's readings."""
    from benchmark.harness import read_metric
    from benchmark.profiling import Slice

    least = {"dpt.dinov2": 22e-3, "dpt.dinov2.attn": 8.8e-3,
             "dpt.decoder": 7.7e-3}
    t = {"phase": "depth_priors", "network": "DepthAnythingV2",
         "slice_steps": 24, "step_wall_s": 0.1,
         "slice": Slice(2.4, 2.28, 40000, {}, []),
         "model_flops_per_frame": 2_583_110_724_096,
         "dpt_sections_ms": {"dpt.transform": 0.5, "dpt.dinov2": 44.0,
                             "dpt.dinov2.attn": 22.0, "dpt.decoder": 15.4},
         "dpt_host_ms": 3.0, "dpt_least_s": least}
    want = {"da2_encoder_ms.depth_priors_518": 66.0,
            "da2_attn_ms.depth_priors_518": 22.0,
            "da2_head_ms.depth_priors_518": 15.4,
            "da2_encoder_roofline.depth_priors_518": 100 * 30.8 / 66.0,
            "da2_attn_roofline.depth_priors_518": 40.0,
            "da2_head_roofline.depth_priors_518": 50.0,
            "da2_mfu": 100 * 2_583_110_724_096 * 24 / 2.4 / 67e12,
            "device_idle_pct.depth_priors_518": 5.0}
    hybrid = dict(t)
    del hybrid["network"]
    for name, value in want.items():
        assert read_metric(name, t) == pytest.approx(value), name
        assert read_metric(name, hybrid) is None, name


# --- the converter and the CLI --------------------------------------------

def _published(tree):
    """The port's tree under the published checkpoint's names, with the
    ``mask_token`` DINOv2 keeps for training."""
    enc, sc = "pretrained.", "depth_head.scratch."
    out = {enc + "mask_token": torch.zeros(1, tree["cls_token"].shape[-1])}

    def put(name, p):
        out[name + ".weight"] = p.get("w", p.get("scale"))
        out[name + ".bias"] = p.get("b", p.get("bias"))

    put(enc + "patch_embed.proj", tree["patch_embed"])
    out[enc + "cls_token"] = tree["cls_token"]
    out[enc + "pos_embed"] = tree["pos_embed"]
    for i, b in enumerate(tree["blocks"]):
        pre = f"{enc}blocks.{i}."
        for mine, theirs in (("ln1", "norm1"), ("qkv", "attn.qkv"),
                             ("proj", "attn.proj"), ("ln2", "norm2"),
                             ("mlp1", "mlp.fc1"), ("mlp2", "mlp.fc2")):
            put(pre + theirs, b[mine])
        out[pre + "ls1.gamma"] = b["ls1"]
        out[pre + "ls2.gamma"] = b["ls2"]
    put(enc + "norm", tree["norm"])
    for i in range(4):
        put(f"depth_head.projects.{i}", tree["projects"][i])
    for i in (0, 1, 3):
        put(f"depth_head.resize_layers.{i}", tree[f"resize{i}"])
    for i in (1, 2, 3, 4):
        out[f"{sc}layer{i}_rn.weight"] = tree["scratch"][f"layer{i}_rn"]["w"]
        r = tree[f"refinenet{i}"]
        for u in (1, 2):
            for c in (1, 2):
                put(f"{sc}refinenet{i}.resConfUnit{u}.conv{c}",
                    r[f"rcu{u}"][f"conv{c}"])
        put(f"{sc}refinenet{i}.out_conv", r["out_conv"])
    put(sc + "output_conv1", tree["head"]["conv1"])
    put(sc + "output_conv2.0", tree["head"]["conv2"])
    put(sc + "output_conv2.2", tree["head"]["conv3"])
    return out


def test_the_converter_maps_every_published_name(params, frames, tmp_path):
    """A state dict with every published name at the tiny widths converts
    to the port's tree leaf for leaf, round-trips the npz the CLI loads,
    and runs to the reference's output on the same tensors; a missing or
    misshapen key is refused by name."""
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    state = _published(params)
    assert len(state) == 1 + 2 + 1 + 1 + 12 * 14 + 2 + 8 + 6 + 4 + 4 * 10 + 6
    tree = conv_da.convert(state)
    mine = torch.utils._pytree.tree_flatten_with_path(params)[0]
    got = torch.utils._pytree.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in got] == [k for k, _ in mine]
    for (k, a), (_, b) in zip(got, mine):
        assert np.array_equal(a, b.numpy()), k
    npz = str(tmp_path / "da2.npz")
    save_pytree(npz, {"params": tree})
    loaded = da.load_depth_anything(npz)
    depth, pre = dpt_depth.depth_batch(loaded, frames, CFG, pre_relu=True)
    want, want_pre = ref.forward(params, frames, CFG)
    assert rel_l2(depth, want) <= REF_RELL2
    assert rel_l2(pre, want_pre) <= REF_RELL2
    gone = "depth_head.scratch.refinenet2.out_conv.bias"
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        conv_da.convert({k: v for k, v in state.items() if k != gone})
    bad = "pretrained.blocks.3.ls2.gamma"
    with pytest.raises(ValueError, match=bad.replace(".", r"\.")):
        conv_da.convert(dict(state, **{bad: torch.zeros(129)}))


def test_the_cli_writes_depth_anything_priors(params, tmp_path):
    """``python -m nope_nerf_tpu_torch.dpt_depth`` with ``depth.type:
    DepthAnythingV2`` on a 3-frame scene on disk: each prior is
    ``depth_batch``'s depth of the frame bit for bit, at the network's
    size."""
    import yaml
    from PIL import Image

    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.dataloading.scene import get_scene
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    rng = np.random.default_rng(33)
    os.makedirs(tmp_path / "scene" / "images")
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (*FRAME_HW, 3), np.uint8)).save(
            tmp_path / "scene" / "images" / f"{i:03d}.png")
    npz = str(tmp_path / "da2.npz")
    save_pytree(npz, {"params": conv_da.convert(_published(params))})
    depth = {k: v for k, v in CFG.items() if k not in ("scale", "shift",
                                                       "invert",
                                                       "non_negative")}
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump({
        "depth": dict(depth, path=npz),
        "dataloading": {"path": str(tmp_path), "scene": ["scene"],
                        "resize_factor": None, "load_colmap_poses": False},
        "training": {"mode": "all"}}))
    cfg = load_config(str(path), DEFAULT_CONFIG)
    out = dpt_depth.main(cfg, device="cpu")
    imgs = torch.as_tensor(get_scene(cfg, mode="all").imgs)
    want = dpt_depth.depth_batch(params, imgs, cfg["depth"]).numpy()
    names = sorted(n for n in os.listdir(out) if n.endswith(".npz"))
    assert len(names) == 3
    for name, w in zip(names, want):
        got = np.load(os.path.join(out, name))["pred"]
        assert got.shape == (1, *FRAME_HW)
        np.testing.assert_array_equal(got[0], w)


def _da2_ranks(mesh, npz, imgs, cfg):
    """``depth_batch`` of ``imgs`` with the npz's weights over ``mesh``
    (a rank body of ``_torch_parallel_workers.start``)."""
    params = da.load_depth_anything(npz)
    depth, pre = dpt_depth.depth_batch(params, torch.as_tensor(imgs), cfg,
                                       mesh=mesh, pre_relu=True)
    return depth.numpy(), pre.numpy()


def test_depth_batch_shards_frames_over_two_ranks(params, tmp_path):
    """3 frames over 2 gloo ranks (the batch padded to 4): every rank gets
    the 3 depths and pre-ReLU outputs of the one-process call within 2e-6
    relative (the CPU's products of a batch of 2 differ from those of a
    batch of 3 by a few f32 ulps, as DPT-Hybrid's two-rank test finds)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_workers as workers
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    npz = str(tmp_path / "da2.npz")
    save_pytree(npz, {"params": conv_da.convert(_published(params))})
    imgs = np.random.default_rng(34).uniform(size=(3, *FRAME_HW, 3)).astype(
        np.float32)
    handle = workers.start(_da2_ranks, tmp_path, npz, imgs, CFG)
    want = _da2_ranks(None, npz, imgs, CFG)
    for got in workers.wait(handle):
        for g, w in zip(got, want):
            assert g.shape == w.shape == (3, *FRAME_HW)
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7)
