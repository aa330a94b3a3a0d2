"""The port's depth-prior pass (``dpt_depth.depth_batch``: the batched
input transform, DPT-Hybrid, the depth tail) against the benchmark's plain
reference (``benchmark/reference/dpt.py``) on the CPU at the published
widths with seeded weights; the batched transform against the one-frame
one bit for bit; the benchmark's FLOP counts (``benchmark/counts_dpt.py``)
against ``torch.utils.flop_counter``; the ``dpt.*`` spans and counters a
call leaves; the readers of the depth-prior cell's metrics; and the CLI's
priors against the per-frame path it replaced."""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import counts_dpt, weights_dpt
from benchmark.reference import dpt as ref
from nope_nerf_tpu_torch import dpt_depth, tracing
from nope_nerf_tpu_torch.models import dpt

torch.set_num_threads(1)

# Both sides compute in float32 on the CPU with the same operations in other
# orders and forms (the weight standardisation, the norms by hand,
# attention as einsum, padding by F.pad): about sixty layers of f32
# rounding, measured at 2e-6 relative L2; ten times that is the bar.
REF_RELL2 = 2e-5
# 24x400 frames transform to 32x384 (2 x 24 tokens), the smallest network
# input the 384 target allows: ~20.5 GFLOP a frame at the published widths
FRAME_HW = (24, 400)
# A head bias that puts about half the head's output (~-0.12..0.14 with it)
# above 0, and a depth tail that spreads the depth over ~5..20, so that the
# ReLU and the tail both matter (the published scale 0.000305 and shift
# 0.1378 map the seeded network's output to a near-constant depth)
HEAD_BIAS = 0.10
CFG = {"scale": 1.0, "shift": 0.05, "invert": True, "non_negative": True}
OUTPUTS = {"depth": {},
           "inverse": {"invert": False},
           "pre_relu": {"invert": False, "non_negative": False}}
NETWORK = {"resnet_layers": [3, 4, 9], "resnet_widths": [256, 512, 1024],
           "vit_dim": 768, "vit_blocks": 12, "vit_mlp_dim": 3072,
           "pos_embed_grid": 24, "features": 256,
           "reassemble": [256, 512, 768, 768]}


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def params():
    """The depth-prior cell's seeded weights at the published widths
    (drawn class token, position embedding and norms), with the head's
    bias set to HEAD_BIAS."""
    p = weights_dpt.dpt_weights(NETWORK, 21, "cpu")
    p["head"]["conv3"]["b"] = torch.full((1,), HEAD_BIAS)
    return p


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(22)
    return torch.rand((2, *FRAME_HW, 3), generator=g)


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("output", list(OUTPUTS))
def test_depth_batch_matches_the_plain_reference(params, frames, output):
    """The depth (``invert`` True), the inverse depth after the ReLU
    (``invert`` False) and the head's output before its ReLU
    (``non_negative`` False too): within REF_RELL2 of the reference, with
    pixels on both sides of the ReLU."""
    cfg = dict(CFG, **OUTPUTS[output])
    got = dpt_depth.depth_batch(params, frames, cfg)
    want, pre = ref.forward(params, frames, cfg)
    assert got.shape == want.shape == (2, 32, 384)
    assert got.dtype == torch.float32
    clamped = float((pre < 0).double().mean())
    assert 0.1 < clamped < 0.9
    assert rel_l2(got, want) <= REF_RELL2


def test_depth_batch_returns_the_pre_relu_output_of_its_kernels(params,
                                                               frames):
    """``pre_relu`` adds the head's output before its ReLU to the depth
    (the depth-prior cell compares both from its timed calls): the depth
    bit for bit the call without it, and both within REF_RELL2 of the
    reference."""
    depth, pre = dpt_depth.depth_batch(params, frames, CFG, pre_relu=True)
    torch.testing.assert_close(
        depth, dpt_depth.depth_batch(params, frames, CFG), rtol=0, atol=0)
    want, want_pre = ref.forward(params, frames, CFG)
    assert pre.shape == want_pre.shape == (2, 32, 384)
    assert rel_l2(depth, want) <= REF_RELL2
    assert rel_l2(pre, want_pre) <= REF_RELL2


def test_benchmark_weights_have_the_port_layout(params):
    """The cell's weights have every key and shape of the port's own
    initialisation (``init_dpt_params``); the same seed on the same device
    gives the same leaves and another seed others; each law's range, and
    no leaf constant."""
    mine = torch.utils._pytree.tree_flatten_with_path(params)[0]
    port = torch.utils._pytree.tree_flatten_with_path(
        dpt.init_dpt_params(torch.Generator().manual_seed(0)))[0]
    assert [(k, v.shape) for k, v in mine] == [(k, v.shape) for k, v in port]
    small = {"resnet_layers": [1, 2, 1], "resnet_widths": [32, 64, 128],
             "vit_dim": 48, "vit_blocks": 2, "vit_mlp_dim": 96,
             "pos_embed_grid": 3, "features": 16,
             "reassemble": [16, 32, 48, 48]}
    a, b, c = (weights_dpt.dpt_weights(small, s, "cpu") for s in (7, 7, 8))
    torch.utils._pytree.tree_map(
        lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    assert not torch.equal(a["pos_embed"], c["pos_embed"])
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(a)[0]:
        key = path[-1].key
        assert leaf.count_nonzero() and not torch.all(leaf == 1), path
        assert leaf.numel() == 1 or leaf.std() > 0, path
        if key in ("cls_token", "pos_embed"):
            assert 0.01 < float(leaf.std()) < 0.03, path
        elif key == "scale":
            assert float((leaf - 1).abs().max()) <= 0.1, path
        elif path[-2].key.startswith(("norm", "ln", "stem_norm", "down_norm",
                                      "final_ln")):
            assert float(leaf.abs().max()) <= 0.1, path
        else:
            fan = leaf.numel() // leaf.shape[0] if leaf.dim() > 1 else None
            if fan:
                assert float(leaf.abs().max()) <= fan ** -0.5, path


def _transform_parent(img, target=384, multiple_of=32):
    """The one-frame numpy transform as it was before the batched one: the
    reference the batched transform is held to bit for bit."""
    H, W = img.shape[:2]
    scale_h, scale_w = target / H, target / W
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    new_h = int(np.round(scale * H / multiple_of) * multiple_of)
    new_w = int(np.round(scale * W / multiple_of) * multiple_of)
    x = torch.as_tensor(np.asarray(img), dtype=torch.float64)
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(new_h, new_w),
                        mode="bicubic", align_corners=False)[0]
    return ((out.permute(1, 2, 0).numpy() - 0.5) / 0.5).astype(np.float32)


@pytest.mark.parametrize("hw", [(540, 960), (120, 160), (24, 400), (300, 200),
                                (384, 384), (500, 375), (33, 47), (720, 1280)])
def test_batched_transform_equals_the_one_frame_transform(hw):
    """Three frames through ``dpt_input_transform_batched`` give each
    frame's ``dpt_input_transform`` and the per-frame numpy path it
    replaced, bit for bit; the reference's transform lies within float32
    rounding of it."""
    imgs = np.random.default_rng(hw[1]).uniform(size=(3, *hw, 3)).astype(
        np.float32)
    got = dpt.dpt_input_transform_batched(torch.as_tensor(imgs)).numpy()
    for i in range(3):
        one = dpt.dpt_input_transform(imgs[i])
        assert got[i].dtype == one.dtype == np.float32
        np.testing.assert_array_equal(got[i], one)
        np.testing.assert_array_equal(got[i], _transform_parent(imgs[i]))
    assert got.shape[1:3] == counts_dpt.network_hw(*hw)
    mine = ref.transform(torch.as_tensor(imgs)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(mine, got, rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("hw", [(64, 96), (384, 672)])
def test_counts_match_the_flop_counter(params, hw):
    """The shape-only counts equal ``FlopCounterMode`` over the port's
    forward on meta tensors: 462,575,407,104 a 384x672 frame."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.utils._pytree.tree_map(lambda t: t.to("meta"), params)
    with FlopCounterMode(display=False) as fc:
        dpt._apply_dpt_nchw(meta, torch.empty(2, 3, *hw, device="meta"))
    assert fc.get_total_flops() == 2 * counts_dpt.flops(*hw)
    if hw == (384, 672):
        assert counts_dpt.flops(*hw) == 462_575_407_104
        least = counts_dpt.least_seconds(*hw, 4)
        assert least["dpt.vit"] == pytest.approx(
            counts_dpt.section_flops(*hw)["dpt.vit"] / 67e12)


def test_standardised_weights_are_kept_until_the_weight_changes():
    """A frozen weight's standardised copy is computed once, bit for bit
    the per-call computation, and recomputed after an in-place change; a
    weight that requires grad keeps none."""
    w = torch.randn(8, 6, 3, 3, generator=torch.Generator().manual_seed(3))
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
    first = dpt._standardised(w)
    torch.testing.assert_close(first, (w - mean) / torch.sqrt(var + 1e-6),
                               rtol=0, atol=0)
    assert dpt._standardised(w) is first
    w.mul_(2.0).add_(1.0)
    again = dpt._standardised(w)
    assert again is not first
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
    torch.testing.assert_close(again, (w - mean) / torch.sqrt(var + 1e-6),
                               rtol=0, atol=0)
    g = w.clone().requires_grad_()
    assert dpt._standardised(g) is not dpt._standardised(g)


def test_depth_batch_leaves_its_spans_and_counters(params, frames):
    """One call on the CPU: the host span ``dpt.batch`` with the four
    sections' spans in it, in order; the frame, batch and token counters
    (2 x 1 + 2 x 24 tokens here; 1,009 a 540x960 frame); no device time;
    a bare ``apply_dpt_batched`` opens no section."""
    dpt.apply_dpt_batched(params, dpt.dpt_input_transform_batched(frames))
    assert tracing.spans() == [] and tracing.counters() == {}
    dpt_depth.depth_batch(params, frames, CFG)
    recs = tracing.spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("dpt.transform", "dpt.batch"), ("dpt.resnet", "dpt.batch"),
        ("dpt.vit", "dpt.batch"), ("dpt.decoder", "dpt.batch"),
        ("dpt.batch", None)]
    assert sum(r.ns for r in recs[:4]) <= recs[4].ns
    assert tracing.counters() == {"dpt.frames": 2, "dpt.batches": 1,
                                  "dpt.tokens": 2 * (2 * 24 + 1)}
    assert tracing.section_ms(dpt_depth.PHASE, eager=True) is None


def test_depth_cell_readers_on_planted_readings():
    """The depth-prior cell's ten per-layer metrics from planted readings,
    and none of them in a run of another phase."""
    from benchmark.harness import read_metric
    from benchmark.profiling import Slice

    least = {"dpt.resnet": 0.6e-3, "dpt.vit": 3.3e-3, "dpt.decoder": 3.0e-3}
    t = {"phase": "depth_priors", "slice_steps": 24, "step_wall_s": 0.02,
         "slice": Slice(0.48, 0.456, 4000, {}, []),
         "model_flops_per_frame": 462_575_407_104,
         "dpt_sections_ms": {"dpt.transform": 0.1, "dpt.resnet": 1.2,
                             "dpt.vit": 6.6, "dpt.decoder": 7.5},
         "dpt_host_ms": 1.5, "dpt_least_s": least}
    want = {"dpt_transform_ms.depth_priors": 0.1,
            "dpt_resnet_ms.depth_priors": 1.2,
            "dpt_vit_ms.depth_priors": 6.6,
            "dpt_decoder_ms.depth_priors": 7.5,
            "dpt_host_ms.depth_priors": 1.5,
            "dpt_mfu": 100 * 462_575_407_104 * 24 / 0.48 / 67e12,
            "dpt_resnet_roofline.depth_priors": 50.0,
            "dpt_vit_roofline.depth_priors": 50.0,
            "dpt_decoder_roofline.depth_priors": 40.0,
            "device_idle_pct.depth_priors": 5.0}
    for name, value in want.items():
        assert read_metric(name, t) == pytest.approx(value), name
        assert read_metric(name, dict(t, phase="render")) is None, name


def _jax_layout(t):
    """A port weight in the layout on disk: OIHW -> HWIO, (out, in) -> (in,
    out)."""
    a = t.numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def test_the_cli_writes_the_priors_of_the_per_frame_path(params, tmp_path):
    """``python -m nope_nerf_tpu_torch.dpt_depth`` on a 3-frame scene on
    disk (images only): each prior within 1e-6 relative L2 of the path it replaced (the
    numpy transform frame by frame, then ``apply_dpt_batched``)."""
    import yaml

    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.convert import _map
    from nope_nerf_tpu_torch.dataloading.scene import get_scene
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    from PIL import Image

    rng = np.random.default_rng(23)
    os.makedirs(tmp_path / "scene" / "images")
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (*FRAME_HW, 3), np.uint8)).save(
            tmp_path / "scene" / "images" / f"{i:03d}.png")
    npz = str(tmp_path / "dpt.npz")
    save_pytree(npz, {"params": _map(params, _jax_layout)})
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump({
        "depth": {"type": "DPT", "path": npz},
        "dataloading": {"path": str(tmp_path), "scene": ["scene"],
                        "resize_factor": None, "load_colmap_poses": False},
        "training": {"mode": "all"}}))
    cfg = load_config(str(path), DEFAULT_CONFIG)
    out = dpt_depth.main(cfg, device="cpu")
    imgs = get_scene(cfg, mode="all").imgs
    x = torch.as_tensor(np.stack([_transform_parent(f) for f in imgs]))
    want = dpt.apply_dpt_batched(dpt.load_dpt(npz), x).numpy()
    names = sorted(n for n in os.listdir(out) if n.endswith(".npz"))
    assert len(names) == 3
    for name, w in zip(names, want):
        got = np.load(os.path.join(out, name))["pred"]
        assert got.shape == (1, *w.shape)
        assert rel_l2(torch.as_tensor(got[0]), torch.as_tensor(w)) <= 1e-6
