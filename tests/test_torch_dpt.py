"""The port's DPT-hybrid depth network, its input transform and its
preprocessing CLI against the JAX package's, on the same numpy inputs from
seeds: the primitives, the full network at the published widths (weights
laid out as ``dpt_hybrid-midas-501f0c75.pt``, seeded), and both CLIs on one
small scene on disk.
"""
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
from test_dpt_convert import synth_state_dict  # noqa: E402

from nope_nerf_tpu.models import dpt as jdpt  # noqa: E402
from nope_nerf_tpu_torch.models import dpt as pdpt  # noqa: E402

# full network, f32 on both sides: depth relL2 and max relative error
DPT_RELL2, DPT_MAX_REL = 1e-4, 1e-3
# the primitives, f32 against f32: a few ulps of outputs up to ~30
PRIM_RTOL, PRIM_ATOL = 1e-5, 1e-5


def _nchw(a):
    return torch.tensor(np.asarray(a, np.float32)).permute(2, 0, 1)[None]


def _hwc(t):
    return t[0].permute(1, 2, 0).numpy()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _prim_cases():
    """(name, jax fn of an HWC array, port fn of an NCHW tensor, input
    shape): each primitive at the sizes where its padding differs."""
    rng = np.random.default_rng(3)
    cases = []
    for k, stride, hw in ((3, 1, (10, 14)), (3, 2, (10, 14)), (3, 2, (9, 13)),
                          (7, 2, (16, 20)), (7, 2, (15, 17)), (1, 2, (9, 14))):
        w = rng.normal(size=(k, k, 6, 8)).astype(np.float32)
        b = rng.normal(size=(8,)).astype(np.float32)
        wt = torch.tensor(w).permute(3, 2, 0, 1).contiguous()
        cases.append((
            f"std_conv_same_k{k}_s{stride}_{hw[0]}x{hw[1]}",
            lambda x, w=w, b=b, s=stride: jdpt._conv(x, w, b, stride=s,
                                                     std=True),
            lambda x, wt=wt, b=b, s=stride: pdpt._conv(
                x, wt, torch.tensor(b), stride=s, std=True),
            (*hw, 6)))
    w = rng.normal(size=(3, 3, 6, 8)).astype(np.float32)
    wt = torch.tensor(w).permute(3, 2, 0, 1).contiguous()
    cases.append(("conv_stride2_symmetric_pad",
                  lambda x: jdpt._conv(x, w, stride=2,
                                       padding=((1, 1), (1, 1))),
                  lambda x: pdpt._conv(x, wt, stride=2, padding=1),
                  (12, 16, 6)))
    for hw in ((12, 16), (11, 15)):
        cases.append((f"max_pool_same_{hw[0]}x{hw[1]}", jdpt._max_pool_same,
                      pdpt._max_pool_same, (*hw, 5)))
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    cases.append(("group_norm",
                  lambda x: jdpt._group_norm(x, scale, bias),
                  lambda x: pdpt._group_norm(x, torch.tensor(scale),
                                             torch.tensor(bias)),
                  (6, 7, 64)))
    cases.append(("layer_norm",
                  lambda x: jdpt._layer_norm(x, scale, bias),
                  lambda x: pdpt._layer_norm(
                      x.permute(0, 2, 3, 1), torch.tensor(scale),
                      torch.tensor(bias)).permute(0, 3, 1, 2),
                  (5, 6, 64)))
    cases.append(("resize_bilinear_align_corners",
                  lambda x: jdpt._resize_bilinear_ac(x, (14, 22)),
                  lambda x: pdpt._resize_bilinear_ac(x, (14, 22)),
                  (7, 11, 4)))
    return cases


PRIMS = _prim_cases()


@pytest.mark.parametrize("case", PRIMS, ids=[c[0] for c in PRIMS])
def test_dpt_primitive_matches_jax(case):
    """StdConv SAME (strides 1 and 2, even and odd sizes: the asymmetric
    pad), the symmetric stride-2 conv, -inf SAME max pool, GN, LN and the
    align_corners resize against the JAX primitives, rtol PRIM_RTOL and
    atol PRIM_ATOL."""
    _, jfn, pfn, shape = case
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = _hwc(pfn(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=PRIM_RTOL, atol=PRIM_ATOL)


@pytest.mark.parametrize("gs", [(24, 24), (2, 24), (17, 30), (4, 6),
                                (24, 42)])
def test_resize_pos_embed_matches_jax(gs):
    """The pos-embed grid resize (align_corners=False, edges clamped) to
    grids smaller, larger and equal to 24x24: the JAX package's at every
    token but the first row or column of an axis that grows, and published
    DPT's ``F.interpolate`` at every token. On that row or column the
    source coordinate lies left of the first centre: ``F.interpolate``
    takes the first row or column, and the JAX package blends the first two
    (it takes the second index from the clamped first; ROADMAP, faults)."""
    pos = np.random.default_rng(1).normal(
        size=(1, 577, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jdpt._resize_pos_embed, static_argnums=(1, 2))(
        jnp.asarray(pos), *gs))
    got = pdpt._resize_pos_embed(torch.tensor(pos), *gs).numpy()
    assert got.shape == want.shape == (1, 1 + gs[0] * gs[1], 32)
    same = np.ones(gs, bool)
    same[0, :] &= gs[0] <= 24
    same[:, 0] &= gs[1] <= 24
    same = np.concatenate([[True], same.ravel()])
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=PRIM_RTOL,
                               atol=PRIM_ATOL)
    grid = torch.tensor(pos[:, 1:]).reshape(1, 24, 24, 32).permute(0, 3, 1, 2)
    published = torch.nn.functional.interpolate(
        grid, size=gs, mode="bilinear", align_corners=False)
    np.testing.assert_array_equal(
        got[0, 1:], published.flatten(2).transpose(1, 2)[0].numpy())
    np.testing.assert_array_equal(got[0, 0], pos[0, 0])


# ---------------------------------------------------------------------------
# the full network at the published widths
# ---------------------------------------------------------------------------


# The seeded network's raw output spans about -320..+25, so after the
# non-negative ReLU 98% of the map is 0 and the depth a constant 1/shift. A
# head bias of 400 moves the inverse depth to ~80..720, the magnitude of the
# published model's, where every pixel passes the ReLU and the depth spans
# ~2.8..6.2: every pixel then tests the network.
HEAD_BIAS = 400.0


@pytest.fixture(scope="module")
def checkpoint():
    """A seeded state dict with every key and shape of the published
    checkpoint, and the head bias of HEAD_BIAS."""
    state = synth_state_dict(np.random.default_rng(0))
    state["scratch.output_conv.4.bias"][:] = HEAD_BIAS
    return state


@pytest.fixture(scope="module")
def weights(checkpoint):
    """The JAX tree of the seeded checkpoint (the port's converter), and
    the port's parameters from it."""
    from nope_nerf_tpu_torch.convert import dpt_params_from_jax
    from nope_nerf_tpu_torch.convert_dpt import convert

    tree = convert(checkpoint)
    return tree, dpt_params_from_jax(tree)


@pytest.mark.parametrize("net", ["dpt", "lpips"])
def test_chip_smoke_checkpoint_layouts(checkpoint, net):
    """chip_smoke.py's own copies of the published checkpoints' keys and
    shapes equal the JAX package's test fixtures."""
    import chip_smoke
    from test_lpips_convert import synth_dicts

    def shapes(d):
        return {k: tuple(v.shape) for k, v in d.items()}

    if net == "dpt":
        assert chip_smoke.dpt_checkpoint_shapes() == shapes(checkpoint)
    else:
        vgg, lin = synth_dicts(np.random.default_rng(0))
        assert chip_smoke.lpips_checkpoint_shapes() == (shapes(vgg),
                                                        shapes(lin))


@pytest.mark.parametrize("invert", [True, False])
def test_apply_dpt_matches_jax(weights, invert):
    """A 64x96 image through the whole network at the real widths: depth
    (or, with ``invert`` False, the inverse depth) within relL2 DPT_RELL2
    and max relative error DPT_MAX_REL of the JAX forward."""
    tree, params = weights
    img = np.random.default_rng(5).uniform(-1, 1, (64, 96, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda p, x: jdpt.apply_dpt(p, x, invert=invert))
    want = np.asarray(fwd(jax.tree.map(jnp.asarray, tree), jnp.asarray(img)))
    got = pdpt.apply_dpt(params, torch.tensor(img), invert=invert).numpy()
    assert got.shape == want.shape == (64, 96)
    assert want.min() > 0 and want.std() > 0.05 * want.mean()
    assert _rel_l2(got, want) <= DPT_RELL2
    assert np.max(np.abs(got - want) / np.abs(want)) <= DPT_MAX_REL


def test_port_init_matches_converted_layout(weights):
    """``init_dpt_params`` has the structure and shapes that the converter
    gives the published checkpoint (which tests/test_dpt_convert.py holds
    to the JAX init)."""
    _, params = weights
    init = pdpt.init_dpt_params(torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(init) == shapes(params)


# ---------------------------------------------------------------------------
# the input transform (cv2 INTER_CUBIC in the JAX package)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(540, 960), (120, 160), (24, 400), (300, 200),
                                (384, 384), (500, 375), (33, 47), (720, 1280)])
def test_dpt_input_transform_matches_jax(hw):
    """The output size (540x960 -> 384x672) and values within 1e-6 of the
    JAX transform on uniform noise, downscaling and upscaling."""
    img = np.random.default_rng(hw[0]).uniform(size=(*hw, 3)).astype(
        np.float32)
    want = jdpt.dpt_input_transform(img)
    got = pdpt.dpt_input_transform(img)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if hw == (540, 960):
        assert got.shape == (384, 672, 3)
    assert np.max(np.abs(got - want)) <= 1e-6


# ---------------------------------------------------------------------------
# both preprocessing CLIs on one scene
# ---------------------------------------------------------------------------


def _write_scene(base, frames=4, hw=(24, 400)):
    """A synthetic scene on disk; 24x400 frames transform to 32x384, the
    smallest input the 384 target allows."""
    argv = sys.argv
    sys.argv = ["x", str(base / "scene"), "--frames", str(frames),
                "--height", str(hw[0]), "--width", str(hw[1])]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv


def test_dpt_depth_cli_matches_jax(weights, tmp_path):
    """``python -m nope_nerf_tpu_torch.dpt_depth`` and
    ``preprocess/dpt_depth.py`` on the same scene and weights: the same
    files, ``pred`` (1, 32, 384) within the network's tolerance, PNGs
    within 1 level; a missing weights file and a non-DPT config raise."""
    import importlib.util

    from PIL import Image

    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu_torch import dpt_depth
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    tree, _ = weights
    _write_scene(tmp_path)
    npz = str(tmp_path / "dpt.npz")
    save_pytree(npz, {"params": tree})

    def cfg_file(depth_net, path=npz, dtype="DPT"):
        p = tmp_path / f"{depth_net}.yaml"
        p.write_text(yaml.safe_dump({
            "depth": {"type": dtype, "path": path},
            "dataloading": {"path": str(tmp_path), "scene": ["scene"],
                            "resize_factor": None, "depth_net": depth_net},
            "training": {"mode": "all"}}))
        return str(p)

    spec = importlib.util.spec_from_file_location(
        "jax_dpt_depth", os.path.join(ROOT, "preprocess", "dpt_depth.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcli.main(jload(cfg_file("dpt_jax"), DEFAULT_CONFIG))
    out = dpt_depth.main(load_config(cfg_file("dpt_port"), DEFAULT_CONFIG),
                         device="cpu")
    jdir = tmp_path / "scene" / "dpt_jax"
    assert out == str(tmp_path / "scene" / "dpt_port")
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(out)) == names
    assert len([n for n in names if n.endswith(".npz")]) == 4
    for n in names:
        if n.endswith(".npz"):
            want = np.load(jdir / n)["pred"]
            got = np.load(os.path.join(out, n))["pred"]
            assert got.shape == want.shape == (1, 32, 384)
            assert got.dtype == np.float32
            assert _rel_l2(got, want) <= DPT_RELL2
            assert np.max(np.abs(got - want) / np.abs(want)) <= DPT_MAX_REL
        else:
            want = np.asarray(Image.open(jdir / n), np.int32)
            got = np.asarray(Image.open(os.path.join(out, n)), np.int32)
            assert got.shape == want.shape
            assert np.max(np.abs(got - want)) <= 1

    with pytest.raises(FileNotFoundError):
        dpt_depth.main(load_config(cfg_file("a", path=str(tmp_path / "no")),
                                   DEFAULT_CONFIG), device="cpu")
    with pytest.raises(AssertionError, match="depth.type: DPT"):
        dpt_depth.main(load_config(cfg_file("b", dtype="None"),
                                   DEFAULT_CONFIG), device="cpu")
