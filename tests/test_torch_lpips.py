"""The port's LPIPS metric against the JAX package's, on seeded VGG16 and
LPIPS-head weights laid out as the published ones, and the port's eval CLI
scoring it as ``evaluation/eval.py`` does.
"""
import os
import sys

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_lpips_convert import synth_dicts  # noqa: E402

LPIPS_REL = 2e-4  # tests/test_lpips_convert.py's bar against torch


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    """The port converter's tree of seeded weights, saved as the npz both
    packages load."""
    from nope_nerf_tpu_torch.convert_lpips import convert
    from nope_nerf_tpu_torch.training.checkpoints import save_pytree

    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    save_pytree(path, {"params": convert(*synth_dicts(
        np.random.default_rng(7)))})
    return path


@pytest.mark.parametrize("hw", [(40, 48), (37, 53)])
def test_lpips_matches_jax(weights_npz, hw):
    """LPIPS between two random images within rel LPIPS_REL of the JAX
    metric (odd sizes: the VALID pools floor), and 0 for identical
    images."""
    from nope_nerf_tpu.models.lpips import load_lpips as jload
    from nope_nerf_tpu_torch.models.lpips import load_lpips

    rng = np.random.default_rng(hw[1])
    a, b = (rng.uniform(size=(*hw, 3)).astype(np.float32) for _ in range(2))
    mine, theirs = load_lpips(weights_npz, "cpu"), jload(weights_npz)
    want = theirs(a, b)
    assert want > 1e-3
    assert mine(a, b) == pytest.approx(want, rel=LPIPS_REL)
    assert mine(a, a) == pytest.approx(0.0, abs=1e-8)


def test_lpips_params_accept_lists_or_digit_keys(weights_npz):
    """The npz round trip gives lists; a converter's tree has digit-keyed
    dicts; both load into the same parameters. A missing file raises
    FileNotFoundError, the only error the eval CLI turns into nan."""
    from nope_nerf_tpu_torch.convert import lpips_params_from_jax
    from nope_nerf_tpu_torch.convert_lpips import convert
    from nope_nerf_tpu_torch.models.lpips import (init_lpips_params,
                                                  load_lpips)
    from nope_nerf_tpu_torch.training.checkpoints import load_pytree

    listed = load_pytree(weights_npz)[0]["params"]
    assert isinstance(listed["convs"], list)
    keyed = convert(*synth_dicts(np.random.default_rng(7)))
    assert isinstance(keyed["convs"], dict)
    a, b = lpips_params_from_jax(listed), lpips_params_from_jax(keyed)
    init = init_lpips_params(torch.Generator().manual_seed(0))
    for group in ("convs", "lins"):
        assert len(a[group]) == len(b[group]) == len(init[group])
        for pa, pb, pi in zip(a[group], b[group], init[group]):
            for k in pa:
                assert torch.equal(pa[k], pb[k])
                assert pa[k].shape == pi[k].shape
    with pytest.raises(FileNotFoundError):
        load_lpips(str(weights_npz) + ".missing", "cpu")


def test_eval_reports_lpips_like_jax(weights_npz, tmp_path, capsys):
    """The port's ``eval`` with ``extract_images.lpips_weights`` set scores
    each training view (``type_to_eval: train``, f32 plain renderer on both
    sides) with the LPIPS of the JAX ``evaluation/eval.py``; with the file
    missing both print nan."""
    import importlib.util

    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu_torch import eval as peval
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.convert import params_to_numpy
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO

    argv = sys.argv
    sys.argv = ["x", str(tmp_path / "data" / "synth"), "--frames", "3",
                "--height", "32", "--width", "40"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    out = tmp_path / "out"
    cfg = {
        "dataloading": {"path": str(tmp_path / "data"), "scene": ["synth"],
                        "resize_factor": None, "spherify": False},
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 16, "depth_range": [0.5, 6.0]},
        "pose": {"learn_pose": False, "learn_focal": False},
        "training": {"out_dir": str(out)},
        "eval_pose": {"type_to_eval": "train"},
        "extract_images": {"lpips_weights": weights_npz},
        "tpu": {"use_pallas_mlp": False, "mlp_bf16": False},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    nerf = init_nerf_params(torch.Generator().manual_seed(0),
                            load_config(str(path), DEFAULT_CONFIG))
    CheckpointIO(str(out)).save("model.npz", {"params": params_to_numpy(nerf)})

    spec = importlib.util.spec_from_file_location(
        "jax_eval", os.path.join(ROOT, "evaluation", "eval.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    theirs = jmod.main(jload(str(path), DEFAULT_CONFIG))
    jlines = [ln for ln in capsys.readouterr().out.splitlines()
              if " img: PSNR: " in ln]
    mine = peval.main(load_config(str(path), DEFAULT_CONFIG), device="cpu")
    plines = [ln for ln in capsys.readouterr().out.splitlines()
              if " img: PSNR: " in ln]
    assert len(plines) == len(jlines) == 3
    assert np.isfinite(mine["lpips"]) and mine["lpips"] > 1e-3
    assert mine["lpips"] == pytest.approx(theirs["lpips"], rel=LPIPS_REL)
    assert [ln.split("LPIPS")[1] for ln in plines] == \
        [ln.split("LPIPS")[1] for ln in jlines]

    cfg["extract_images"]["lpips_weights"] = str(tmp_path / "none.npz")
    path.write_text(yaml.safe_dump(cfg))
    res = peval.main(load_config(str(path), DEFAULT_CONFIG), device="cpu")
    printed = capsys.readouterr().out
    assert np.isnan(res["lpips"]) and "LPIPS weights not found" in printed
