"""The port's end-to-end scripts and their scene against the JAX package's.

- ``scripts/torch_reproduce_synthetic.sh`` and
  ``scripts/torch_paper_scale_synthetic.sh`` write the ``scene.yaml`` of
  ``scripts/reproduce_synthetic.sh`` and ``scripts/paper_scale_synthetic.sh``
  key for key: each heredoc is parsed with ``$OUT`` and the arguments
  substituted (each script's own defaults, and ``band 4``).
- ``tests/fixtures/teacher_seed{3,4}.npz`` (``tools/torch_teacher_fixture.py``)
  hold the JAX teacher, ``init_nerf_params(PRNGKey(seed + 100))`` at width
  64 with ``trunk0_0.w`` x 4, leaf for leaf.
- ``python -m nope_nerf_tpu_torch.make_synthetic_dataset --teacher`` writes
  the files of ``tools/make_synthetic_dataset.py`` at that seed: PNG frames
  within +-1, DPT depths within 1e-5, ``poses_bounds.npy`` exactly (the bars
  of ``tests/test_torch_synthetic.py::test_dataset_writer_matches_jax_tool``).
- ``chip_smoke.py``'s recovery phase runs the reproduction script's
  scene.yaml, seed and size.
"""
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TWINS = (("reproduce_synthetic.sh", "torch_reproduce_synthetic.sh"),
         ("paper_scale_synthetic.sh", "torch_paper_scale_synthetic.sh"))


def _scene_yaml(script, args):
    """The script's scene.yaml as a dict: its heredoc with ``$OUT`` set to
    /out, the positional defaults (``NAME=${N:-default}``) replaced by
    ``args`` where given, and every other variable at its default."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        text = f.read()
    values = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}$", text, re.M))
    values.update(args, OUT="/out")
    body = re.search(r'cat > "\$OUT/scene.yaml" <<(\w+)\n(.*?)\n\1\n', text,
                     re.S).group(2)
    return yaml.safe_load(re.sub(r"\$(\w+)", lambda m: values[m.group(1)],
                                 body))


@pytest.mark.parametrize("args", [{}, {"CHAMFER_MODE": "band",
                                       "RAYS_MULT": "4"}],
                         ids=["defaults", "band_4"])
@pytest.mark.parametrize("jax_script,port_script", TWINS,
                         ids=["reproduce", "paper_scale"])
def test_twin_scripts_write_the_same_scene_yaml(jax_script, port_script,
                                                args):
    want = _scene_yaml(jax_script, args)
    assert _scene_yaml(port_script, args) == want
    assert want["dataloading"]["path"] == "/out/data"
    if "tpu" in want:
        assert want["tpu"]["chamfer_mode"] == args.get("CHAMFER_MODE",
                                                       "exact")


@pytest.mark.parametrize("seed", [3, 4])
def test_teacher_fixture_is_the_jax_teacher(seed):
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.training.checkpoints import load_pytree

    cfg = {"model": {"hidden_dim": 64, "pos_enc_levels": 4,
                     "dir_enc_levels": 2, "occ_activation": "softplus"},
           "rendering": {"white_background": False}}
    want = jax.device_get(init_nerf_params(jax.random.PRNGKey(seed + 100),
                                           cfg))
    want["trunk0_0"]["w"] = want["trunk0_0"]["w"] * 4.0
    got, scalars, _ = load_pytree(os.path.join(FIXTURES,
                                               f"teacher_seed{seed}.npz"))
    assert scalars == {"seed": seed}
    assert sorted(got) == sorted(want)
    for layer, p in want.items():
        assert sorted(got[layer]) == sorted(p), layer
        for k, v in p.items():
            assert got[layer][k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[layer][k], np.asarray(v),
                                          err_msg=f"{layer}/{k}")


def test_dataset_cli_with_teacher_matches_jax_tool(tmp_path):
    from nope_nerf_tpu_torch.make_synthetic_dataset import main as port_gen

    size = ["--frames", "4", "--height", "16", "--width", "20", "--seed", "3"]
    argv = sys.argv
    sys.argv = ["x", str(tmp_path / "jax")] + size
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    port_gen([str(tmp_path / "port")] + size + [
        "--teacher", os.path.join(FIXTURES, "teacher_seed3.npz"),
        "--device", "cpu"])

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want and len(got) == 9
    for name in got:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".png"):
            pa = np.asarray(Image.open(a)).astype(np.int64)
            pb = np.asarray(Image.open(b)).astype(np.int64)
            assert pa.shape == pb.shape and np.abs(pa - pb).max() <= 1, name
        elif name.endswith(".npz"):
            np.testing.assert_allclose(np.load(a)["pred"], np.load(b)["pred"],
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b))
    # without --teacher the port draws its own field: another scene
    port_gen([str(tmp_path / "own")] + size + ["--device", "cpu"])
    own = np.asarray(Image.open(tmp_path / "own" / "images" / "000.png"))
    theirs = np.asarray(Image.open(tmp_path / "jax" / "images" / "000.png"))
    assert np.abs(own.astype(np.int64) - theirs).max() > 3


def test_smoke_recovery_phase_runs_the_script_config():
    """``chip_smoke.py``'s recovery phase trains on the scene.yaml of
    ``scripts/torch_reproduce_synthetic.sh`` at its default seed and size,
    so its epochs are the first epochs of that script's run."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.recovery_scene_yaml("/out") == _scene_yaml(
        "torch_reproduce_synthetic.sh", {})
    script = open(os.path.join(ROOT, "scripts",
                               "torch_reproduce_synthetic.sh")).read()
    assert f"SEED=${{2:-{chip_smoke.REC_SEED}}}" in script
    assert f"FRAMES=${{FRAMES:-{chip_smoke.REC_FRAMES}}}" in script
    assert (f"HEIGHT=${{HEIGHT:-{chip_smoke.REC_HW[0]}}}" in script
            and f"WIDTH=${{WIDTH:-{chip_smoke.REC_HW[1]}}}" in script)
