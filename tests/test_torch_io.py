"""The port's host-side IO against the JAX package's: the scene loader, the
MJPEG-in-MP4 writer and the frustum PLY exporter give the same arrays and
the same bytes; and no module of the port imports the JAX package.
"""
import ast
import os
import sys
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 9-frame 16x20 scene written by tools/make_synthetic_dataset.py,
    with gt depths."""
    data = tmp_path_factory.mktemp("io_data")
    argv = sys.argv
    sys.argv = ["x", str(data / "synth"), "--frames", "9", "--height", "16",
                "--width", "20", "--gt-depth"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    return data


def _scene_cfg(data, with_depth, norm_depth):
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    cfg = load_config(DEFAULT_CONFIG)
    cfg["dataloading"].update(path=str(data), scene=["synth"],
                              resize_factor=None, spherify=False,
                              with_depth=with_depth, norm_depth=norm_depth)
    return cfg


@pytest.mark.parametrize("mode,with_depth,norm_depth", [
    ("train", False, False), ("train", True, True), ("eval", False, False),
    ("eval", True, False)])
def test_get_scene_matches_jax(dataset, mode, with_depth, norm_depth):
    """Every field of the port's SceneData equals the JAX package's,
    arrays exactly."""
    from nope_nerf_tpu.dataloading.scene import get_scene as jget
    from nope_nerf_tpu_torch.dataloading.scene import get_scene

    cfg = _scene_cfg(dataset, with_depth, norm_depth)
    mine, theirs = vars(get_scene(cfg, mode)), vars(jget(cfg, mode))
    assert sorted(mine) == sorted(theirs)
    for key, want in theirs.items():
        got = mine[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key
    assert (mine["depth"] is not None) == with_depth


def test_sample_ref_idx_matches_jax(dataset):
    import random

    from nope_nerf_tpu.dataloading.scene import get_scene as jget
    from nope_nerf_tpu_torch.dataloading.scene import get_scene

    cfg = _scene_cfg(dataset, False, False)
    cfg["dataloading"]["random_ref"] = 3
    mine, theirs = get_scene(cfg), jget(cfg)
    ra, rb = random.Random(5), random.Random(5)
    for i in list(range(mine.N_imgs)) * 3:
        assert mine.sample_ref_idx(i, ra) == theirs.sample_ref_idx(i, rb)


class _FixedClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2024, 5, 6, 7, 8, 9, tzinfo=timezone.utc)


def test_write_mjpeg_mp4_matches_jax(tmp_path, monkeypatch):
    """The port's video reads back, through the JAX package's reader, to the
    JAX writer's frames; at one creation time the files are byte-equal."""
    from nope_nerf_tpu.utils import mp4 as jmp4
    from nope_nerf_tpu_torch.utils import mp4

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 24, 32, 3), dtype=np.uint8)
    a, b = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    mp4.write_mjpeg_mp4(a, frames, fps=30, quality=85)
    jmp4.write_mjpeg_mp4(b, frames, fps=30, quality=85)
    fa, fps_a = jmp4.read_mjpeg_mp4(a)
    fb, fps_b = jmp4.read_mjpeg_mp4(b)
    np.testing.assert_array_equal(fa, fb)
    assert fa.shape == frames.shape and fps_a == fps_b
    ra, rb = mp4.read_mjpeg_mp4(a)
    np.testing.assert_array_equal(ra, fa)
    assert ra.shape == frames.shape and rb == fps_a

    monkeypatch.setattr(mp4, "datetime", _FixedClock)
    monkeypatch.setattr(jmp4, "datetime", _FixedClock)
    mp4.write_mjpeg_mp4(a, frames[:2, ..., :1], fps=24)
    jmp4.write_mjpeg_mp4(b, frames[:2, ..., :1], fps=24)
    with open(a, "rb") as fa_, open(b, "rb") as fb_:
        assert fa_.read() == fb_.read()


def test_export_camera_frustums_matches_jax(tmp_path):
    from nope_nerf_tpu.utils.vis import export_camera_frustums as jexport
    from nope_nerf_tpu_torch.utils.vis import export_camera_frustums

    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(1)
    trajs = []
    for _ in range(2):
        c2w = np.tile(np.eye(4), (5, 1, 1))
        c2w[:, :3, :3] = Rotation.from_rotvec(
            rng.normal(scale=0.3, size=(5, 3))).as_matrix()
        c2w[:, :3, 3] = rng.normal(size=(5, 3))
        trajs.append(c2w)
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    export_camera_frustums(str(a), trajs, colors=[(0, 0, 255), (255, 0, 0)],
                           fov_deg=50.0, frustum_size=0.1)
    jexport(str(b), trajs, colors=[(0, 0, 255), (255, 0, 0)], fov_deg=50.0,
            frustum_size=0.1)
    assert a.read_bytes() == b.read_bytes()
    export_camera_frustums(str(a), trajs[:1], connect_centers=False)
    jexport(str(b), trajs[:1], connect_centers=False)
    assert a.read_bytes() == b.read_bytes()


def _jax_package_imports(path):
    """(line, name) of every import of nope_nerf_tpu in a source file, at
    any depth (top level, inside functions, importlib calls)."""

    def is_pkg(name):
        return name == "nope_nerf_tpu" or name.startswith("nope_nerf_tpu.")

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if is_pkg(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and is_pkg(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and is_pkg(arg.value)):
                found.append((node.lineno, arg.value))
    return found


def test_port_never_imports_jax_package():
    """An AST walk over every .py under nope_nerf_tpu_torch/ and over
    chip_smoke.py finds no import of nope_nerf_tpu at any depth."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nope_nerf_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = {os.path.relpath(p, ROOT): hits for p in files
           if (hits := _jax_package_imports(p))}
    assert not bad, bad


def test_import_walker_finds_nested_imports(tmp_path):
    """The walker above sees imports inside functions and importlib calls."""
    src = tmp_path / "m.py"
    src.write_text(
        "import os\n"
        "def f():\n"
        "    from nope_nerf_tpu.utils.mp4 import write_mjpeg_mp4\n"
        "    import nope_nerf_tpu\n"
        "    import importlib\n"
        "    importlib.import_module('nope_nerf_tpu.utils.vis')\n"
        "from nope_nerf_tpu_torch import eval\n"
        "from . import nope_nerf_tpu\n")
    assert [n for _, n in _jax_package_imports(str(src))] == [
        "nope_nerf_tpu.utils.mp4", "nope_nerf_tpu", "nope_nerf_tpu.utils.vis"]
