"""The port's three weight and checkpoint converters against the JAX
package's tools, on the fixtures of the JAX package's own converter tests:
the same npz entries, bit for bit (every leaf's dtype, shape and bytes, and
the JSON scalars), and every checkpoint key read.
"""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from test_dpt_convert import _Tracking, synth_state_dict  # noqa: E402
from test_lpips_convert import synth_dicts  # noqa: E402
from test_reference_ckpt_convert import save_reference_ckpts  # noqa: E402


def _assert_npz_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def _run_tool(main, argv):
    """A JAX tool's ``main()``, which reads ``sys.argv``."""
    saved = sys.argv
    sys.argv = ["tool", *argv]
    try:
        return main()
    finally:
        sys.argv = saved


def _tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def test_convert_dpt_matches_jax_tool(tmp_path):
    """A seeded checkpoint with every key and shape of
    dpt_hybrid-midas-501f0c75.pt, wrapped under "model" as some releases
    are: the port's CLI writes the JAX tool's npz, and its ``convert``
    reads every key."""
    import convert_dpt as jtool

    from nope_nerf_tpu_torch import convert_dpt

    state = synth_state_dict(np.random.default_rng(0))
    tracked = _Tracking(state)
    convert_dpt.convert(tracked)
    assert set(tracked) == tracked.read
    pt = str(tmp_path / "dpt.pt")
    torch.save({"model": _tensors(state)}, pt)
    del state, tracked
    _run_tool(jtool.main, [pt, str(tmp_path / "jax.npz")])
    convert_dpt.main([pt, str(tmp_path / "port.npz")])
    _assert_npz_equal(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))


def test_convert_lpips_matches_jax_tool(tmp_path):
    """Seeded vgg16.features and LPIPS-head state dicts: the same npz as
    the JAX tool's; without ``--vgg`` / ``--lin`` the port names them and
    writes nothing."""
    import convert_lpips as jtool

    from nope_nerf_tpu_torch import convert_lpips

    vgg_sd, lin_sd = synth_dicts(np.random.default_rng(7))
    vgg, lin = _Tracking(vgg_sd), _Tracking(lin_sd)
    convert_lpips.convert(vgg, lin)
    assert set(vgg) == vgg.read and set(lin) == lin.read
    torch.save(_tensors(vgg_sd), str(tmp_path / "vgg16.pth"))
    torch.save(_tensors(lin_sd), str(tmp_path / "lin.pth"))
    args = ["--vgg", str(tmp_path / "vgg16.pth"),
            "--lin", str(tmp_path / "lin.pth")]
    _run_tool(jtool.main, [str(tmp_path / "jax.npz"), *args])
    convert_lpips.main([str(tmp_path / "port" / "port.npz"), *args])
    _assert_npz_equal(str(tmp_path / "port" / "port.npz"),
                      str(tmp_path / "jax.npz"))
    with pytest.raises(SystemExit, match="--vgg and --lin"):
        convert_lpips.main([str(tmp_path / "none.npz")])
    with pytest.raises(SystemExit, match="name --lin"):
        convert_lpips.main([str(tmp_path / "none.npz"), *args[:2]])
    assert not (tmp_path / "none.npz").exists()


def _reference_dir(tmp_path, backups=False):
    """The four reference streams of tests/test_reference_ckpt_convert.py,
    live or as numbered backups 100 and 200 (200 differs)."""
    src = tmp_path / "pt"
    rng = np.random.default_rng(4)
    save_reference_ckpts(str(src), rng, n_cams=5,
                         init_c2w=np.tile(np.eye(4), (5, 1, 1)), fy=1.3)
    if backups:
        for name in os.listdir(src):
            stem = name[:-3]
            os.rename(src / name, src / f"{stem}_100.pt")
        save_reference_ckpts(str(tmp_path / "pt2"), rng, n_cams=5)
        for name in os.listdir(tmp_path / "pt2"):
            os.rename(tmp_path / "pt2" / name, src / f"{name[:-3]}_200.pt")
    return src


@pytest.mark.parametrize("case", ["dir", "single_file", "backups_latest",
                                  "backups_step", "strict"])
def test_convert_reference_matches_jax_tool(tmp_path, monkeypatch, case):
    """Directory scan, one ``.pt``, the highest numbered backup, ``--step``
    and ``--strict`` on an extra key: the port writes the JAX tool's
    streams (trees, resume scalars, no Adam moments), or raises as it
    does."""
    import convert_reference_ckpt as jtool

    from nope_nerf_tpu_torch import convert_reference

    # the JAX tool keeps --strict in a module global: restore it afterwards
    monkeypatch.setattr(jtool, "STRICT", jtool.STRICT)
    src = _reference_dir(tmp_path, backups=case.startswith("backups"))
    args = {"dir": [str(src)],
            "single_file": [str(src / "model_pose.pt")],
            "backups_latest": [str(src)],
            "backups_step": [str(src), "--step", "100"],
            "strict": [str(src), "--strict"]}[case]
    if case == "strict":
        ckpt = torch.load(str(src / "model.pt"), weights_only=True)
        ckpt["model"]["renderer.extra.weight"] = torch.zeros(2)
        torch.save(ckpt, str(src / "model.pt"))
        with pytest.raises(ValueError, match="--strict: unrecognised") as e1:
            jtool.main([*args[:1], str(tmp_path / "jax"), *args[1:]])
        with pytest.raises(ValueError, match="--strict: unrecognised") as e2:
            convert_reference.main([*args[:1], str(tmp_path / "port"),
                                    *args[1:]])
        assert str(e1.value) == str(e2.value)
        return
    jtool.main([*args[:1], str(tmp_path / "jax"), *args[1:]])
    written = convert_reference.main([*args[:1], str(tmp_path / "port"),
                                      *args[1:]])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert sorted(os.path.basename(p) for p in written) == names
    assert len(names) == (1 if case == "single_file" else 4)
    for n in names:
        _assert_npz_equal(str(tmp_path / "port" / n), str(tmp_path / "jax" / n))


def test_chip_smoke_reference_layers():
    """chip_smoke.py's own list of the reference NeRF's Linear layers, from
    which its round trip writes the ``.pt`` fixture, names every layer of
    the JAX package's fixture once, pairs each with the port's parameter as
    the JAX tool maps it, and covers every NeRF parameter of the port."""
    import chip_smoke
    import convert_reference_ckpt as jtool
    from test_reference_ckpt_convert import synth_nerf_state

    from nope_nerf_tpu_torch.models.nerf import init_nerf_params

    layers = chip_smoke.REF_NERF_LAYERS
    keys = {f"renderer.model.{ref}.{kind}" for ref, _ in layers
            for kind in ("weight", "bias")}
    assert len(keys) == 2 * len(layers)
    assert keys == set(synth_nerf_state(np.random.default_rng(0)))
    assert dict(layers) == jtool._NERF_LAYER_MAP
    params = init_nerf_params(torch.Generator().manual_seed(0),
                              chip_smoke.stock_cfg())
    assert sorted(ours for _, ours in layers) == sorted(params)
