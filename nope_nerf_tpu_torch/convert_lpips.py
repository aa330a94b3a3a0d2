"""Convert VGG16 features + LPIPS linear-head weights into the npz the port
and the JAX package load (the port's twin of ``tools/convert_lpips.py``):

    python -m nope_nerf_tpu_torch.convert_lpips out.npz --vgg vgg16.pth --lin lpips_vgg.pth

``--vgg`` is a ``torchvision.models.vgg16().features`` state dict, ``--lin``
the ``lpips`` package's VGG heads (``lin<i>.model.1.weight``). Both are
required: this tool never downloads, so it does not fall back to
torchvision's or lpips' own weights as the JAX tool does. ``out`` defaults
to ``models.lpips.DEFAULT_WEIGHTS``. Writes the same tree and leaves as the
JAX tool, with the port's ``training.checkpoints.save_pytree``.
"""
import argparse
import os

import numpy as np

from .training.checkpoints import save_pytree

# vgg16.features conv indices: 0,2, 5,7, 10,12,14, 17,19,21, 24,26,28
CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def convert(vgg_sd, lin_sd):
    """(vgg16.features state dict, lpips linear-head dict) -> the LPIPS tree
    of numpy arrays in the JAX package's layout: conv weights OIHW -> HWIO,
    heads (1, C, 1, 1) -> (C, 1)."""
    convs = {}
    for i, ci in enumerate(CONV_IDX):
        w = np.asarray(vgg_sd[f"{ci}.weight"]).transpose(2, 3, 1, 0)
        convs[str(i)] = {"w": w, "b": np.asarray(vgg_sd[f"{ci}.bias"])}
    lins = {str(i): {"w": np.asarray(lin_sd[f"lin{i}.model.1.weight"])
                     .reshape(-1)[:, None]} for i in range(5)}
    return {"convs": convs, "lins": lins}


def main(argv=None):
    from .models.lpips import DEFAULT_WEIGHTS

    ap = argparse.ArgumentParser(description="Convert VGG16 + LPIPS head "
                                 "state dicts to the LPIPS npz.")
    ap.add_argument("out", nargs="?", default=DEFAULT_WEIGHTS)
    ap.add_argument("--vgg", default=None,
                    help="torchvision vgg16().features state dict .pth")
    ap.add_argument("--lin", default=None,
                    help="lpips VGG linear heads .pth (lin<i>.model.1.weight)")
    args = ap.parse_args(argv)
    missing = [f"--{k}" for k in ("vgg", "lin") if getattr(args, k) is None]
    if missing:
        raise SystemExit(
            f"convert_lpips: name {' and '.join(missing)}: the VGG16 "
            "features state dict (--vgg, torchvision's vgg16 IMAGENET1K_V1 "
            "'features' module) and the lpips package's VGG heads (--lin, "
            "lpips/weights/v0.1/vgg.pth); nothing is downloaded")

    import torch

    vgg_sd = torch.load(args.vgg, map_location="cpu")
    lin_sd = torch.load(args.lin, map_location="cpu")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_pytree(args.out, {"params": convert(vgg_sd, lin_sd)})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
