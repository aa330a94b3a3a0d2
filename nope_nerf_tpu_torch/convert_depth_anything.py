"""Convert the published Depth Anything V2 checkpoint into the npz that
``dpt_depth`` loads with ``depth.type: DepthAnythingV2``:

    python -m nope_nerf_tpu_torch.convert_depth_anything depth_anything_v2_vitl.pth depth_anything_v2_vitl.npz

Maps the published module names (``pretrained.*`` for the DINOv2 encoder,
``depth_head.*`` for the DPT head) onto the port's parameter tree
(``models/depth_anything.py::param_shapes``), keeping PyTorch's layouts,
and writes it with ``training.checkpoints.save_pytree``. The widths are
read from the checkpoint itself (ViT-L: 1024 wide, 24 blocks, MLP 4096, a
37x37 position grid), and every tensor is checked against the shape they
give it: a key that is missing or misshapen is refused by name. The
``mask_token`` (used only in DINOv2's training) is not kept. Needs only
torch to unpickle; downloads nothing.
"""
import argparse
import re

import numpy as np

from .models.depth_anything import param_shapes
from .training.checkpoints import save_pytree

ENC, HEAD = "pretrained.", "depth_head."


def _names(n_blocks):
    """The port's tree with each leaf the published name it comes from."""
    def conv(pre, bias=True):
        p = {"w": pre + ".weight"}
        if bias:
            p["b"] = pre + ".bias"
        return p

    def norm(pre):
        return {"scale": pre + ".weight", "bias": pre + ".bias"}

    sc = HEAD + "scratch."

    def fusion(r):
        pre = f"{sc}refinenet{r}."
        return {f"rcu{u}": {f"conv{c}": conv(f"{pre}resConfUnit{u}.conv{c}")
                            for c in (1, 2)} for u in (1, 2)} | {
            "out_conv": conv(pre + "out_conv")}

    return {
        "patch_embed": conv(ENC + "patch_embed.proj"),
        "cls_token": ENC + "cls_token",
        "pos_embed": ENC + "pos_embed",
        "blocks": [{"ln1": norm(f"{ENC}blocks.{i}.norm1"),
                    "qkv": conv(f"{ENC}blocks.{i}.attn.qkv"),
                    "proj": conv(f"{ENC}blocks.{i}.attn.proj"),
                    "ls1": f"{ENC}blocks.{i}.ls1.gamma",
                    "ln2": norm(f"{ENC}blocks.{i}.norm2"),
                    "mlp1": conv(f"{ENC}blocks.{i}.mlp.fc1"),
                    "mlp2": conv(f"{ENC}blocks.{i}.mlp.fc2"),
                    "ls2": f"{ENC}blocks.{i}.ls2.gamma"}
                   for i in range(n_blocks)],
        "norm": norm(ENC + "norm"),
        "projects": [conv(f"{HEAD}projects.{i}") for i in range(4)],
        **{f"resize{i}": conv(f"{HEAD}resize_layers.{i}") for i in (0, 1, 3)},
        "scratch": {f"layer{i}_rn": conv(f"{sc}layer{i}_rn", bias=False)
                    for i in (1, 2, 3, 4)},
        **{f"refinenet{r}": fusion(r) for r in (1, 2, 3, 4)},
        "head": {"conv1": conv(sc + "output_conv1"),
                 "conv2": conv(sc + "output_conv2.0"),
                 "conv3": conv(sc + "output_conv2.2")},
    }


def _get(state, key):
    if key not in state:
        raise KeyError(f"the checkpoint has no {key!r}")
    return np.asarray(state[key], dtype=np.float32)


def _widths(state):
    """The widths :func:`param_shapes` takes, read from the checkpoint."""
    blocks = {int(m.group(1)) for k in state
              if (m := re.match(re.escape(ENC) + r"blocks\.(\d+)\.", k))}
    n = len(blocks)
    if blocks != set(range(n)) or not n:
        raise KeyError(f"the checkpoint's encoder blocks are {sorted(blocks)}")
    pos = _get(state, ENC + "pos_embed").shape[1] - 1
    return {"dim": _get(state, ENC + "cls_token").shape[-1], "blocks": n,
            "mlp": _get(state, ENC + "blocks.0.mlp.fc1.weight").shape[0],
            "pos_grid": int(round(pos ** 0.5)),
            "out_channels": tuple(
                _get(state, f"{HEAD}projects.{i}.weight").shape[0]
                for i in range(4)),
            "features": _get(state, HEAD + "scratch.layer1_rn.weight"
                             ).shape[0],
            "patch": _get(state, ENC + "patch_embed.proj.weight").shape[-1]}


def convert(state):
    """The checkpoint's state dict (tensors or arrays) -> the port's tree
    of f32 numpy arrays. Raises KeyError naming a missing key and
    ValueError naming a key whose shape the checkpoint's widths do not
    give."""
    def walk(names, shapes):
        if isinstance(names, dict):
            return {k: walk(names[k], shapes[k]) for k in names}
        if isinstance(names, list):
            return [walk(n, s) for n, s in zip(names, shapes)]
        a = _get(state, names)
        if a.shape != tuple(shapes):
            raise ValueError(f"{names!r} has shape {a.shape}, the "
                             f"checkpoint's widths give {tuple(shapes)}")
        return a

    widths = _widths(state)
    return walk(_names(widths["blocks"]), param_shapes(**widths))


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description="Convert the Depth Anything V2 "
                                 "torch checkpoint to the npz parameter "
                                 "tree.")
    ap.add_argument("src", help="depth_anything_v2_vitl.pth")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)
    state = torch.load(args.src, map_location="cpu")
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    save_pytree(args.dst, {"params": convert(dict(state))}, source=args.src)
    print(f"converted {len(state)} tensors -> {args.dst}")


if __name__ == "__main__":
    main()
