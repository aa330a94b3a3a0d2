"""Convert the published DPT-hybrid checkpoint into the npz the port and the
JAX package load (the port's twin of ``tools/convert_dpt.py``):

    python -m nope_nerf_tpu_torch.convert_dpt dpt_hybrid-midas-501f0c75.pt dpt_hybrid.npz

Maps the timm / DPT module names onto the DPT parameter tree (conv weights
OIHW -> HWIO, linear weights (out, in) -> (in, out), the JAX package's
layout, which is the file format of both packages; the port's
``models.dpt.load_dpt`` turns it back) and writes it with the port's
``training.checkpoints.save_pytree``: the same tree and leaves as the JAX
tool writes. Needs only torch to unpickle; downloads nothing.
"""
import argparse

import numpy as np

from .training.checkpoints import save_pytree

RESNET_LAYERS = (3, 4, 9)


def conv_w(t):
    return np.asarray(t).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def lin_w(t):
    return np.asarray(t).transpose(1, 0)


def arr(t):
    return np.asarray(t)


def _norm(state, pre):
    return {"scale": arr(state[pre + ".weight"]),
            "bias": arr(state[pre + ".bias"])}


def _conv(state, pre, bias=True):
    p = {"w": conv_w(state[pre + ".weight"])}
    if bias:
        p["b"] = arr(state[pre + ".bias"])
    return p


def _linear(state, pre):
    return {"w": lin_w(state[pre + ".weight"]), "b": arr(state[pre + ".bias"])}


def convert(state):
    """The checkpoint's state dict (tensors or arrays) -> the DPT tree of
    numpy arrays in the JAX package's layout. Reads every key of the
    published checkpoint once."""
    bb = "pretrained.model.patch_embed.backbone."
    stages = []
    for si, n in enumerate(RESNET_LAYERS):
        blocks = []
        for bi in range(n):
            pre = f"{bb}stages.{si}.blocks.{bi}."
            b = {}
            for ci in (1, 2, 3):
                b[f"conv{ci}"] = _conv(state, pre + f"conv{ci}", bias=False)
                b[f"norm{ci}"] = _norm(state, pre + f"norm{ci}")
            if pre + "downsample.conv.weight" in state:
                b["down_conv"] = _conv(state, pre + "downsample.conv",
                                       bias=False)
                b["down_norm"] = _norm(state, pre + "downsample.norm")
            blocks.append(b)
        stages.append(blocks)

    vm = "pretrained.model."
    P = {
        "resnet": {"stem_conv": _conv(state, bb + "stem.conv", bias=False),
                   "stem_norm": _norm(state, bb + "stem.norm"),
                   "stages": stages},
        "patch_proj": _conv(state, vm + "patch_embed.proj"),
        "cls_token": arr(state[vm + "cls_token"]),
        "pos_embed": arr(state[vm + "pos_embed"]),
        "blocks": [{"ln1": _norm(state, f"{vm}blocks.{i}.norm1"),
                    "qkv": _linear(state, f"{vm}blocks.{i}.attn.qkv"),
                    "proj": _linear(state, f"{vm}blocks.{i}.attn.proj"),
                    "ln2": _norm(state, f"{vm}blocks.{i}.norm2"),
                    "mlp1": _linear(state, f"{vm}blocks.{i}.mlp.fc1"),
                    "mlp2": _linear(state, f"{vm}blocks.{i}.mlp.fc2")}
                   for i in range(12)],
        "final_ln": _norm(state, vm + "norm"),
        "readout3": _linear(state, "pretrained.act_postprocess3.0.project.0"),
        "readout4": _linear(state, "pretrained.act_postprocess4.0.project.0"),
        "post3_conv": _conv(state, "pretrained.act_postprocess3.3"),
        "post4_conv1": _conv(state, "pretrained.act_postprocess4.3"),
        "post4_conv2": _conv(state, "pretrained.act_postprocess4.4"),
        "scratch": {f"layer{i}_rn": _conv(state, f"scratch.layer{i}_rn",
                                          bias=False) for i in (1, 2, 3, 4)},
    }
    for r in (1, 2, 3, 4):
        pre = f"scratch.refinenet{r}."
        P[f"refinenet{r}"] = {
            f"rcu{u}": {f"conv{c}": _conv(state,
                                          f"{pre}resConfUnit{u}.conv{c}")
                        for c in (1, 2)}
            for u in (1, 2)}
        P[f"refinenet{r}"]["out_conv"] = _conv(state, pre + "out_conv")
    P["head"] = {f"conv{j + 1}": _conv(state, f"scratch.output_conv.{i}")
                 for j, i in enumerate((0, 2, 4))}
    return P


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description="Convert the DPT-hybrid torch "
                                 "checkpoint to the npz parameter tree.")
    ap.add_argument("src", help="dpt_hybrid-midas-501f0c75.pt")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)
    state = torch.load(args.src, map_location="cpu")
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    save_pytree(args.dst, {"params": convert(dict(state))}, source=args.src)
    print(f"converted {len(state)} tensors -> {args.dst}")


if __name__ == "__main__":
    main()
