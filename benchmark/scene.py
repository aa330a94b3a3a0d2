"""The benchmark's inputs, made on the device from ``--seed``: the scene
(frames, depth priors, camera path) and the weights.

The scene generator is a frozen copy of the port's
``synthetic.MemoryScene`` generator, moved onto the device: seeded U[0, 1)
colours and 1 + U[0, 1) depth priors on a camera arc with a seeded phase,
split as the dataset loader splits a sequence (every ``sample_rate``-th
frame from ``sample_rate // 2`` on is held out). Everything is drawn from
one ``torch.Generator`` on the device in a few large calls, so the same
seed gives the same tensors on the same card.

The field's weights follow the port's parameter layout ({layer: {"w":
(fan_in, fan_out), "b": (fan_out,)}}) and its initial distribution
(U(-1/sqrt(fan_in), 1/sqrt(fan_in)), density bias 0.1, rgb bias 0.02), all
leaves from one draw. The layout is the interface of the system under test;
the values are the benchmark's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# a generator per purpose, so that adding a draw to one leaves the others
(STREAM_SCENE, STREAM_WEIGHTS, STREAM_FRAMES, STREAM_ORDER, STREAM_STEP,
 STREAM_SAMPLE) = range(6)


def seeded(seed, stream, device):
    """A generator on ``device`` for one purpose of one seed (seeds up to
    2**62 and beyond map to distinct 64-bit seeds)."""
    mixed = (int(seed) * 8 + stream) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def host_rng(seed, stream):
    """A numpy generator for host-side draws (frame orders, samples)."""
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def camera_matrix(spec):
    """The normalised K of the port's convention, diag(2f/W, -2f/H, -1, 1),
    from the configuration's square-pixel focal."""
    f, h, w = spec["focal_px"], spec["height"], spec["width"]
    return torch.tensor([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                         [0, 0, -1, 0], [0, 0, 0, 1]], dtype=torch.float32)


def path_c2ws(t, phase):
    """c2w (len(t), 4, 4) on the arc at parameters ``t`` in [0, 1]: a yaw
    of 0.3 t + phase and a translation (0.5 t, 0.05 sin(pi t), 0.2 t^2)."""
    yaw = 0.3 * t + phase
    c2w = torch.eye(4, dtype=torch.float32, device=t.device).repeat(
        len(t), 1, 1)
    c2w[:, 0, 0] = c2w[:, 2, 2] = torch.cos(yaw)
    c2w[:, 0, 2] = torch.sin(yaw)
    c2w[:, 2, 0] = -torch.sin(yaw)
    c2w[:, :3, 3] = torch.stack([0.5 * t, 0.05 * torch.sin(math.pi * t),
                                 0.2 * t * t], dim=1)
    return c2w


def split_ids(n_total, sample_rate):
    """(train ids, held-out ids) of a sequence of ``n_total`` frames."""
    ids = np.arange(n_total)
    test = ids[sample_rate // 2::sample_rate]
    return np.setdiff1d(ids, test), test


class Scene:
    """The frames of one configuration's sequence, on the device.

    train_imgs (N, H, W, 3), train_dpts (N, H, W), eval_imgs (E, H, W, 3),
    eval_c2ws (E, 4, 4), K (4, 4), phase (the arc's seeded yaw offset)."""

    def __init__(self, spec, seed, device):
        n, h, w = spec["frames_total"], spec["height"], spec["width"]
        g = seeded(seed, STREAM_SCENE, device)
        self.H, self.W = h, w
        self.K = camera_matrix(spec).to(device)
        self.phase = float(0.2 * torch.rand((), generator=g, device=device)
                           - 0.1)
        train, test = split_ids(n, spec["sample_rate"])
        t = torch.linspace(0.0, 1.0, n, device=device)
        c2ws = path_c2ws(t, self.phase)
        imgs = torch.rand((n, h, w, 3), generator=g, device=device)
        dpts = 1.0 + torch.rand((n, h, w), generator=g, device=device)
        tr, te = (torch.as_tensor(a, device=device) for a in (train, test))
        self.train_imgs, self.train_dpts = imgs[tr], dpts[tr]
        self.eval_imgs, self.eval_c2ws = imgs[te], c2ws[te]
        self.n_train, self.n_eval = len(train), len(test)
        del imgs, dpts

    def novel_c2ws(self, t):
        """Novel views at arc parameters ``t`` (a device tensor)."""
        return path_c2ws(t, self.phase)


def field_shapes(model_cfg):
    """[(layer, fan_in, fan_out)] of the 8x256 skip MLP in the port's
    order: four trunk layers on the position encoding, a skip layer on
    [h, encoding], three more, the density and feature heads, the
    direction layer on [feature, direction encoding] and the rgb head."""
    d = model_cfg["hidden_dim"]
    pos = (2 * model_cfg["pos_enc_levels"] + 1) * 3
    dirs = (2 * model_cfg["dir_enc_levels"] + 1) * 3
    shapes = [("trunk0_0", pos, d)] + [(f"trunk0_{i}", d, d)
                                       for i in (1, 2, 3)]
    shapes += [("trunk1_0", d + pos, d)] + [(f"trunk1_{i}", d, d)
                                            for i in (1, 2, 3)]
    shapes += [("fc_density", d, 1), ("fc_feature", d, d),
               ("rgb_layer", d + dirs, d // 2), ("fc_rgb", d // 2, 3)]
    return shapes


def field_weights(model_cfg, seed, device):
    """The field's parameter dict from one uniform draw on the device."""
    shapes = field_shapes(model_cfg)
    sizes = [fi * fo + fo for _, fi, fo in shapes]
    g = seeded(seed, STREAM_WEIGHTS, device)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    params, at = {}, 0
    for (name, fi, fo), size in zip(shapes, sizes):
        bound = 1.0 / math.sqrt(fi)
        block = flat[at:at + size] * bound
        params[name] = {"w": block[:fi * fo].reshape(fi, fo).clone(),
                        "b": block[fi * fo:].clone()}
        at += size
    params["fc_density"]["b"].fill_(0.1)
    params["fc_rgb"]["b"].fill_(0.02)
    return params


def frame_params(n_frames, seed, device):
    """Seeded poses near identity ({'r', 't'}: N(0, 0.01)) and depth
    scales near 1 and shifts near 0 ({'scales', 'shifts'}: N(0, 0.01)
    offsets), from one draw."""
    g = seeded(seed, STREAM_FRAMES, device)
    noise = 0.01 * torch.randn((4, n_frames, 3), generator=g, device=device)
    poses = {"r": noise[0].clone(), "t": noise[1].clone()}
    dist = {"scales": 1.0 + noise[2, :, :1].clone(),
            "shifts": noise[3, :, :1].clone()}
    return poses, dist


def focal_params(K):
    """The focal group of the port's 'gt' init at order 2: sqrt of
    [K00, -K11]."""
    return {"fx": torch.sqrt(K[0, 0]).clone(),
            "fy": torch.sqrt(-K[1, 1]).clone()}
