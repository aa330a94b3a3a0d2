"""Look for the op that makes an eager training step not deterministic. On
one GPU:

    python3 tools/torch_determinism_probe.py [REPEATS]

For the stock config and for ``ssim_normal`` (``training.with_ssim`` and
``rendering.normal_loss``, chip_smoke.py's scan phase setup):

1. runs chip_smoke's eager epochs (``scan_route``) REPEATS times (default
   4) from one state and says which repeats equal the first bit for bit
   (losses, parameters, Adam moments);
2. runs them once more under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` and prints each distinct warning, i.e. each op that
   has no deterministic implementation on the card;
3. reruns the SSIM loss map's backward (``ops/ssim.py``) at the step's
   image shape 20 times on one input, as a whole and by parts (the
   reflection padding, the depthwise convolution's input gradient), and
   counts the distinct results of each (``F.pad``'s reflect mode beside
   ``ssim.reflect_pad1``, which the map uses).

Part 3 is the evidence that named ``F.pad``'s reflect backward as the
op; the guards of the fix are the card test
``test_captured_epoch_equals_eager_epoch[ssim_normal]`` and chip_smoke's
scan phase. Needs a CUDA device.
"""
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = (("stock", {}),
           ("ssim_normal", {"training": {"with_ssim": True},
                            "rendering": {"normal_loss": True}}))
OP_REPEATS = 20


def same(a, b):
    import torch

    return (torch.equal(a["losses"], b["losses"]) and all(
        torch.equal(x, y) for key in ("params", "moments")
        for x, y in zip(a[key], b[key])))


def distinct(fn):
    """How many distinct results OP_REPEATS calls of ``fn`` give."""
    import torch

    outs = []
    for _ in range(OP_REPEATS):
        out = fn()
        if not any(torch.equal(out, o) for o in outs):
            outs.append(out)
    return len(outs)


def ssim_ops(dev, shape, log):
    """Step 3 on seeded (h, w, 3) images of ``shape``."""
    import torch
    import torch.nn.functional as F

    from nope_nerf_tpu_torch.ops import ssim

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(shape, device=dev, generator=gen)
    y = torch.rand(shape, device=dev, generator=gen).requires_grad_()
    g = torch.rand(shape, device=dev, generator=gen)

    def whole():
        return torch.autograd.grad(ssim.ssim_loss_map(x, y), y, g)[0]

    xp = x.permute(2, 0, 1)[None].contiguous().requires_grad_()
    gp = torch.rand(1, 3, shape[0] + 2, shape[1] + 2, device=dev,
                    generator=gen)

    def reflect():
        out = F.pad(xp, (1, 1, 1, 1), mode="reflect")
        return torch.autograd.grad(out, xp, gp)[0]

    xs = x.clone().requires_grad_()
    gs = gp[0].permute(1, 2, 0)

    def reflect_slices():
        return torch.autograd.grad(ssim.reflect_pad1(xs), xs, gs)[0]

    box = torch.full((3, 1, 3, 3), 1.0 / 9.0, device=dev)

    def conv_input():
        return torch.nn.grad.conv2d_input(gp.shape, box, g.permute(
            2, 0, 1)[None].contiguous(), padding=0, groups=3)

    for name, fn in (("ssim_loss_map backward", whole),
                     ("F.pad reflect backward", reflect),
                     ("reflect_pad1 backward", reflect_slices),
                     ("depthwise conv2d_input", conv_input)):
        log(f"  {name} at {tuple(shape)}: {distinct(fn)} distinct results "
            f"in {OP_REPEATS} calls")


def main(argv):
    import torch

    import chip_smoke as cs
    from nope_nerf_tpu_torch import _build
    from nope_nerf_tpu_torch.losses import losses

    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    repeats = int(argv[0]) if argv else 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.load_library()

    def log(msg):
        print(msg, flush=True)

    log(cs.card_line())
    shapes = []
    real = losses.rgb_s_loss

    def rgb_s_loss(rgb1, *a, **k):
        shapes.append(tuple(rgb1.shape))
        return real(rgb1, *a, **k)

    for label, overrides in CONFIGS:
        setup = cs.scan_setup(dev, overrides)
        losses.rgb_s_loss = rgb_s_loss
        try:
            runs = [cs.scan_route(dev, setup, False, timed=False)
                    for _ in range(repeats)]
        finally:
            losses.rgb_s_loss = real
        log(f"{label}: {repeats} eager runs of {cs.EPOCHS} epochs from one "
            "state, bitwise the first: "
            f"{[same(r, runs[0]) for r in runs[1:]]}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                cs.scan_route(dev, setup, False, timed=False)
            finally:
                torch.use_deterministic_algorithms(False)
        msgs = sorted({str(w.message).split("\n")[0][:240] for w in caught})
        log(f"{label}: under use_deterministic_algorithms(warn_only), "
            f"{len(msgs)} distinct warnings")
        for m in msgs:
            log(f"  {m}")
        del runs
        torch.cuda.empty_cache()
    if shapes:
        ssim_ops(dev, shapes[-1], log)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
