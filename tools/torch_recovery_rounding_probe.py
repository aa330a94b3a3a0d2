"""Run chip_smoke.py's recovery phase under other f32 roundings of the
backward, to see how its ATE gate depends on them. On one GPU:

    python3 tools/torch_recovery_rounding_probe.py fused layered fused_sm100 layered_halfsplits control ...

Each argument is one run of ``chip_smoke.run_recovery`` (the 20-frame
script's scene and config from identity poses, the gate and its bar
unchanged): ``fused`` runs the backward on the fused passes
(``mlp_kernel._chain_bwd``), ``layered`` on the layer-by-layer chain it
replaced (``_chain_bwd_layered``); a suffix changes only the order in which
the weight and bias gradients are summed: ``_smN`` computes every split
rule for N SMs instead of the card's, ``_halfsplits`` halves the splits of
the weight-gradient sums, ``_heads2`` doubles the rows per block of the
heads' pass. ``control`` runs the fused backward with the pose learning
rate at 0. ``REC_EPOCHS`` sets the epochs (0: the whole schedule; default
chip_smoke's). Prints, per run, the gate's verdict and the mean ATE of 10
epochs over the first epoch's at every 100th epoch and the last, and
writes the same lines to ``chiprun_out/rec_probe_<epochs or
schedule>.txt``. The launch-count check of the phase is skipped (the
layer-by-layer chain is off the path). With ``SAVE_CALL=<path.npz>`` each
run's last Kernel A training call (the one the phase holds against the
plain version) is saved there before that check (:func:`save_call`).
Needs a CUDA device.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


SAVE_RAYS = 64  # rays kept by the largest alpha deviation, and as many drawn


def save_call(call, path, seed=0):
    """Save a recorded Kernel A training call (``chip_smoke.kernel_a_
    training_call``) to ``path``: the weights (``w/<layer>``, ``b/<layer>``),
    the static arguments, and for 2 * SAVE_RAYS of its rays (the SAVE_RAYS
    whose alpha the fused forward and the plain version disagree on most,
    and SAVE_RAYS more drawn from ``seed``) the geometry, z and deltas with
    both versions' outputs (``fused/*``, ``plain/*``; the fused forward run
    as the step runs it, saving for a backward). Each ray's outputs depend
    on its own samples alone, so a subset keeps them. Prints how far each
    version is from the float64 plain version over all the call's rays."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    weights, geo, rest = call["args"][0], call["args"][1:4], call["args"][4:]
    z, deltas, static = rest[0], rest[1], rest[2:]
    w = [x.detach().clone().requires_grad_() for x in weights]
    fused = [o.detach() for o in mk.fused_mlp_composite(w, *geo, z, deltas,
                                                         *static)]
    with torch.no_grad():
        plain = mk.fused_mlp_composite_reference(weights, *geo, z, deltas,
                                                 *static)
        f64 = mk.fused_mlp_composite_reference(
            [x.double() for x in weights], *(g.double() for g in geo),
            z.double(), deltas.double(), *static)
    for name, out in (("fused", fused), ("plain", plain)):
        print(f"save_call: {name} against float64, max|err| " + ", ".join(
            f"{k} {float((a.double() - b).abs().max()):.3e}"
            for k, a, b in zip(("rgb", "dist", "alpha"), out, f64)),
            flush=True)
    dev_ray = (fused[2] - plain[2]).abs().amax(dim=1).cpu().numpy()
    worst = np.argsort(-dev_ray, kind="stable")[:SAVE_RAYS]
    rest_rays = np.setdiff1d(np.arange(dev_ray.shape[0]), worst)
    drawn = np.random.default_rng(seed).choice(rest_rays, SAVE_RAYS,
                                               replace=False)
    keep = np.sort(np.concatenate([worst, drawn]))
    sel = torch.as_tensor(keep, device=z.device)
    arrays = {"ray_index": keep, "static": np.array(
        [str(v) for v in static])}
    for n, i in zip(mk.W_NAMES, range(0, len(weights), 2)):
        arrays[f"w/{n}"] = weights[i].detach().cpu().numpy()
        arrays[f"b/{n}"] = weights[i + 1].detach().cpu().numpy()
    for n, t in zip(("origins", "rays", "dirs", "z", "deltas"),
                    (*geo, z, deltas)):
        arrays[n] = t.detach()[sel].cpu().numpy()
    for tag, out in (("fused", fused), ("plain", plain)):
        for n, t in zip(("rgb", "dist", "alpha"), out):
            arrays[f"{tag}/{n}"] = t[sel].cpu().numpy()
    np.savez_compressed(path, **arrays)
    print(f"save_call: {len(keep)} of {dev_ray.shape[0]} rays (largest "
          f"alpha deviation {dev_ray.max():.3e}) -> {path}", flush=True)


def main(argv):
    import torch

    import chip_smoke as cs
    from nope_nerf_tpu_torch import _build
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.training import loop

    if not torch.cuda.is_available():
        print("torch_recovery_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _build.load_library()
    cs.REC_EPOCHS = int(os.environ.get("REC_EPOCHS", cs.REC_EPOCHS or 0)) or None
    cs.check_launches = lambda *a, **k: None
    real = dict(chain=mk._chain_bwd, split=mk.dwgrad_split,
                wrps=mk.wgrad_rows_per_split, heads=mk.heads_rows_per_block,
                sms=mk._sm_count, train=loop.train)
    histories = []

    def train(*a, **k):
        out = real["train"](*a, **k)
        histories.append(out[3])
        return out

    loop.train = train
    save = os.environ.get("SAVE_CALL")
    if save:
        check = cs.check_kernel_a_call

        def check_saving(label, call):
            save_call(call, save)
            return check(label, call)

        cs.check_kernel_a_call = check_saving
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out",
                        f"rec_probe_{cs.REC_EPOCHS or 'schedule'}.txt")
    with open(path, "w") as out:
        for name in argv:
            mk._chain_bwd = (mk._chain_bwd_layered if name.startswith("layered")
                             else real["chain"])
            mk._sm_count = real["sms"]
            mk.dwgrad_split, mk.wgrad_rows_per_split = real["split"], real["wrps"]
            mk.heads_rows_per_block = real["heads"]
            if "_sm" in name:
                n = int(name.split("_sm")[1])
                mk._sm_count = lambda dev, n=n: n
            if name.endswith("_halfsplits"):
                mk.dwgrad_split = lambda m, s, sms: real["split"](m, s, sms // 2)
                mk.wgrad_rows_per_split = lambda m, k, sms: real["wrps"](
                    m, k, sms // 2)
            if name.endswith("_heads2"):
                mk.heads_rows_per_block = lambda m, sms: 2 * real["heads"](m, sms)
            try:
                cs.run_recovery(dev, card,
                                pose_lr=0.0 if name == "control" else None)
                msg = f"== {name}: gate passed"
            except AssertionError as e:
                msg = f"== {name}: {str(e)[:200]}"
            ate = [h["ate_trans"] for h in histories[-1]]
            marks = [*range(100, len(ate) + 1, 100), len(ate)]
            msg += ("\n   tail-10 mean / start at epoch: " + " ".join(
                f"{e}:{sum(ate[e - 10:e]) / 10 / ate[0]:.2f}" for e in marks))
            print(msg, flush=True)
            out.write(msg + "\n")
            out.flush()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
