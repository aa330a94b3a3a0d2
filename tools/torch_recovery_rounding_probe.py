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
layer-by-layer chain is off the path). Needs a CUDA device.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


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
