#!/usr/bin/env python
"""Summarise one run of ``scripts/torch_reproduce_synthetic.sh`` or
``scripts/torch_paper_scale_synthetic.sh`` as one JSON line.

    python tools/torch_recovery_summary.py OUT [--log LOG]

Reads ``OUT/out/logs/events.jsonl`` (the training loop's scalars, one
``eval/ate_trans`` per epoch), the scheduler scalars of ``OUT/out/model.npz``
and ``OUT/scene.yaml``, and, with ``--log``, the script's printed output
(the ``eval_poses`` line ``RPE_t x100 & RPE_r deg & ATE``, the ``eval`` mean
line ``Mean MSE: .., PSNR: .., SSIM: .., LPIPS ..`` and the ``--- stage``
wall times). Prints: the initial and final ATE and RPE, the ATE curve at
every 50th epoch, the epoch at which the plateau switch fired, whether the
auto-scheduler finished both stages, the first and last train PSNR, the
held-out PSNR / SSIM, rays/s from ``perf/rays_per_sec`` (median, min, max
over the print steps after the first) and the wall times. numpy + yaml only.
"""
import argparse
import json
import os
import re

import numpy as np
import yaml


def _events(out_dir):
    series = {}
    with open(os.path.join(out_dir, "logs", "events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            series.setdefault(e["tag"], []).append((e["step"], e["value"]))
    return series


def _scalars(path):
    with np.load(path) as d:
        return json.loads(bytes(d["__scalars__"]).decode())


def summarise(out, log=None):
    with open(os.path.join(out, "scene.yaml")) as f:
        cfg = yaml.safe_load(f)
    tcfg = cfg["training"]
    out_dir = tcfg["out_dir"]
    ev = _events(out_dir)
    sc = _scalars(os.path.join(out_dir, "model.npz"))
    ate = [v for _, v in ev.get("eval/ate_trans", [])]
    psnr = [v for _, v in ev.get("train/psnr", [])]
    rates = [v for _, v in ev.get("perf/rays_per_sec", [])][1:]
    start = int(sc["scheduling_start"])
    fired = int(sc["patient_count"]) >= int(tcfg["patient"])
    res = {
        "out": out,
        "epochs_run": len(psnr),
        "last_epoch": int(sc["epoch_it"]),
        "steps": int(sc["it"]) + 1,
        "ate_first": ate[0] if ate else None,
        "ate_final": ate[-1] if ate else None,
        "ate_min": min(ate) if ate else None,
        "ate_every_50": [round(a, 5) for a in ate[::50]],
        "rpe_trans_final": ev["eval/rpe_trans"][-1][1]
        if "eval/rpe_trans" in ev else None,
        "rpe_rot_final": ev["eval/rpe_rot"][-1][1]
        if "eval/rpe_rot" in ev else None,
        "plateau_fired": fired,
        "plateau_epoch": start if fired else None,
        "both_stages_done": fired and int(sc["epoch_it"]) >= start
        + int(tcfg["scheduling_epoch"]),
        "train_psnr_first": psnr[0] if psnr else None,
        "train_psnr_final": psnr[-1] if psnr else None,
        "rays_per_sec_median": float(np.median(rates)) if rates else None,
        "rays_per_sec_min": min(rates) if rates else None,
        "rays_per_sec_max": max(rates) if rates else None,
    }
    if log is not None:
        with open(log) as f:
            text = f.read()
        m = re.findall(r"^([\d.]+) & ([\d.]+) & ([\d.]+)$", text, re.M)
        if m:
            res["eval_poses_rpe_t_x100"], res["eval_poses_rpe_r_deg"], \
                res["eval_poses_ate"] = map(float, m[-1])
        m = re.findall(r"Mean MSE: [\d.e+-]+, PSNR: ([\d.]+), SSIM: ([\d.]+),"
                       r" LPIPS (\S+)", text)
        if m:
            res["heldout_psnr"], res["heldout_ssim"] = map(float, m[-1][:2])
            res["heldout_lpips"] = m[-1][2]
        for stage, secs in re.findall(r"^--- stage (\w+): (\d+) s$", text,
                                      re.M):
            res[f"wall_{stage}_s"] = int(secs)
        m = re.findall(r"^--- done in (\d+) s", text, re.M)
        if m:
            res["wall_total_s"] = int(m[-1])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(summarise(args.out, args.log)))


if __name__ == "__main__":
    main()
