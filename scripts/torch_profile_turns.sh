#!/usr/bin/env bash
# Compare the training step of two trees of the port on one GPU, in turns:
# `python -m nope_nerf_tpu_torch.profile_step --steps 16` at k = 1 and at
# k = 4 frames per step, run in PARENT, this tree, this tree, PARENT.
#
#   bash scripts/torch_profile_turns.sh PARENT [OUT [KEY=VALUE ...]]
#
# Each KEY=VALUE is passed to every run as a `--set` (e.g.
# training.with_ssim=True rendering.normal_loss=True).
#
# PARENT is an unpacked copy of the other tree (e.g. `git archive <commit>`
# into a directory that .gitignore lists); each tree builds its own kernels.
# Each run's full output (wall and device ms per step, the device's busy
# share, the per-kernel table) goes to OUT/<turn>_<tree>_k<k>.txt (default
# build/turns), its kernel table to OUT/<turn>_<tree>_k<k>/kernels.txt
# (the Chrome traces are deleted: 8 of them take tens of MB); the summary
# lines are printed.
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
PARENT="$(cd "$1" && pwd)"
OUT="$(mkdir -p "${2:-$ROOT/build/turns}" && cd "${2:-$ROOT/build/turns}" && pwd)"
sets=()
for kv in "${@:3}"; do sets+=(--set "$kv"); done
turn=0
for tree in parent change change parent; do
  turn=$((turn + 1))
  dir="$ROOT"
  [ "$tree" = parent ] && dir="$PARENT"
  for k in 1 4; do
    log="$OUT/${turn}_${tree}_k${k}.txt"
    (cd "$dir" && python3 -m nope_nerf_tpu_torch.profile_step --steps 16 \
      --set "tpu.rays_per_step_multiplier=$k" "${sets[@]}" \
      --out "$OUT/${turn}_${tree}_k${k}") > "$log" 2>&1
    rm -f "$OUT/${turn}_${tree}_k${k}/trace.json"
    echo "== turn $turn $tree k=$k"
    grep -E "^steps without|^profiled:" "$log" || tail -5 "$log"
  done
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
