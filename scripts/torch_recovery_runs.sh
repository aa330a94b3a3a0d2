#!/bin/bash
# Run the port's end-to-end pose recoveries one after the other and keep a
# short record of each:
#   ./scripts/torch_recovery_runs.sh RUN [RUN ...]
# RUN is one of
#   repro3        scripts/torch_reproduce_synthetic.sh at seed 3
#   repro4        the same at seed 4
#   paper_band1   scripts/torch_paper_scale_synthetic.sh band 1 (the stock
#                 chamfer mode in training, k = 1)
#   paper_exact1  ... exact 1
#   paper_band4   ... band 4
# Each run works under build/recovery/<RUN> (scenes and checkpoints, not
# kept) and writes its printed output, its scene.yaml, its events.jsonl and
# the JSON line of tools/torch_recovery_summary.py under
# $RECORD_DIR/<RUN>/ (default build/recovery_records, relative to the
# repository root). The card's name and power limit are printed first.
# DEVICE passes through to the scripts (default cuda).
cd "$(dirname "$0")/.."
RECORD_DIR=${RECORD_DIR:-build/recovery_records}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
rc=0
for run in "$@"; do
  work=build/recovery/$run
  keep=$RECORD_DIR/$run
  rm -rf "$work"
  mkdir -p "$work" "$keep"
  case $run in
    repro3) cmd=(scripts/torch_reproduce_synthetic.sh "$work" 3) ;;
    repro4) cmd=(scripts/torch_reproduce_synthetic.sh "$work" 4) ;;
    paper_band1) cmd=(scripts/torch_paper_scale_synthetic.sh "$work" band 1) ;;
    paper_exact1) cmd=(scripts/torch_paper_scale_synthetic.sh "$work" exact 1) ;;
    paper_band4) cmd=(scripts/torch_paper_scale_synthetic.sh "$work" band 4) ;;
    *) echo "unknown run $run"; rc=2; continue ;;
  esac
  echo "=== $run: ${cmd[*]}"
  "${cmd[@]}" > "$keep/run.log" 2>&1
  status=$?
  echo "=== $run exit $status"
  [ $status -ne 0 ] && rc=1 && tail -40 "$keep/run.log"
  cp "$work/scene.yaml" "$keep/" 2>/dev/null
  cp "$work/out/logs/events.jsonl" "$keep/" 2>/dev/null
  python tools/torch_recovery_summary.py "$work" --log "$keep/run.log" \
    | tee "$keep/summary.json"
  rm -rf "$work"
done
exit $rc
