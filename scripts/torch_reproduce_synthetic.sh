#!/bin/bash
# The PyTorch port's twin of scripts/reproduce_synthetic.sh, end to end on
# synthetic data (no datasets needed):
#   dataset gen -> full training (poses from scratch, auto-scheduler) ->
#   pose eval -> held-out image eval -> novel-view render.
# The scene is the JAX script's: the JAX package's teacher field at the same
# seed (tests/fixtures/teacher_seed<SEED>.npz, written by
# tools/torch_teacher_fixture.py) rendered by the port's generator; the
# scene.yaml is the JAX script's, key for key.
#
# Run from anywhere, on the GPU:
#   ./scripts/torch_reproduce_synthetic.sh /tmp/repro [SEED]
# Environment: DEVICE (default cuda; cpu runs every kernel's plain version),
# MAX_EPOCHS (caps the training), FRAMES / HEIGHT / WIDTH (the scene, default
# 20 / 96 / 128; the eval and the render use its size). A tiny CPU run:
#   DEVICE=cpu FRAMES=9 HEIGHT=24 WIDTH=32 MAX_EPOCHS=3 \
#     ./scripts/torch_reproduce_synthetic.sh /tmp/repro_cpu
# tools/torch_recovery_summary.py reads the run's numbers afterwards.
set -e
OUT=${1:-/tmp/repro}
SEED=${2:-3}
DEVICE=${DEVICE:-cuda}
FRAMES=${FRAMES:-20}
HEIGHT=${HEIGHT:-96}
WIDTH=${WIDTH:-128}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
cd "$(dirname "$0")/.."
T0=$SECONDS

python -m nope_nerf_tpu_torch.make_synthetic_dataset "$OUT/data/scene" \
  --frames "$FRAMES" --height "$HEIGHT" --width "$WIDTH" --seed "$SEED" \
  --teacher "tests/fixtures/teacher_seed$SEED.npz" --device "$DEVICE"

cat > "$OUT/scene.yaml" <<EOY
model:
  hidden_dim: 128
dataloading:
  path: $OUT/data
  scene: ['scene']
  resize_factor:
rendering:
  num_points: 64
depth:
  type: None
pose:
  learn_pose: True
  init_pose: False
training:
  out_dir: $OUT/out
  n_training_points: 1024
  print_every: 190
  checkpoint_every: 2000
  backup_every: 0
  visualize_every: 0
  auto_scheduler: True
  length_smooth: 100
  patient: 12
  scheduling_start: 1200
  scheduling_epoch: 600
  annealing_epochs: 300
eval_pose:
  opt_pose_epoch: 200
extract_images:
  N_novel_imgs: 20
  traj_option: interp
  resolution: [$HEIGHT, $WIDTH]
EOY

T=$SECONDS
python -m nope_nerf_tpu_torch.train "$OUT/scene.yaml" --device "$DEVICE" \
  ${MAX_EPOCHS:+--max-epochs "$MAX_EPOCHS"}
echo "--- stage train: $((SECONDS - T)) s"
python -m nope_nerf_tpu_torch.eval_poses "$OUT/scene.yaml" --vis
T=$SECONDS
python -m nope_nerf_tpu_torch.eval "$OUT/scene.yaml" --device "$DEVICE"
echo "--- stage eval: $((SECONDS - T)) s"
python -m nope_nerf_tpu_torch.render "$OUT/scene.yaml" --device "$DEVICE"

echo "--- done in $((SECONDS - T0)) s; artifacts in $OUT/out"
