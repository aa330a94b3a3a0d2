#!/bin/bash
# The PyTorch port's twin of scripts/paper_scale_synthetic.sh: 12 frames at
# 540x960 with the full default model (hidden 256, 128 samples/ray, 1024
# rays/step), poses from scratch, auto-scheduler two-stage training, then
# the full eval protocol (pose eval + held-out image eval incl. test-time
# pose optimization).
# The scene is the JAX script's: the JAX package's teacher field at the same
# seed (tests/fixtures/teacher_seed<SEED>.npz, written by
# tools/torch_teacher_fixture.py) rendered by the port's generator; the
# scene.yaml is the JAX script's, key for key, with the same arguments:
#   ./scripts/torch_paper_scale_synthetic.sh OUT [CHAMFER_MODE [RAYS_MULT [SEED]]]
# e.g. the stock chamfer mode (band in training) at k = 1:
#   ./scripts/torch_paper_scale_synthetic.sh /tmp/paper_band band 1
# Environment: DEVICE (default cuda; cpu runs every kernel's plain version),
# MAX_EPOCHS (caps the training), FRAMES / HEIGHT / WIDTH (the scene,
# default 12 / 540 / 960; the eval uses its size). A tiny CPU run:
#   DEVICE=cpu FRAMES=9 HEIGHT=24 WIDTH=32 MAX_EPOCHS=3 \
#     ./scripts/torch_paper_scale_synthetic.sh /tmp/paper_cpu band 1
# tools/torch_recovery_summary.py reads the run's numbers afterwards.
set -e
OUT=${1:-/tmp/paper}
CHAMFER_MODE=${2:-exact}
RAYS_MULT=${3:-1}
SEED=${4:-3}
DEVICE=${DEVICE:-cuda}
FRAMES=${FRAMES:-12}
HEIGHT=${HEIGHT:-540}
WIDTH=${WIDTH:-960}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
cd "$(dirname "$0")/.."
T0=$SECONDS

python -m nope_nerf_tpu_torch.make_synthetic_dataset "$OUT/data/scene" \
  --frames "$FRAMES" --height "$HEIGHT" --width "$WIDTH" --seed "$SEED" \
  --teacher "tests/fixtures/teacher_seed$SEED.npz" --device "$DEVICE"

cat > "$OUT/scene.yaml" <<EOY
dataloading:
  path: $OUT/data
  scene: ['scene']
  resize_factor:
depth:
  type: None
pose:
  learn_pose: True
  init_pose: False
training:
  out_dir: $OUT/out
  n_training_points: 1024
  print_every: 110
  checkpoint_every: 2000
  backup_every: 0
  visualize_every: 0
  auto_scheduler: True
  length_smooth: 100
  patient: 12
  scheduling_start: 1200
  scheduling_epoch: 600
  annealing_epochs: 300
tpu:
  chamfer_mode: $CHAMFER_MODE
  rays_per_step_multiplier: $RAYS_MULT
eval_pose:
  opt_pose_epoch: 200
extract_images:
  N_novel_imgs: 12
  traj_option: interp
  resolution: [$HEIGHT, $WIDTH]
EOY

T=$SECONDS
python -m nope_nerf_tpu_torch.train "$OUT/scene.yaml" --device "$DEVICE" \
  ${MAX_EPOCHS:+--max-epochs "$MAX_EPOCHS"}
echo "--- stage train: $((SECONDS - T)) s"
python -m nope_nerf_tpu_torch.eval_poses "$OUT/scene.yaml"
T=$SECONDS
python -m nope_nerf_tpu_torch.eval "$OUT/scene.yaml" --device "$DEVICE"
echo "--- stage eval: $((SECONDS - T)) s"

echo "--- done in $((SECONDS - T0)) s; artifacts in $OUT/out"
