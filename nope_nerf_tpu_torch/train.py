"""Training CLI of the port, mirroring the repository's ``train.py``:

    python -m nope_nerf_tpu_torch.train configs/Tanks/Ignatius.yaml --max-epochs 10

Reads the same two-level YAML configs and dataset layout and trains on the
first CUDA device (on the CPU when there is none).
"""
import argparse

from .config import DEFAULT_CONFIG, load_config
from .training.loop import train


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Training of nope-nerf on PyTorch + CUDA")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="Optional epoch cap (smoke runs).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda when available).")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, DEFAULT_CONFIG)
    train(cfg, max_epochs=args.max_epochs, device=args.device)


if __name__ == "__main__":
    main()
