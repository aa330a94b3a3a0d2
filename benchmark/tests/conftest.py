"""Fixtures of the benchmark's CPU tests: a copy of the benchmark folder
whose configurations and mixes are cut to a size the CPU runs in seconds.

The tiny configurations keep the cells' branches (occupancy or NDC with
``dist_alpha``, the banded Chamfer, rgb_s). The port's CPU route runs the
field in float32, so the program and the plain reference agree there to
float32 rounding; ``Tiny(tmp, bf16=True)`` runs it through Kernel A's plain
version with bf16 operands, the card's numerics. Run with
``python -m pytest benchmark/tests`` from the root.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

TINY_SCENE = {"frames_total": 6, "height": 24, "width": 32, "focal_px": 25.0}


def shrink_config(c, bf16=False):
    c["scene"].update(TINY_SCENE)
    cfg = c["config"]
    cfg["model"]["hidden_dim"] = 32
    cfg["training"]["n_training_points"] = 64
    cfg["rendering"]["num_points"] = 16
    cfg["eval_pose"]["n_points"] = 64
    cfg["eval_pose"]["opt_pose_epoch"] = 10
    cfg["extract_images"]["resolution"] = [24, 32]
    if bf16:  # the card's numerics: Kernel A's route, bf16 operands
        cfg["tpu"]["use_pallas_mlp"] = True
        cfg["tpu"]["mlp_bf16"] = True
    return c


def shrink_mix(name, mx):
    mx["probe_iters"] = 1
    if name == "pose_opt":
        mx["block_epochs"] = 3
    if name == "render":
        mx.update(sample_pixels=128, sample_images=2, trace_dispatches=2)
    return mx


class Tiny:
    """A root with BENCHMARK.json and a copy of the benchmark folder cut to
    a tiny size; ``bench_dir`` and ``bench`` go to the harness."""

    def __init__(self, tmp, bf16=False):
        self.root = str(tmp)
        self.bench_dir = os.path.join(self.root, "benchmark")
        shutil.copytree(os.path.join(ROOT, "benchmark"), self.bench_dir,
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        for conf in os.listdir(os.path.join(self.bench_dir, "configs")):
            self.rewrite(os.path.join("configs", conf),
                         lambda c: shrink_config(c, bf16))
        for mix in os.listdir(os.path.join(self.bench_dir, "mixes")):
            self.rewrite(os.path.join("mixes", mix),
                         lambda m, n=mix[:-5]: shrink_mix(n, m))
        self.write_bench()

    def rewrite(self, rel, fn):
        path = os.path.join(self.bench_dir, rel)
        with open(path) as f:
            data = json.load(f)
        with open(path, "w") as f:
            json.dump(fn(data), f)

    def write_bench(self):
        with open(os.path.join(self.root, "BENCHMARK.json"), "w") as f:
            json.dump(self.bench, f)

    def run(self, workload, trace=False, seed=2 ** 31 + 7, seconds=0.3):
        from benchmark import harness

        return harness.run_cell(workload, seed, seconds, trace, "cpu", 0.0,
                                bench=self.bench, bench_dir=self.bench_dir,
                                require_cuda=False, log=lambda m: None)


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(2)
    return Tiny(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
