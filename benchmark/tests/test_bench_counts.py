"""The yardstick's counts, from the configurations' shapes alone."""
import json
import os

import pytest
import torch

from benchmark import counts
from benchmark.reference import nerf as ref

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)["config"]


def test_mlp_count_of_the_skip_mlp():
    model = config("tanks_ballroom")["model"]
    assert counts.mlp_flops_per_point(model) == 2 * 593_408
    fwd = counts.mlp_flops(model, 131_072, "render")
    assert fwd == pytest.approx(155.6e9, rel=1e-3)
    assert counts.mlp_flops(model, 131_072, "train") == 3 * fwd
    assert counts.mlp_flops(model, 131_072, "pose_opt") == 2 * fwd
    # the render image: 540 x 960 rays x 128 samples
    assert counts.mlp_flops(model, 540 * 960 * 128, "render") == \
        pytest.approx(78.75e12, rel=1e-3)


def test_least_times_are_flop_bound_at_the_stock_shapes():
    model = config("tanks_ballroom")["model"]
    least = counts.mlp_least_seconds(model, 1024, 128, "train")
    assert least == pytest.approx(466.7e9 / 989e12, rel=1e-3)
    assert counts.mlp_bytes(model, 1024, 128, "train") / 3.35e12 < least


@pytest.mark.parametrize("name,hw,k,pairs", [
    ("tanks_ballroom", (135, 240), 8, 32_400 * 8 * 1024),
    ("llff_fern", (189, 252), 8, 47_628 * 8 * 1024),
])
def test_band_pairs_at_both_clouds(name, hw, k, pairs):
    cfg = config(name)
    scene = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    ratio = cfg["training"]["pc_ratio"]
    got_hw = (int(scene["scene"]["height"] / ratio),
              int(scene["scene"]["width"] / ratio))
    assert got_hw == hw
    assert ref.band_tiles(hw, cfg["tpu"]["chamfer_band_rows"]) == k
    n = hw[0] * hw[1]
    groups = -(-n // ref.BAND_GROUP)
    starts = torch.zeros(groups, dtype=torch.int32)
    assert ref.band_pairs(starts, n, n, k) == pairs
    # a band clamped to the last tiles holds fewer real rows
    last = torch.full((groups,), 10 ** 6, dtype=torch.int32)
    assert ref.band_pairs(last, n, n, k) < pairs


def test_llff_clouds_hold_about_one_and_a_half_times_the_pairs():
    assert 47_628 / 32_400 == pytest.approx(1.47, abs=0.01)
