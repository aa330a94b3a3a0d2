"""The Depth Anything V2 cell: its counts against an independent formula
(2,583 GFLOP a 518x924 frame), its seeded weights' shapes and 335.3 M
parameters, the cell, its configuration, mix, limits and metrics found by
name from added files and BENCHMARK.json entries alone, the plain
reference's imports; a tiny run of it on the CPU (a network cut to width
128 and 12 blocks, 24x32 frames at a 28x42 input) is correct, and each
planted fault is not."""
import inspect
import os
import types

import pytest
import torch

from benchmark import control_da2, counts_da2, harness, weights_da2
from benchmark.reference import depth_anything_v2 as ref
from benchmark.tests.test_bench_imports import top_level_imports

CELL = "depth_anything_v2_large_ballroom.depth_priors_518"
CONFIG = "depth_anything_v2_large_ballroom"
METRICS = ["da2_encoder_ms.depth_priors_518", "da2_attn_ms.depth_priors_518",
           "da2_head_ms.depth_priors_518",
           "da2_encoder_roofline.depth_priors_518",
           "da2_attn_roofline.depth_priors_518",
           "da2_head_roofline.depth_priors_518", "da2_mfu",
           "device_idle_pct.depth_priors_518"]
TINY_NET = {"dim": 128, "blocks": 12, "mlp_dim": 512, "patch": 14,
            "pos_embed_grid": 5, "out_channels": [16, 32, 64, 64],
            "features": 32}


def formula_gflop(h, w):
    """Depth Anything V2-Large's GFLOP a frame at h x w, written out:
    encoder (patch embedding, 24 blocks of qkv, attention, proj, MLP) and
    head (projections, reassembly, 3x3 convs to 256, fusion, output)."""
    gh, gw = h // 14, w // 14
    p, t, d = gh * gw, gh * gw + 1, 1024
    dh, dw = (gh + 1) // 2, (gw + 1) // 2
    enc = 2 * p * 3 * 196 * d + 24 * (2 * t * d * 4 * d + 4 * t * t * d
                                      + 2 * 2 * t * d * 4096)
    px = [16 * p, 4 * p, p, dh * dw]  # pixels of the four layers
    head = (2 * p * d * (256 + 512 + 1024 + 1024)
            + 2 * 256 * 256 * 16 * p + 2 * 512 * 512 * 4 * p
            + 2 * 1024 * 1024 * 9 * dh * dw
            + sum(2 * c * 256 * 9 * n
                  for c, n in zip((256, 512, 1024, 1024), px)))
    rcu = 2 * 256 * 256 * 9
    head += rcu * (2 * px[3] + 4 * px[2] + 4 * px[1] + 4 * px[0])
    head += 2 * 256 * 256 * (px[2] + px[1] + px[0] + 4 * px[0])
    head += 2 * 256 * 128 * 9 * 4 * px[0]
    head += (2 * 128 * 32 * 9 + 2 * 32) * (14 * gh) * (14 * gw)
    return (enc + head) / 1e9


def test_counts_match_an_independent_formula():
    assert counts_da2.network_hw(540, 960) == (518, 924)
    assert counts_da2.tokens(518, 924) == 2443
    got = counts_da2.flops(518, 924) / 1e9
    assert got == pytest.approx(formula_gflop(518, 924), rel=1e-12)
    assert got == pytest.approx(2583, rel=0.01)
    sec = counts_da2.section_flops(518, 924)
    assert sec["dpt.dinov2"] + sec["dpt.dinov2.attn"] == pytest.approx(
        2065e9, rel=0.01)
    assert sec["dpt.dinov2.attn"] == pytest.approx(587e9, rel=0.01)
    least = counts_da2.least_seconds(518, 924, 4)
    assert sum(least.values()) == pytest.approx(0.0386, rel=0.01)
    assert least["dpt.dinov2.attn"] == pytest.approx(
        sec["dpt.dinov2.attn"] / 67e12)


def test_weights_have_the_published_shapes_and_count():
    bench = harness.benchmark()
    conf = harness.find(bench["configs"], CONFIG, "config")
    net = harness.load_json(os.path.join(harness.ROOT, conf["file"]))[
        "network"]
    assert weights_da2.parameters(net) == net["parameters"] == 335_314_625
    assert round(net["parameters"] / 1e6, 1) == 335.3
    lay = weights_da2.layout(net)
    assert lay["pos_embed"][1] == (1, 1370, 1024)
    assert lay["blocks"][23]["qkv"]["w"][1] == (3072, 1024)
    assert lay["blocks"][0]["ls1"][0] == "gamma"
    assert lay["resize0"]["w"][1] == (256, 256, 4, 4)
    assert lay["resize3"]["w"][1] == (1024, 1024, 3, 3)
    w = weights_da2.da2_weights(TINY_NET, 5, "cpu")
    for key in ("ls1", "ls2"):
        g = w["blocks"][2][key]
        assert 0.1 <= float(g.min()) and float(g.max()) <= 0.9
    assert float(w["pos_embed"].abs().max()) > 0
    assert float(w["patch_embed"]["b"].abs().min()) > 0


def test_the_cell_is_found_by_its_names():
    bench = harness.benchmark()
    cell, config, mix, e2e = harness.cell_plan(bench, CELL, False)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    assert config["config"]["depth"]["type"] == "DepthAnythingV2"
    assert config["reduced"] == [] and config["scene"]["frames_total"] == 55
    assert mix["driver"] == "depth_priors_518" and mix["batch"] == 4
    assert (mix["sample_batches"], mix["trace_dispatches"],
            mix["probe_iters"]) == (2, 6, 3)
    assert {m["name"] for m in e2e} == {"render_image_ms_p90", "setup_s"}
    _, _, _, per_layer = harness.cell_plan(bench, CELL, True)
    # the shared transform and dispatch layers' metrics, then the cell's own
    assert [m["name"] for m in per_layer] == [
        "dpt_transform_ms.depth_priors", "dpt_host_ms.depth_priors"] + METRICS
    for name in METRICS:
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "metrics",
                                           name + ".py"))
    lims = harness.limits(CELL)
    assert set(lims) == {"depth_gap", "inv_gap", "clamped_share"}
    assert lims["clamped_share"] is None


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_imports(ref.__file__)
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}


def small(tiny):
    """The tiny copy with the cell's sequence cut to 6 frames of 24x32 and
    the network to TINY_NET at a 28x42 input."""
    def conf(c):
        c["network"].update(TINY_NET)
        c["config"]["depth"]["input_size"] = 28
        return c

    tiny.rewrite(os.path.join("configs", CONFIG + ".json"), conf)
    tiny.rewrite(os.path.join("mixes", "depth_priors_518.json"),
                 lambda m: dict(m, frames=6, trace_dispatches=1,
                                sample_batches=1, probe_iters=1))
    return tiny


def test_a_tiny_traced_run_is_correct(tiny):
    res = small(tiny).run(CELL, trace=True, seconds=0.1)
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0 and res["failed"] == 0
    # the CPU has no device sections: the slice's share and the host span
    assert set(res["metrics"]) == {"da2_mfu", "dpt_host_ms.depth_priors"}
    assert set(res["checks"]) == {"depth_gap", "inv_gap", "clamped_share"}
    # the centred head bias: the ReLU passes part of the compared pixels,
    # so that the depths are not the tail's constant
    assert 0.05 < res["checks"]["clamped_share"]["value"] < 0.95, res


def test_the_driver_runs_the_base_driver_on_this_networks_modules():
    """The driver's copy of ``drivers/depth_priors.py`` holds no name bound
    to DPT-Hybrid's counts, weights or reference, and its probe reads
    Depth Anything V2's least times at 518x924."""
    drv = harness.driver({"driver": "depth_priors_518"}, harness.BENCH_DIR)
    hybrid = {"benchmark.counts_dpt", "benchmark.weights_dpt",
              "benchmark.reference.dpt"}
    for name, val in vars(drv._base).items():
        mod = (val.__name__ if inspect.ismodule(val)
               else getattr(val, "__module__", None))
        assert mod not in hybrid, name
    assert drv._base.SECTIONS == ("dpt.transform",) + counts_da2.SECTIONS
    s = types.SimpleNamespace(
        window_ns=(0, 0), window_sections=[], batch=4, hw=(518, 924),
        frames=torch.zeros((4, 1, 1, 3)), batches=[torch.arange(4)])
    ctx = types.SimpleNamespace(device=torch.device("cpu"), mix={})
    got = drv.probe(s, ctx)
    assert got["dpt_least_s"] == counts_da2.least_seconds(518, 924, 4)
    assert got["network"] == "DepthAnythingV2"
    assert counts_da2.flops(518, 924) == pytest.approx(2583.1e9, rel=1e-4)


@pytest.mark.parametrize("side", ["tf32", *ref.FAULTS])
def test_a_control_side_reads(tiny, side):
    """Each side reads on the CPU; a planted fault fails the limits (TF32
    does nothing on the CPU, so its control is read on the card)."""
    small(tiny)
    got = control_da2.readings(5, side, "cpu", tiny.bench, tiny.bench_dir)
    correct, _ = harness.judge(got, harness.limits(CELL, tiny.bench_dir))
    assert correct == (side == "tf32"), got
