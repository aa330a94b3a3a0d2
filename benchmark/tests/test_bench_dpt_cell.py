"""The depth-prior cell, its configuration, its mix, its limits and its
per-layer metrics are found by name from added files and BENCHMARK.json
entries alone; a tiny run of it on the CPU (24x400 frames, a 32x384
network input at the published widths) is correct, and a planted fault is
not."""
import os

from benchmark import control_dpt, harness

CELL = "dpt_hybrid_ballroom.depth_priors"
METRICS = ["dpt_transform_ms.depth_priors", "dpt_resnet_ms.depth_priors",
           "dpt_vit_ms.depth_priors", "dpt_decoder_ms.depth_priors",
           "dpt_host_ms.depth_priors", "dpt_mfu",
           "dpt_resnet_roofline.depth_priors", "dpt_vit_roofline.depth_priors",
           "dpt_decoder_roofline.depth_priors", "device_idle_pct.depth_priors"]


def small(tiny):
    """The tiny copy with the cell's sequence cut to 6 frames of 24x400."""
    def scene(c):
        c["scene"].update(frames_total=6, height=24, width=400)
        return c

    tiny.rewrite(os.path.join("configs", "dpt_hybrid_ballroom.json"), scene)
    tiny.rewrite(os.path.join("mixes", "depth_priors.json"),
                 lambda m: dict(m, frames=6, trace_dispatches=1,
                                sample_batches=1, probe_iters=1))
    return tiny


def test_the_cell_is_found_by_its_names():
    bench = harness.benchmark()
    cell, config, mix, e2e = harness.cell_plan(bench, CELL, False)
    assert cell["config"] == "dpt_hybrid_ballroom" and cell["chips"] == 1
    assert config["config"]["depth"]["type"] == "DPT"
    assert config["reduced"] == [] and config["scene"]["frames_total"] == 55
    assert mix["driver"] == "depth_priors" and mix["batch"] == 4
    assert {m["name"] for m in e2e} == {"render_image_ms_p90", "setup_s"}
    _, _, _, per_layer = harness.cell_plan(bench, CELL, True)
    assert [m["name"] for m in per_layer] == METRICS
    for name in METRICS:
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "metrics",
                                           name + ".py"))
    lims = harness.limits(CELL)
    assert set(lims) == {"depth_gap", "inv_gap", "clamped_share"}
    assert lims["clamped_share"] is None
    assert 0 < lims["depth_gap"] and 0 < lims["inv_gap"]


def test_a_tiny_traced_run_is_correct(tiny):
    res = small(tiny).run(CELL, trace=True, seconds=0.1)
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0 and res["failed"] == 0
    # the CPU has no device sections: the host span and the slice's share
    assert {"dpt_host_ms.depth_priors", "dpt_mfu"} <= set(res["metrics"])
    assert set(res["metrics"]) <= set(METRICS)
    assert set(res["checks"]) == {"depth_gap", "inv_gap", "clamped_share"}


def test_a_planted_fault_fails_the_limits(tiny):
    small(tiny)
    got = control_dpt.readings(5, "skip_block8", "cpu", tiny.bench,
                               tiny.bench_dir)
    correct, _ = harness.judge(got, harness.limits(CELL, tiny.bench_dir))
    assert not correct, got
