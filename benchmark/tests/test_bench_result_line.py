"""The result line's schema, from whole runs of tiny cells on the CPU."""
import json

import pytest

CELLS = ["tanks_ballroom.train", "llff_fern.train", "tanks_ballroom.pose_opt",
         "tanks_ballroom.render"]


def entries(bench, workload, trace):
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return {m["name"]: m for m in group
            if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_line(tiny, workload):
    res = tiny.run(workload)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    want = entries(tiny.bench, workload, False)
    assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name]["unit"] and m["value"] > 0
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


MFU = {"tanks_ballroom.train": "train_mfu", "llff_fern.train": "train_mfu",
       "tanks_ballroom.pose_opt": "pose_opt_mfu",
       "tanks_ballroom.render": "render_mfu"}


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(tiny, workload):
    res = tiny.run(workload, trace=True)
    line = json.loads(json.dumps(res))
    assert line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    want = entries(tiny.bench, workload, True)
    # the CPU has no device trace: only the metrics with something to read
    assert set(line["metrics"]) <= set(want)
    assert MFU[workload] in line["metrics"]
