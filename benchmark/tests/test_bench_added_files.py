"""A later cell, configuration, mix or per-layer metric is taken from added
files and BENCHMARK.json entries alone: nothing that exists is edited."""
import json
import os
import shutil

from benchmark import harness


def test_new_config_mix_cell_and_metric_from_files(tiny):
    d = tiny.bench_dir
    shutil.copy(os.path.join(d, "configs", "tanks_ballroom.json"),
                os.path.join(d, "configs", "tanks_barn.json"))
    with open(os.path.join(d, "mixes", "render.json")) as f:
        mix = json.load(f)
    mix["poses"] = 3
    with open(os.path.join(d, "mixes", "render_few.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(d, "metrics", "images_per_s.render.py"), "w") as f:
        f.write("def read(t):\n"
                "    sl = t.get('slice')\n"
                "    return None if sl is None else t['slice_steps'] / "
                "sl.wall_s\n")
    shutil.copy(os.path.join(d, "limits", "tanks_ballroom.render.json"),
                os.path.join(d, "limits", "tanks_barn.render_few.json"))
    b = tiny.bench
    b["configs"].append({"name": "tanks_barn", "source": "https://x",
                         "file": "benchmark/configs/tanks_barn.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tanks_barn.render_few",
                           "config": "tanks_barn", "traffic": "render_few",
                           "chips": 1, "why": "a test"})
    b["end_to_end"][2]["workloads"].append("tanks_barn.render_few")
    b["per_layer"].append({"name": "images_per_s.render", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "step", "moves": "render_image_ms_p90",
                           "workloads": ["tanks_barn.render_few"]})
    tiny.write_bench()
    cell, config, mx, metrics = harness.cell_plan(
        b, "tanks_barn.render_few", True, d)
    assert mx["poses"] == 3 and cell["config"] == "tanks_barn"
    assert [m["name"] for m in metrics] == ["images_per_s.render"]
    res = tiny.run("tanks_barn.render_few", trace=True)
    assert res["metrics"]["images_per_s.render"]["value"] > 0
    assert res["correct"]
