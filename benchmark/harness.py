"""The harness: finds a cell's configuration, traffic mix, driver, limits and
per-layer metric readers by the names in ``BENCHMARK.json``, runs the cell
once and prints its result line.

Everything that belongs to one configuration, mix, metric or cell is a file
of its own:

* ``configs/<config>.json``: the configuration as it is run (``config``),
  its scene's sizes (``scene``), its source, ``reduced`` and ``assumed``;
* ``mixes/<traffic>.json``: the traffic's parameters, with ``driver``
  naming the general generator in ``drivers/<driver>.py`` that reads them;
* ``metrics/<metric>.py``: a reader ``read(t)`` of one per-layer metric
  from a traced run's readings ``t`` (None when it finds nothing to read);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.

A run is: set-up (inputs and weights from the seed, the program built and
warmed on this cell's shapes, the first steps that the comparison follows),
the measured window, the device's peak memory, in a traced run the
per-layer probes, the program's state freed, then the comparison with the
plain reference.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

from benchmark import counts

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "nope_nerf_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, an unknown cell, a
    forbidden import): exit non-zero and print no result line."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def data_file(kind, name, bench_dir=BENCH_DIR):
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.isfile(path):
        raise Refused(f"missing {path}")
    return load_json(path)


def cell_plan(bench, workload, trace, bench_dir=BENCH_DIR):
    """(cell, configuration file, mix, the metric entries this run
    reports): with ``trace`` the per-layer metrics listed for the cell (or
    without a list, those moving one of its end-to-end metrics), else its
    end-to-end metrics."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    config = load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    mix = data_file("mixes", cell["traffic"], bench_dir)

    def in_cell(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if in_cell(m)]
    if not trace:
        return cell, config, mix, e2e
    names = {m["name"] for m in e2e}

    def listed(m):
        if "workloads" in m:
            return workload in m["workloads"]
        return m["moves"] in names

    return cell, config, mix, [m for m in bench["per_layer"] if listed(m)]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix, bench_dir=BENCH_DIR):
    return load_module(os.path.join(bench_dir, "drivers",
                                    mix["driver"] + ".py"),
                       "bench_driver_" + mix["driver"])


def read_metric(name, readings, bench_dir=BENCH_DIR):
    """The metric ``name`` from a traced run's readings, or None."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    value = load_module(path, "bench_metric_" + name.replace(".", "_")
                        ).read(readings)
    return None if value is None else float(value)


def limits(workload, bench_dir=BENCH_DIR):
    """{number: limit} of the cell, with None for a number that is read
    and printed but not compared (``not_compared``); empty without a
    file."""
    path = os.path.join(bench_dir, "limits", workload + ".json")
    if not os.path.isfile(path):
        return {}
    data = load_json(path)
    return {**{k: None for k in data.get("not_compared", {})},
            **data["limits"]}


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (the port's name begins with the JAX package's)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def judge(numbers, lims):
    """(correct, checks): every compared number at or under its limit. A
    number that the limits do not name, or that is not finite, fails; one
    named as not compared (limit None) is printed and not judged."""
    checks, ok = {}, any(lims.get(n) is not None for n in numbers)
    for name, value in numbers.items():
        limit = lims.get(name, "missing")
        if limit is not None:
            ok = ok and (limit != "missing" and value == value
                         and value <= float(limit))
        checks[name] = {"value": value,
                        "limit": None if limit == "missing" else limit}
    return ok, checks


class Context:
    """What a driver reads: the configuration, the mix, the seed, the
    window's length, whether the run is traced, the device."""

    def __init__(self, config, mix, seed, seconds, trace, device,
                 workload):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.seconds, self.trace, self.device = float(seconds), trace, device
        self.workload = workload
        self.cfg = config["config"]


def run_cell(workload, seed, seconds, trace, device, t_start,
             bench=None, bench_dir=BENCH_DIR, require_cuda=True, log=None):
    """Run one cell once; returns the result dict (the line's object)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if require_cuda and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= 1):
        raise Refused("no CUDA device: the benchmark runs only on the card")
    bench = benchmark() if bench is None else bench
    cell, config, mix, entries = cell_plan(bench, workload, trace, bench_dir)
    if require_cuda and torch.cuda.device_count() < cell["chips"]:
        raise Refused(f"{workload} needs {cell['chips']} cards")
    dev = torch.device(device)
    ctx = Context(config, mix, seed, seconds, trace, dev, workload)
    drv = driver(mix, bench_dir)

    state = drv.setup(ctx)
    out = drv.window(state, ctx, t_start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
        log(f"card: {kind}, power limit {power_limit()}; peaks "
            f"{counts.PEAK_BF16_FLOPS:.4g} FLOP/s bf16, "
            f"{counts.PEAK_HBM_BYTES:.4g} B/s, {counts.PEAK_FP32_INSTR:.4g} "
            "FP32 instructions/s (NVIDIA's data sheet, at 700 W)")
    else:
        peak, kind = 0, "cpu"
    readings = out.readings
    if trace:
        readings.update(drv.probe(state, ctx))
    numbers = drv.compare(state, ctx, log)
    del state
    lims = limits(workload, bench_dir)
    correct, checks = judge(numbers, lims)

    units = {m["name"]: m["unit"] for m in entries}
    metrics = {}
    for m in entries:
        value = (out.end_to_end.get(m["name"]) if not trace
                 else read_metric(m["name"], readings, bench_dir))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result = {"correct": correct and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if trace:
        sl = readings["slice"]
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.wall_s
        result["breakdown"] = sl.breakdown()
    result["checks"] = checks
    return result


def print_checks(checks, stream=sys.stderr):
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=stream, flush=True)

