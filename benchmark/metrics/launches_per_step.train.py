"""launches_per_step.train: Device kernel launches per step in the profiled
slice (training/capture.py::StepGraphs replays)."""
from benchmark.readers import launches_per_step


def read(t):
    return launches_per_step(t, "train")
