"""device_ms_per_step.train: The device ms per step of a dispatch
(training/trainer.py::EpochStep): one event pair around each call's work
over its steps, the median over the process's dispatches."""
from benchmark.program_trace import device_ms_per_step


def read(t):
    return device_ms_per_step(t, "train")
