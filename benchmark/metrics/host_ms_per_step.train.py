"""host_ms_per_step.train: The host's milliseconds per step of a dispatch
call (training/trainer.py::EpochStep) issued onto an idle device."""
from benchmark.readers import host_ms_per_step


def read(t):
    return host_ms_per_step(t, "train")
