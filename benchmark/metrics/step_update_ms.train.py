"""step_update_ms.train: Device ms of the section ``step.update`` in the
last replay of the captured step (training/trainer.py::EpochStep): the
gradient fills, all-reduce, weight decay and Adam's step."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.update")
