"""step_aux_ms.train: Device ms of the section ``step.aux`` in the last
replay of the captured step (training/trainer.py::EpochStep): the aux row,
its index_copy_ and the step counter."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.aux")
