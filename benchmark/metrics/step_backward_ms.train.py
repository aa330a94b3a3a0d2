"""step_backward_ms.train: Device ms of the section ``step.backward`` in the
last replay of the captured step (training/trainer.py::EpochStep):
loss.backward() outside Kernel A's backward."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.backward")
