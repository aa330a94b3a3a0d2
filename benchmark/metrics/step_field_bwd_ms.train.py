"""step_field_bwd_ms.train: Device ms of the section ``step.backward.field``
in the last replay of the captured step (training/trainer.py::EpochStep):
Kernel A's backward (FusedMLPComposite.backward)."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.backward.field")
