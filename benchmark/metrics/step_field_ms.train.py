"""step_field_ms.train: Device ms of the section ``step.field`` in the last
replay of the captured step (training/trainer.py::EpochStep):
render_ray_batch: Kernel A's saving forward."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.field")
