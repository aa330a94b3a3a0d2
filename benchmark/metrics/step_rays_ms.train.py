"""step_rays_ms.train: Device ms of the section ``step.rays`` in the last
replay of the captured step (training/trainer.py::EpochStep): the pose,
focal and distortion, ray sampling, the prior gather and ray_setup."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.rays")
