"""step_pair_ms.train: Device ms of the section ``step.pair`` in the last
replay of the captured step (training/trainer.py::EpochStep): the
reference-pair branch: the clouds, the rgb_s reprojection and grid_sample,
the band starts."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.pair")
