"""step_update_ms.pose_opt: Device ms of the section ``step.update`` in the
last replay of the captured step (evaluation/pose_opt.py::PoseOptBlock):
Adam's step on the pose table."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.update")
