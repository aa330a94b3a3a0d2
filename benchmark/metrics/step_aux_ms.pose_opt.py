"""step_aux_ms.pose_opt: Device ms of the section ``step.aux`` in the last
replay of the captured step (evaluation/pose_opt.py::PoseOptBlock): the
loss's index_copy_ and the step counter."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.aux")
