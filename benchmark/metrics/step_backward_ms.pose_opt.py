"""step_backward_ms.pose_opt: Device ms of the section ``step.backward`` in
the last replay of the captured step (evaluation/pose_opt.py::PoseOptBlock):
loss.backward() outside Kernel A's backward."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.backward")
