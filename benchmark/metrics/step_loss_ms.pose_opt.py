"""step_loss_ms.pose_opt: Device ms of the section ``step.loss`` in the last
replay of the captured step (evaluation/pose_opt.py::PoseOptBlock): the
photometric MSE."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.loss")
