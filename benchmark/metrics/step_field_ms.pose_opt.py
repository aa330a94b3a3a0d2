"""step_field_ms.pose_opt: Device ms of the section ``step.field`` in the
last replay of the captured step (evaluation/pose_opt.py::PoseOptBlock):
render_ray_batch: Kernel A's saving forward."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.field")
