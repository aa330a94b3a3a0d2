"""step_field_bwd_ms.pose_opt: Device ms of the section
``step.backward.field`` in the last replay of the captured step
(evaluation/pose_opt.py::PoseOptBlock): Kernel A's input-only backward
(FusedMLPComposite.backward)."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.backward.field")
