"""step_rays_ms.pose_opt: Device ms of the section ``step.rays`` in the last
replay of the captured step (evaluation/pose_opt.py::PoseOptBlock): the lr
copy, frame select, sample_ray_idx and render_rays' ray set-up."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "pose_opt", "step.rays")
