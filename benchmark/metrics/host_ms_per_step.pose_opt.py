"""host_ms_per_step.pose_opt: The host's milliseconds per step of a dispatch
call (evaluation/pose_opt.py::PoseOptBlock) issued onto an idle device."""
from benchmark.readers import host_ms_per_step


def read(t):
    return host_ms_per_step(t, "pose_opt")
