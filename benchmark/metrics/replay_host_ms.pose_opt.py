"""replay_host_ms.pose_opt: The host ms of one graph replay of the step
(evaluation/pose_opt.py::PoseOptBlock): the fastest ``dispatch.replay``
span of a dispatch issued onto an idle device, the median over the
process's such dispatches."""
from benchmark.program_trace import replay_host_ms


def read(t):
    return replay_host_ms(t, "pose_opt")
