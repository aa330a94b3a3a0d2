"""replay_host_ms.train: The host ms of one graph replay of the step
(training/trainer.py::EpochStep): the fastest ``dispatch.replay`` span of a dispatch issued
onto an idle device, the median over the process's such dispatches."""
from benchmark.program_trace import replay_host_ms


def read(t):
    return replay_host_ms(t, "train")
