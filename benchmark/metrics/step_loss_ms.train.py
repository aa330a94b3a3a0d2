"""step_loss_ms.train: Device ms of the section ``step.loss`` in the last
replay of the captured step (training/trainer.py::EpochStep): total_loss,
Kernel B's two argmins inside."""
from benchmark.program_trace import section_ms


def read(t):
    return section_ms(t, "train", "step.loss")
