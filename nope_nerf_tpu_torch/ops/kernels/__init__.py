"""Hand-written CUDA kernels of the port (sources in ``csrc/``) with their
plain PyTorch versions. A wrapper launches its kernel for CUDA tensors and
uses the plain version only for CPU tensors."""


class LaunchCounter:
    """Counts the launches of one kernel from its public wrapper."""

    def __init__(self, name):
        self.name = name
        self.count = 0

    def add(self):
        self.count += 1

    def reset(self):
        self.count = 0
