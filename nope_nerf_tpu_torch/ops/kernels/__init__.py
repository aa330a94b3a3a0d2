"""Hand-written CUDA kernels of the port (sources in ``csrc/``) with their
plain PyTorch versions. A wrapper launches its kernel for CUDA tensors and
uses the plain version only for CPU tensors."""

import torch


class LaunchCounter:
    """Counts the launches of one kernel from its public wrapper.

    ``count`` holds the launches that ran when the wrapper was called;
    ``captured`` the ones recorded into a CUDA graph while the current
    stream was capturing, which run once per replay of that graph
    (:mod:`...training.capture` keeps each graph's share and its replays).
    """

    all = []  # every counter, in creation order

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.captured = 0
        LaunchCounter.all.append(self)

    def add(self):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.count += 1

    def reset(self):
        self.count = 0
        self.captured = 0
