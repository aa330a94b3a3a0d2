"""Metrics logging (port of ``nope_nerf_tpu/utils/logging.py``): tensorboard
scalars when ``torch.utils.tensorboard`` imports, an always-on
``events.jsonl`` of {tag, value, step, t} lines beside them, and the rays/s
counter that the training loop logs as ``perf/rays_per_sec``.
"""
from __future__ import annotations

import json
import os
import time


def summary_writer_class():
    """``torch.utils.tensorboard.SummaryWriter``, or None where it does not
    import. Where TensorFlow is installed, importing tensorboard imports it,
    and TensorFlow's first import draws from ``np.random``: the training
    loop calls this before it seeds ``np.random``, so that the frame order
    of a run does not depend on whether the process had loaded TensorFlow
    before (the JAX package's process has)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter


class MetricsLogger:
    """Writes every scalar to ``<log_dir>/events.jsonl`` and, when
    tensorboard imports, to a ``SummaryWriter`` in the same directory;
    without tensorboard the jsonl file is the whole log."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        self.tb = None
        writer = summary_writer_class()
        if writer is not None:
            try:
                self.tb = writer(log_dir)
            except Exception:
                pass

    def add_scalar(self, tag, value, step):
        value = float(value)
        self.jsonl.write(json.dumps({"tag": tag, "value": value,
                                     "step": int(step), "t": time.time()})
                         + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def flush(self):
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self.flush()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class Throughput:
    """rays/s over the steps ticked since the last ``reset``."""

    def __init__(self, rays_per_step):
        self.rays_per_step = rays_per_step
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n=1):
        self.steps += n

    def rate(self):
        dt = time.perf_counter() - self.t0
        return self.steps * self.rays_per_step / max(dt, 1e-9)

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
