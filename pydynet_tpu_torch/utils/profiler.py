"""Profiling (counterpart of ``pydynet_tpu/utils/profiler.py``): ``trace``
around ``torch.profiler``, writing a TensorBoard trace, and ``StepTimer``,
the reference CLIs' throughput report (``llm/llama/infer.py:62-64``)."""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/tb') as prof: step()``. It takes
    the card's activity (its kernels) when CUDA is present, the host's
    always, and writes a TensorBoard trace under ``log_dir`` on exit; the
    yielded ``torch.profiler.profile`` answers ``key_averages()``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Throughput meter: items/sec over wall-clock, reference report style."""

    def __init__(self) -> None:
        self.reset()

    def reset(self):
        self._start = time.time()
        self._count = 0

    def step(self, n: int = 1):
        self._count += n

    @property
    def elapsed(self) -> float:
        return time.time() - self._start

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self._count / e if e > 0 else 0.0

    def report(self, unit: str = "tokens") -> str:
        return (f"{unit.capitalize()} count: {self._count}, "
                f"elapsed: {self.elapsed:.2f}s, "
                f"{round(self.rate)} {unit}/s")
