"""Profiling and tracing helpers (port of ``avex_tpu/utils/profiling.py``).

``torch.profiler`` trace capture and per-step timing, usable from the
``Trainer`` (``AVEX_PROFILE_DIR`` traces the first epoch) or a script:

    with trace("/tmp/profile"):
        trainer.train()

    timer = StepTimer()
    ...
    with timer.step():
        train_step(...)
    print(timer.summary())

``trace`` writes one TensorBoard/Chrome trace (``*.pt.trace.json``) into the
directory, with the card's kernels when CUDA is available; ``annotate``
names a region in it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List

import torch

__all__ = ["StepTimer", "annotate", "trace"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def annotate(name: str) -> torch.profiler.record_function:
    """A named region that shows up in the trace's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with warm-up-aware summaries."""

    def __init__(self, skip_first: int = 1) -> None:
        self.skip_first = skip_first
        self.durations: List[float] = []

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        """Time one step."""
        start = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - start)

    def summary(self) -> Dict[str, float]:
        """Aggregate durations, the first ``skip_first`` left out of the statistics."""
        timed = self.durations[self.skip_first:] or self.durations
        if not timed:
            return {"steps": 0}
        return {
            "steps": len(self.durations),
            "mean_s": sum(timed) / len(timed),
            "min_s": min(timed),
            "max_s": max(timed),
            "total_s": sum(self.durations),
        }
