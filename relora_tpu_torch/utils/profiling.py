"""Profiling: ``torch.profiler`` trace windows on the reference's schedule.

The port's counterpart of ``relora_tpu/utils/profiling.py``.  The reference
steps a profiler with schedule (wait=1, warmup=1, active=3, repeat=2) once
an update (torchrun_main.py:322-335, :944); :class:`StepProfiler` opens and
closes its windows on the same calls as the JAX package's, over
``torch.profiler`` (CPU activity, and the device's kernels where CUDA is
available), and writes each window as Chrome trace-event JSON,
``<log_dir>/trace_<window>.json``, which Perfetto and
``chrome://tracing`` open.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def start_trace():
    """A started ``torch.profiler.profile`` over the CPU and, where there is
    one, the CUDA device."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, path: str) -> None:
    """Stop ``prof`` and write its Chrome trace to ``path``."""
    prof.stop()
    prof.export_chrome_trace(path)


class StepProfiler:
    """Step-driven trace windows: wait ``wait`` steps, warm up ``warmup``,
    record ``active``, ``repeat`` times (the JAX package's ``StepProfiler``,
    step for step)."""

    def __init__(
        self,
        log_dir: str,
        *,
        wait: int = 1,
        warmup: int = 1,
        active: int = 3,
        repeat: int = 2,
    ):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.wait = wait
        self.warmup = warmup
        self.active = active
        self.repeat = max(1, repeat)
        self._step = 0
        self._cycles_done = 0
        self._prof = None
        self.traces: list = []  # paths of the windows written

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def step(self) -> None:
        if self._cycles_done >= self.repeat:
            return
        cycle_len = self.wait + self.warmup + self.active
        if self._step % cycle_len == self.wait + self.warmup and not self.tracing:
            self._prof = start_trace()
            logger.info(f"profiler: trace started -> {self.log_dir}")
        self._step += 1
        if self.tracing and self._step % cycle_len == 0:
            self.stop()
            self._cycles_done += 1
            logger.info(f"profiler: trace {self._cycles_done}/{self.repeat} written")

    def stop(self) -> None:
        """End the open window, if any, and write its trace."""
        if self.tracing:
            path = os.path.join(self.log_dir, f"trace_{len(self.traces)}.json")
            prof, self._prof = self._prof, None
            stop_trace(prof, path)
            self.traces.append(path)

    # a mid-window exit (exception, preemption, budget reached) must not leave
    # the profiler running: the trainer calls close() from a finally
    def close(self) -> None:
        self.stop()


def maybe_make_profiler(cfg, run_name: str = "run") -> Optional[StepProfiler]:
    """``None`` unless ``--profile true``; else a profiler writing under
    ``profiler_logs/<run_name>``."""
    if not getattr(cfg, "profile", False):
        return None
    return StepProfiler(os.path.join("profiler_logs", run_name))
