"""Profiling: ``torch.profiler`` trace windows on the reference's schedule.

The port's counterpart of ``relora_tpu/utils/profiling.py``.  The reference
steps a profiler with schedule (wait=1, warmup=1, active=3, repeat=2) once
an update (torchrun_main.py:322-335, :944); :class:`StepProfiler` opens and
closes its windows on the same calls as the JAX package's, over
``torch.profiler`` (CPU activity, and the device's kernels where CUDA is
available), and writes each window as Chrome trace-event JSON,
``<log_dir>/trace_<window>.json``, which Perfetto and
``chrome://tracing`` open.  :class:`DeviceWindow` measures a device's busy
and idle share over a window a caller opens and closes (a server's
``/admin/profile``), through the one reader of the profiler's raw records,
:func:`kineto_intervals` and :func:`busy_ns`.
"""

from __future__ import annotations

import logging
import os
import time
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


def kineto_intervals(prof, device_type=None):
    """The ``[(start ns, end ns)]`` and ``{name cut to 80 characters: µs}``
    of a stopped profiler's events on ``device_type`` (the CUDA device by
    default), from its raw records (``prof.profiler.kineto_results``).
    ``prof.events()`` builds an object tree over the same records first,
    about a minute over a drain's 10^5 kernels; ``chip_smoke.py``'s
    ``check_profile_readers`` holds the two equal on the card, a CPU test on
    the CPU's events."""
    import torch

    if device_type is None:
        device_type = torch.autograd.DeviceType.CUDA
    intervals, by_name = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == device_type and ev.duration_ns() > 0:
            start = ev.start_ns()
            intervals.append((start, start + ev.duration_ns()))
            name = ev.name()[:80]
            by_name[name] = by_name.get(name, 0.0) + ev.duration_ns() / 1e3
    return intervals, by_name


def busy_ns(intervals) -> int:
    """The length of the union of ``intervals``, so that overlapping
    streams are not counted twice."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy


class DeviceWindow:
    """A ``torch.profiler`` window over the device's kernels alone, for a
    busy and idle share: :meth:`stop` returns the window's wall seconds,
    the device's busy seconds (:func:`busy_ns` over :func:`kineto_intervals`),
    the idle share, the kernel count, and ``read_s``, the seconds the stop
    and the read took (the window's own cost).  Without a CUDA device it
    traces the CPU and counts no kernel.  The profiler's state belongs to
    the thread that started it: call :meth:`start` and :meth:`stop` on one
    thread.  ``opened`` counts the windows started, so a deferred close can
    tell whether its window is still the open one."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self.opened = 0

    @property
    def open(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch

        if self._prof is not None:
            raise RuntimeError("a device profile window is already open")
        cuda = torch.cuda.is_available()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
        ])
        self._prof.start()
        self._t0 = time.perf_counter()
        self.opened += 1

    def stop(self) -> dict:
        import torch

        if self._prof is None:
            raise RuntimeError("no device profile window is open")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t_stop = time.perf_counter()
        wall = t_stop - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        intervals, _ = kineto_intervals(prof)
        busy = busy_ns(intervals) / 1e9
        return {"wall_s": wall, "device_busy_s": busy,
                "device_idle_share": 1.0 - busy / max(wall, 1e-9),
                "kernels": len(intervals), "read_s": time.perf_counter() - t_stop}


def maybe_make_profiler(cfg, run_name: str = "run") -> Optional[StepProfiler]:
    """``None`` unless ``--profile true``; else a profiler writing under
    ``profiler_logs/<run_name>``."""
    if not getattr(cfg, "profile", False):
        return None
    return StepProfiler(os.path.join("profiler_logs", run_name))
