"""Profiling over a window of train steps (``--profile-steps N:M``) with
``torch.profiler``. Counterpart of ``mnasnet_tpu/utils/profiling.py``'s
``StepTracer``, whose ``jax.profiler`` trace becomes a Chrome trace and a
table of device time by kernel, both written to the log directory when the
window closes.

    tracer = StepTracer("logs/profile", 10, 20)
    for step in ...:
        tracer.on_step(step)
        ...
    tracer.close()
"""

from __future__ import annotations

import os

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write(prof, logdir: str) -> None:
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    events = prof.key_averages()
    key = "self_cpu_time_total"
    if torch.cuda.is_available() and len(events):
        key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(events.table(sort_by=key, row_limit=60))


class StepTracer:
    """Start/stop a profiler trace over a step window (--profile-steps N:M)."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        self.start_step = start
        self.stop_step = stop
        self._prof = None

    def on_step(self, step: int):
        if step == self.start_step and self._prof is None:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            _write(prof, self.logdir)


def parse_profile_steps(spec: str):
    """'10:20' → (10, 20); '' → None."""
    if not spec:
        return None
    a, b = spec.split(":")
    return int(a), int(b)
