"""What a traced window says: device intervals, busy and idle time, the
kernels by name, the copies, and the host spans that the idle gaps fall in.

A traced run wraps its traced work in ``torch.profiler`` and, inside it,
in the benchmark's own span ``bench.window``; the spans ``bench.<what>``
around its calls into the program name what the host was doing. The
profiler's events are read in memory (nothing is written to disk) into
plain tuples ``(kind, name, start_ns, duration_ns)``, kind one of
``kernel``, ``memcpy``, ``memset`` (device work) or ``span`` (a host
span of the benchmark's). A device event carries a fifth item, the host
time at which the runtime call that launched it (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``) started, where the profiler
links the two by their correlation id.

The device's timestamps are converted to the host's clock, and the two
drift apart by tens of microseconds over a traced run, so that the last
kernels of a window can read as ending after the host closed it. Which
device events belong to the window is therefore decided on the host's
clock, by when they were launched; only an event with no launch found is
placed by its own timestamps.
"""

from __future__ import annotations

import collections

WINDOW = "bench.window"


def events_of(prof) -> list[tuple]:
    """The profiler's events as ``(kind, name, start_ns, duration_ns)``.
    Device events are the kernels, copies and sets the card ran, with the
    host time of their launch (None where none is found) as a fifth item;
    the host spans are the benchmark's (``bench.*``)."""
    from torch.autograd import DeviceType

    out, device, launched = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        corr = getattr(e, "correlation_id", lambda: 0)()
        if e.device_type() == DeviceType.CUDA:
            user = getattr(e, "is_user_annotation", lambda: False)()
            if user or name.startswith("bench."):
                continue  # a host span's shadow on the device's timeline
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            device.append((kind, name, e.start_ns(), e.duration_ns(), corr))
        elif name.startswith("bench."):
            out.append(("span", name, e.start_ns(), e.duration_ns()))
        elif name.startswith("cu") and corr:
            launched[corr] = e.start_ns()  # a runtime call, on the host's clock
    out += [(k, n, s, d, launched.get(c) if c else None) for k, n, s, d, c in device]
    return out


def _union(intervals) -> list[tuple[int, int]]:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """The events of one traced window (the last ``bench.window`` span)."""

    def __init__(self, events: list[tuple]):
        windows = [(s, s + d) for k, n, s, d, *_ in events if k == "span" and n == WINDOW]
        if not windows:
            raise ValueError(f"no {WINDOW} span in the trace")
        self.w0, self.w1 = windows[-1]
        self.spans = [(n, max(s, self.w0), min(s + d, self.w1)) for k, n, s, d, *_ in events
                      if k == "span" and n != WINDOW and s < self.w1 and s + d > self.w0]
        # The window's device work, whole: each event launched inside it, or,
        # with no launch found, each that overlaps it.
        self.device = [(k, n, s, s + d) for k, n, s, d, *at in events
                       if k != "span" and d > 0 and self._inside(s, d, at)]
        self.busy = _union((max(a, self.w0), min(b, self.w1)) for _, _, a, b in self.device
                           if a < self.w1 and b > self.w0)

    def _inside(self, start: int, duration: int, at: list) -> bool:
        if at and at[0] is not None:
            return self.w0 <= at[0] < self.w1
        return start < self.w1 and start + duration > self.w0

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernels(self, patterns) -> tuple[int, float]:
        """(launches, seconds) of the kernels whose names hold a pattern."""
        hits = [b - a for k, n, a, b in self.device
                if k == "kernel" and any(p in n for p in patterns)]
        return len(hits), sum(hits) / 1e9

    def copies(self, direction: str) -> tuple[int, float]:
        """(copies, seconds) of the memcpys whose names hold ``direction``
        (``HtoD``, ``DtoH``, ``DtoD``)."""
        hits = [b - a for k, n, a, b in self.device if k == "memcpy" and direction in n]
        return len(hits), sum(hits) / 1e9

    def top_device_ops(self, n: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        by = collections.Counter()
        for _, name, a, b in self.device:
            by[name] += b - a
        return [[name[:160], ns / 1e9] for name, ns in by.most_common(n)]

    def gaps(self) -> list[tuple[int, int]]:
        """The stretches of the window in which the device ran nothing."""
        out, at = [], self.w0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.w1 > at:
            out.append((at, self.w1))
        return out

    def idle_by_span(self, n: int = 10) -> list[list]:
        """[span, seconds] of idle time by the host span it fell in (the
        innermost span that covers most of each gap; ``no span`` where none
        does), the largest first."""
        by = collections.Counter()
        for a, b in self.gaps():
            best, best_key = "no span", None
            for name, s, e in self.spans:
                cover = min(b, e) - max(a, s)
                if cover > 0:
                    key = (cover, -(e - s))  # most cover, then the innermost
                    if best_key is None or key > best_key:
                        best, best_key = name, key
            by[best] += b - a
        return [[name, ns / 1e9] for name, ns in by.most_common(n)]
