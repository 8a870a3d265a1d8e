"""The traced run's profiler window and what is read from it.

``torch.profiler`` records the card's operations through CUPTI (device
activity only: recording every host operator as well would slow the
host, and serving here is bound by the host).  The benchmark's own host
spans (``worker.refill``, ``engine.insert``, ``engine.step``,
``worker.settle``: the calls into each layer of the program) are taken by
the traffic driver on the same epoch clock.  :func:`summarize` reduces both to
the device's busy time (the union of its operations' intervals), time and
launches by kernel name, and the idle gaps by the host span that was open
when each began.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

@dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int
    # kernel name -> (seconds, launches)
    kernels: dict[str, tuple[float, int]] = field(default_factory=dict)
    # host span (or "host: outside the spans") -> idle seconds
    idle_by_span: dict[str, float] = field(default_factory=dict)

    def idle_share(self) -> float | None:
        """Percent of the window with no operation on the device; ``None``
        when nothing ran."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, marker: str) -> float:
        return sum(t for name, (t, _) in self.kernels.items() if marker in name)

    def breakdown(self) -> dict:
        ops = sorted(((n, t) for n, (t, _) in self.kernels.items()),
                     key=lambda item: -item[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda item: -item[1])[:10]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


class Window:
    """A profiled window.  :meth:`start` starts the profiler, which takes
    seconds, so a traffic driver whose window opens at a fixed time starts it
    early; :meth:`mark` opens the window read and :meth:`close` closes
    it; :meth:`stop` stops the profiler, which takes seconds more, once
    the run no longer measures.  Device intervals are clipped to the
    window.  ``spans`` is the traffic driver's list of ``(start_ns, end_ns,
    name)`` host spans (epoch clock, as the profiler's)."""

    def __init__(self, spans: list) -> None:
        self._prof = None
        self._t0 = self._t1 = 0.0
        self._ns0 = self._ns1 = 0
        self.spans = spans

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()

    def mark(self) -> None:
        self._t0, self._ns0 = time.perf_counter(), time.time_ns()

    def close(self) -> None:
        self._t1, self._ns1 = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        return self._t1 - self._t0

    def summarize(self) -> Summary:
        return summarize(self._prof, self.seconds, self.spans,
                         (self._ns0 / 1e3, self._ns1 / 1e3))


def _device_events(prof):
    """``(name, start_us, end_us)`` of every operation on the device."""
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        yield e.name(), start, start + e.duration_ns() / 1e3


def _innermost(spans: list, starts: list, t: float) -> str:
    """The latest-starting span of ``spans`` (sorted by start) open at
    ``t``; the benchmark's spans nest at most two deep."""
    i = bisect.bisect_right(starts, t) - 1
    for start, end, name in reversed(spans[max(i - 3, 0):i + 1]):
        if start <= t < end:
            return name
    return "host: outside the spans"


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(prof, window_s: float, host_spans: list,
              bounds: tuple[float, float]) -> Summary:
    """The device's operations inside ``bounds`` (epoch microseconds),
    each clipped to them."""
    device = []
    kernels: dict[str, list] = {}
    lo, hi = bounds
    for name, start, end in _device_events(prof):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        device.append((start, end))
        entry = kernels.setdefault(name, [0.0, 0])
        entry[0] += (end - start) / 1e6
        entry[1] += 1
    spans = [(a / 1e3, b / 1e3, name) for a, b, name in host_spans]
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) / 1e6
    idle: dict[str, float] = {}
    spans.sort()
    starts = [s[0] for s in spans]
    for (_, end), (start, _) in zip(busy, busy[1:]):
        label = _innermost(spans, starts, end)
        idle[label] = idle.get(label, 0.0) + (start - end) / 1e6
    return Summary(
        window_s=window_s, busy_s=busy_s,
        launches=sum(n for _, n in kernels.values()),
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        idle_by_span=idle)
