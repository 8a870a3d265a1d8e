"""Opt-in profiling: device traces and wall-clock span timing.

The port's copy of ``kube_sqs_autoscaler_tpu/utils/profiling.py``:

- :func:`maybe_trace` — a context manager that records a region with
  ``torch.profiler`` (the card's kernels and copies when the device is a
  CUDA card, the host's operators always) and writes it as a Chrome trace
  under a directory, and is a free no-op without one.  Workers enable it
  with ``ServiceConfig(profile_dir=...)``.
- :class:`SpanTimer` — named wall-clock spans on a monotonic clock with
  summary percentiles, dependency-free.

``maybe_trace`` imports torch inside the context manager, so importing
this module imports no torch.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, device=None):
    """``with maybe_trace(dir, device):`` — a ``torch.profiler`` trace of
    the block when ``dir`` is set, written when the block exits as
    ``dir/trace-<pid>-<ms>.json`` (open it in ``chrome://tracing`` or
    Perfetto).  CUDA activity is recorded when ``device`` is a CUDA
    device.  ``None``/empty disables tracing with zero overhead."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"
    ))


@dataclass
class SpanTimer:
    """Thread-safe wall-clock span aggregation, dependency-free.
    :class:`~..workloads.service.QueueWorker` records each serve cycle
    under ``"cycle"``; reusable for any span.

    >>> timer = SpanTimer()
    >>> with timer.span("tick"):
    ...     pass
    >>> timer.summary()["tick"]["count"]
    1
    """

    clock: object = time  # injectable: needs .monotonic()
    _durations: dict = field(default_factory=lambda: defaultdict(list))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def span(self, name: str):
        start = self.clock.monotonic()
        try:
            yield
        finally:
            elapsed = self.clock.monotonic() - start
            with self._lock:
                self._durations[name].append(elapsed)

    def summary(self) -> dict:
        """Per-span ``{count, total_s, mean_s, p50_s, p99_s, max_s}``."""
        with self._lock:
            snapshot = {k: list(v) for k, v in self._durations.items()}
        out = {}
        for name, durations in snapshot.items():
            ordered = sorted(durations)
            n = len(ordered)
            out[name] = {
                "count": n,
                "total_s": sum(ordered),
                "mean_s": sum(ordered) / n,
                "p50_s": ordered[n // 2],
                "p99_s": ordered[min(n - 1, (n * 99) // 100)],
                "max_s": ordered[-1],
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._durations.clear()
