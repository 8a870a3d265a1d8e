"""Wall-clock span timing for the worker's serve cycles.

The port's copy of ``SpanTimer`` from the JAX package's
``utils/profiling.py``: named spans on a monotonic clock with summary
percentiles, dependency-free.  (The JAX package's ``maybe_trace`` device
trace has no counterpart here yet.)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


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
