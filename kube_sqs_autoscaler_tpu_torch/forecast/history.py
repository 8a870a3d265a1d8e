"""Fixed-capacity ring buffer of ``(time, depth)`` observations.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/history.py`` (numpy
only, no torch).  The forecasters run over fixed-shape arrays, so the
history hands out ``(capacity,)``-shaped snapshots with a valid-sample
count rather than growing lists.

Feeding happens through the loop's observer seam: the class implements
:class:`~..core.events.TickObserver` and records every successful
observation (``record.num_messages``) at the tick's start time.
Thread-safe: the loop thread writes, forecast/scrape threads read.
"""

from __future__ import annotations

import threading

import numpy as np

from ..core.events import TickRecord


class DepthHistory:
    """Ring buffer of queue-depth observations on the loop's clock."""

    def __init__(self, capacity: int = 128) -> None:
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = capacity
        self._times = np.zeros(capacity, dtype=np.float64)
        self._depths = np.zeros(capacity, dtype=np.float64)
        self._total = 0  # samples ever observed (write index = total % cap)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    def observe(self, t: float, depth: float) -> None:
        """Append one observation (monotone ``t`` expected, not enforced)."""
        with self._lock:
            slot = self._total % self.capacity
            self._times[slot] = t
            self._depths[slot] = depth
            self._total += 1

    def on_tick(self, record: TickRecord) -> None:
        """:class:`~..core.events.TickObserver`: record successful reads.

        Stale-held depths (``record.stale``, the resilience layer's
        degraded mode) are NOT history: they are an old observation
        replayed at a new timestamp, and feeding them would teach every
        forecaster that the queue flatlined during the outage.
        """
        if record.num_messages is not None and not record.stale:
            self.observe(record.start, float(record.num_messages))

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, int]:
        """``(times, depths, n)`` — fixed ``(capacity,)`` shapes, the first
        ``n`` entries chronological, the tail padded with the newest sample
        (benign under masking, no huge jumps for unmasked arithmetic)."""
        with self._lock:
            n = min(self._total, self.capacity)
            if self._total <= self.capacity:
                times = self._times.copy()
                depths = self._depths.copy()
            else:
                start = self._total % self.capacity
                times = np.roll(self._times, -start)
                depths = np.roll(self._depths, -start)
        if 0 < n < self.capacity:
            times[n:] = times[n - 1]
            depths[n:] = depths[n - 1]
        return times, depths, n

    def export_state(self) -> dict:
        """Durable-state surface (``core/durable.py`` StateProvider):
        the ring's chronological samples.  A restart used to zero this
        buffer, sending every forecaster back through its reactive
        warm-up exactly when the post-crash backlog made forecasts
        matter most."""
        times, depths, n = self.snapshot()
        return {
            "records": n,
            "times": [float(t) for t in times[:n]],
            "depths": [float(d) for d in depths[:n]],
        }

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        """Re-observe the saved samples at their rebased instants —
        the downtime becomes a visible gap in the series, exactly what
        a trend fit should see.  Samples older than ``max_age_s`` at
        ``now`` (wall-clock age incl. the downtime) are dropped: stale
        demand history mis-trains every forecaster."""
        times = state.get("times") or []
        depths = state.get("depths") or []
        recovered = 0
        for t, depth in zip(times, depths):
            try:
                t, depth = float(t) + rebase, float(depth)
            except (TypeError, ValueError):
                continue
            if max_age_s > 0 and now is not None and now - t > max_age_s:
                continue
            self.observe(t, depth)
            recovered += 1
        return recovered

    def with_sample(
        self, t: float, depth: float
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Snapshot *as if* ``(t, depth)`` had just been observed.

        Pure — the buffer is not mutated.  Lets the predictive policy
        forecast from history *including* the current tick's observation,
        which only enters the real buffer via the observer after the tick
        completes.  When full, the oldest sample falls off, exactly as a
        real append would.
        """
        times, depths, n = self.snapshot()
        if n < self.capacity:
            times[n:] = t
            depths[n:] = depth
            return times, depths, n + 1
        times = np.roll(times, -1)
        depths = np.roll(depths, -1)
        times[-1] = t
        depths[-1] = depth
        return times, depths, n
