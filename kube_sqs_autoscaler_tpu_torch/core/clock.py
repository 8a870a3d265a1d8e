"""Injectable clock.

The port's copy of ``kube_sqs_autoscaler_tpu/core/clock.py``.

The reference couples its loop directly to ``time.Now()``/``time.Sleep``
(``main.go:37-41``), which forces its integration tests to burn ~56 s of real
wall time (SURVEY.md §4, §6).  Here every time-dependent component takes a
``Clock`` so the same behavioral scenarios run deterministically: the
production :class:`SystemClock` wraps the monotonic clock, and
:class:`FakeClock` advances virtual time on ``sleep`` and fires scheduled
callbacks — the deterministic analogue of the reference tests mutating the
mock queue from the test goroutine mid-run (``main_test.go:46-49``).
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Minimal clock surface the framework needs: read time, block for time."""

    def now(self) -> float:
        """Current time in seconds. Only differences are meaningful."""
        ...

    def sleep(self, seconds: float) -> None:
        """Block for ``seconds`` (virtual or real)."""
        ...


class SystemClock:
    """Real clock: monotonic ``now`` (immune to wall-clock steps), real sleep."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock:
    """Deterministic virtual clock for tests and simulation.

    ``sleep`` advances virtual time instantly, firing any callbacks scheduled
    via :meth:`at` / :meth:`after` in timestamp order as the clock passes
    them.  Callbacks run with the clock set to their scheduled instant, so a
    scenario like "the queue drains at t=7s" is exact rather than racy.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()  # FIFO tie-break for equal times
        self.sleeps: list[float] = []  # record of requested sleeps (for tests)

    def now(self) -> float:
        return self._now

    def at(self, when: float, callback: Callable[[], None]) -> None:
        """Schedule ``callback`` to fire when virtual time reaches ``when``.

        Scheduling in the past fires on the next advance.
        """
        heapq.heappush(self._events, (float(when), next(self._counter), callback))

    def after(self, delay: float, callback: Callable[[], None]) -> None:
        """Schedule ``callback`` ``delay`` seconds from the current instant."""
        self.at(self._now + delay, callback)

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.advance(max(0.0, seconds))

    def advance(self, seconds: float) -> None:
        """Move virtual time forward, firing due events in order."""
        deadline = self._now + float(seconds)
        while self._events and self._events[0][0] <= deadline:
            when, _, callback = heapq.heappop(self._events)
            self._now = max(self._now, when)
            callback()
        self._now = deadline
