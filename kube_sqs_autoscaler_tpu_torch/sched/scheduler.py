"""One event-driven scheduler for both control planes.

The autoscaler tick loop (:meth:`~..core.loop.ControlLoop.run`) and the
serving refill/step cycle (:meth:`~..fleet.pool.FleetDriver.run`) grew
up as two hand-rolled loops, each owning time its own way — a sleep
loop here, a cycle-advance-maybe-tick interleave there.  That made
"act *between* cycles" impossible to express: there was no seam where a
policy output could land other than the replica integer.  This module
is that seam: ONE priority-ordered event queue over ONE clock
(:class:`~..core.clock.FakeClock` or wall), with recurring and one-shot
events, deterministic ordering, and an explicit place between engine
cycles where a :class:`~.knobs.KnobActuator` can flip engine knobs at
safe points.

Event ordering contract (the determinism the tests pin):

- events execute in ``(due, priority, seq)`` order — earliest due time
  first; at equal due times the lowest priority number first; at equal
  priority, registration order (``seq``).  Two runs that register the
  same events over the same :class:`~..core.clock.FakeClock` execute
  them in the identical order — there is no other source of order.
- a **recurring** event reschedules itself after its callback returns:
  ``anchor="grid"`` at ``due + period`` (fixed cadence, catch-up runs
  back-to-back if the clock jumped), ``anchor="after"`` at
  ``clock.now() + period`` — the re-anchor-rather-than-accumulate rule
  both hand-rolled loops already used (a long tick/cycle must not cause
  a burst of catch-up events).
- the scheduler advances the clock only when the next event is in the
  future (``clock.sleep`` — virtual on a FakeClock, real otherwise).
  An event body that advances the clock itself (the fleet cycle's
  ``cycle_dt``) therefore owns that time exactly as
  :class:`~..fleet.pool.FleetDriver` did.

:func:`drive_loop` re-expresses ``ControlLoop.run`` as one registered
``control-tick`` event — same sleep-first cadence, same sticky-stop and
``max_ticks`` semantics, byte-identical tick records (pinned by test).  The fleet analogue lives in
:class:`~.fleet.ScheduledFleetDriver`.
"""

from __future__ import annotations

import heapq
import itertools
import logging
from collections import deque
from typing import Any, Callable

from ..core.clock import Clock, SystemClock

log = logging.getLogger(__name__)

#: Priority bands (lower runs first at equal due times).  Control ticks
#: outrank serving cycles so a tick that came due while a cycle advanced
#: the clock fires before the next cycle — exactly the FleetDriver
#: interleave (cycle, advance, *then* the due tick, then the next cycle).
PRIORITY_CONTROL = 0
PRIORITY_KNOB = 5
PRIORITY_CYCLE = 10
PRIORITY_TIMER = 20


class ScheduledEvent:
    """One queue entry: a named callback with a due time.

    Mutable on purpose — :meth:`EventScheduler.cancel` flips
    ``cancelled`` and the heap lazily discards it (cheaper and simpler
    than heap surgery, and cancellation order cannot perturb execution
    order of the survivors).
    """

    __slots__ = ("name", "fn", "due", "period", "priority", "seq",
                 "anchor", "cancelled", "runs")

    def __init__(self, name: str, fn: Callable[[], Any], due: float,
                 *, period: float | None = None, priority: int = 0,
                 seq: int = 0, anchor: str = "grid") -> None:
        if anchor not in ("grid", "after"):
            raise ValueError(f"anchor must be 'grid'/'after', got {anchor!r}")
        if period is not None and period < 0:
            raise ValueError(f"period must be >= 0, got {period}")
        self.name = name
        self.fn = fn
        self.due = float(due)
        self.period = period
        self.priority = priority
        self.seq = seq
        self.anchor = anchor
        self.cancelled = False
        self.runs = 0


class EventScheduler:
    """A deterministic priority-ordered event queue over one clock."""

    def __init__(self, clock: Clock | None = None,
                 trace_capacity: int = 4096) -> None:
        self.clock = clock or SystemClock()
        self._heap: list[tuple[float, int, int, ScheduledEvent]] = []
        self._seq = itertools.count()
        self._stop = False
        self.events_run = 0
        #: ``(due, name)`` of every executed event, bounded — the
        #: determinism tests compare two runs' traces for equality.
        self.trace: deque[tuple[float, str]] = deque(maxlen=trace_capacity)

    # -- registration ----------------------------------------------------

    def _push(self, event: ScheduledEvent) -> ScheduledEvent:
        heapq.heappush(
            self._heap, (event.due, event.priority, event.seq, event)
        )
        return event

    def at(self, name: str, when: float, fn: Callable[[], Any], *,
           priority: int = PRIORITY_TIMER) -> ScheduledEvent:
        """One-shot event at absolute clock time ``when`` (a past time
        fires on the next run step)."""
        return self._push(ScheduledEvent(
            name, fn, when, priority=priority, seq=next(self._seq),
        ))

    def after(self, name: str, delay: float, fn: Callable[[], Any], *,
              priority: int = PRIORITY_TIMER) -> ScheduledEvent:
        """One-shot event ``delay`` seconds from now."""
        return self.at(name, self.clock.now() + delay, fn,
                       priority=priority)

    def every(self, name: str, period: float, fn: Callable[[], Any], *,
              priority: int = PRIORITY_CYCLE, first_at: float | None = None,
              anchor: str = "grid") -> ScheduledEvent:
        """Recurring event.  First due at ``first_at`` (default:
        ``now + period``); see the module docstring for the two
        re-scheduling anchors."""
        due = self.clock.now() + period if first_at is None else first_at
        return self._push(ScheduledEvent(
            name, fn, due, period=period, priority=priority,
            seq=next(self._seq), anchor=anchor,
        ))

    def cancel(self, event: ScheduledEvent) -> None:
        """Cancel a registered event (idempotent; a recurring event
        stops rescheduling too)."""
        event.cancelled = True

    # -- execution -------------------------------------------------------

    def stop(self) -> None:
        """Ask :meth:`run` to return after the current event."""
        self._stop = True

    def reset_stop(self) -> None:
        self._stop = False

    @property
    def pending(self) -> int:
        """Live (non-cancelled) events still queued."""
        return sum(1 for *_k, e in self._heap if not e.cancelled)

    def run(self, *, max_events: int | None = None) -> int:
        """Execute events until the queue empties, :meth:`stop` is
        called, or ``max_events`` have run; returns how many ran.

        The wait-then-run step: if the head event is due in the future
        the scheduler blocks via ``clock.sleep`` (virtual on a
        FakeClock); an event whose callback moved the clock forward
        simply makes whatever is due next run without a wait.
        """
        ran = 0
        while self._heap and not self._stop:
            if max_events is not None and ran >= max_events:
                break
            due, _prio, _seq, event = self._heap[0]
            if event.cancelled:
                heapq.heappop(self._heap)
                continue
            now = self.clock.now()
            if due > now:
                self.clock.sleep(due - now)
            heapq.heappop(self._heap)
            self.trace.append((event.due, event.name))
            event.runs += 1
            self.events_run += 1
            ran += 1
            event.fn()
            if event.period is not None and not event.cancelled:
                event.due = (
                    event.due + event.period if event.anchor == "grid"
                    else self.clock.now() + event.period
                )
                event.seq = next(self._seq)
                self._push(event)
        return ran


def drive_loop(loop, *, max_ticks: int | None = None,
               scheduler: EventScheduler | None = None) -> Any:
    """Run a :class:`~..core.loop.ControlLoop` as a registered
    ``control-tick`` event — the sleep loop of ``ControlLoop.run``,
    re-expressed on the scheduler seam, byte-identical tick records.

    Semantics mirrored from ``run`` exactly: sleep *first* (the first
    tick lands one poll interval after start), a sticky :meth:`stop`
    requested mid-sleep skips the tick, ``max_ticks`` bounds the
    episode, and each call is a fresh episode whose state starts from
    :meth:`~..core.loop.ControlLoop.initial_policy_state`.  Returns the
    final policy state, like ``run``.

    On a caller-provided ``scheduler`` the episode owns that queue's
    run: the scheduler's stop flag is reset at episode start (a
    previous episode's stop must not silently zero this one — run()'s
    fresh-episode contract), and ending the episode (``max_ticks`` or
    ``loop.stop``) stops the current ``sched.run()`` — co-registered
    events resume on the caller's next ``run()`` call.
    """
    sched = scheduler or EventScheduler(loop.clock)
    sched.reset_stop()
    state = loop.initial_policy_state()
    if max_ticks is not None and max_ticks <= 0:
        return state
    box = {"state": state, "ticks": 0}

    def control_tick() -> None:
        if loop._stop.is_set():  # stop requested mid-sleep: skip the tick
            sched.stop()
            return
        box["state"] = loop.tick(box["state"])
        box["ticks"] += 1
        loop.ticks += 1
        if max_ticks is not None and box["ticks"] >= max_ticks:
            sched.stop()
        if loop._stop.is_set():
            sched.stop()

    event = sched.every(
        "control-tick", loop.config.poll_interval, control_tick,
        priority=PRIORITY_CONTROL, anchor="after",
    )
    if loop._stop.is_set():  # sticky pre-start stop, like run()
        sched.cancel(event)
        return box["state"]
    try:
        sched.run()
    finally:
        sched.cancel(event)
    return box["state"]
