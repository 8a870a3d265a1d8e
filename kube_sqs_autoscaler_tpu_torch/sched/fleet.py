"""The fleet interleave as registered events: ScheduledFleetDriver.

:class:`~..fleet.pool.FleetDriver` interleaves fleet serving cycles
with control-loop ticks in one hand-rolled ``for`` loop.  This driver
re-expresses the SAME interleave as two recurring events on an
:class:`~.scheduler.EventScheduler` — ``fleet-cycle`` (supervise →
route → serve → retire, the untouched ``pool.run_cycle`` body) and
``control-tick`` (the untouched ``loop.tick`` body) — plus, when a
:class:`~.knobs.KnobActuator` is armed, a knob-application step at the
one provably safe instant: *between* cycles, after the previous cycle's
settle and before the next refill/dispatch.

Equivalence contract (byte-identical with knobs unarmed): tick records, dispatch/
transfer counters, replica trajectories, and replies are identical to
:class:`~..fleet.pool.FleetDriver` on the same episode, because the
bodies, their execution order, and every clock value they observe are
identical —

- each cycle event applies the fault plan, runs ``pool.run_cycle()``,
  and advances ``cycle_dt`` of virtual time, exactly like one
  ``FleetDriver`` iteration;
- the tick event is due at ``next_tick`` and, by priority, runs after
  the cycle that advanced the clock past it and before the next cycle —
  the ``clock.now() >= next_tick`` check position of the hand-rolled
  loop — then re-anchors to ``now + poll_interval``;
- the stop predicate is evaluated at the hand-rolled loop's exact check
  position: after the cycle when no tick is due, after the tick when
  one was.

Controller crashes (:class:`~..core.durable.ControllerCrash`) restart
through the inherited :meth:`~..fleet.pool.FleetDriver._crash_restart`
machinery — same factory contract, same downtime accounting, same
tick-attempt indexing — so the restart battery runs unchanged
under the scheduler (pinned by test and by ``--suite restart``).
"""

from __future__ import annotations

import logging

from ..core.durable import ControllerCrash
from ..fleet.pool import FleetDriver
from .scheduler import (
    EventScheduler,
    PRIORITY_CONTROL,
    PRIORITY_CYCLE,
)

log = logging.getLogger(__name__)


class ScheduledFleetDriver(FleetDriver):
    """A :class:`~..fleet.pool.FleetDriver` whose interleave is owned by
    the event scheduler (see module docstring).

    ``knobs`` (a :class:`~.knobs.KnobActuator`) arms live engine-knob
    actuation: staged knob changes apply between cycles.  ``knob_policy``
    (anything with an ``evaluate()`` method, e.g.
    :class:`~.knobs.ReactiveKnobPolicy`) is consulted once per control
    tick — the policy-drives-engine seam — or once per cycle when the
    driver runs loopless.  Both default off, keeping the driver
    byte-identical to the hand-rolled one.
    """

    def __init__(self, pool, loop=None, *, knobs=None, knob_policy=None,
                 **kwargs) -> None:
        super().__init__(pool, loop, **kwargs)
        self.knobs = knobs
        self.knob_policy = knob_policy
        self.scheduler: EventScheduler | None = None

    def _crash_restart(self, clock):
        state = super()._crash_restart(clock)
        if self.knobs is not None:
            # the restart factory replaced the pool: the actuator must
            # actuate the LIVE plane, not the abandoned pre-crash one
            # (staged changes survive and land at the next safe point)
            self.knobs.retarget(self.pool)
        rebind = getattr(self.knob_policy, "rebind", None)
        if rebind is not None and self.loop is not None:
            brain = getattr(self.loop, "depth_policy", None)
            if brain is not None:
                # a learned knob adapter reads its deltas from the
                # loop's policy object — the restart rebuilt that too
                rebind(brain)
        return state

    def run(self, *, until_processed=None, max_cycles: int = 100_000,
            until=None) -> dict:
        clock = self.loop.clock if self.loop is not None else self.pool.clock
        sched = EventScheduler(clock)
        self.scheduler = sched
        box = {"state": None, "cycles": 0, "exhausted": False}
        trajectory: list[int] = []
        tick_event = None

        def check_stop() -> None:
            if until is not None:
                if until():
                    sched.stop()
                    return
            elif (
                until_processed is not None
                and self.pool.processed >= until_processed
                and self.pool.idle
            ):
                sched.stop()
                return
            if box["exhausted"]:
                sched.stop()

        def fleet_cycle() -> None:
            if self.fault_plan is not None:
                self.fault_plan.apply(self.pool.cycle, self.pool)
            if self.knobs is not None:
                # THE safe point: the previous cycle fully settled, the
                # next refill/dispatch not yet issued — staged knob
                # changes land here (re-dispatch-boundary knobs stage
                # onto the engine and complete inside its next step)
                self.knobs.apply()
            self.pool.run_cycle()
            box["cycles"] += 1
            if self.cycle_dt:
                clock.advance(self.cycle_dt)  # FakeClock only
            if box["cycles"] >= max_cycles:
                box["exhausted"] = True
            if self.knob_policy is not None and self.loop is None:
                self.knob_policy.evaluate()
            # the hand-rolled loop checks its stop predicate after the
            # tick when one is due; otherwise right here
            if tick_event is None or clock.now() < tick_event.due:
                check_stop()

        def control_tick() -> None:
            self.tick_index += 1
            try:
                box["state"] = self.loop.tick(box["state"])
            except ControllerCrash:
                box["state"] = self._crash_restart(clock)
            else:
                self.loop.ticks += 1
                self.ticks += 1
                trajectory.append(self.pool.replicas)
                if self.crash_plan is not None and \
                        self.crash_plan.boundary_crash(self.tick_index - 1):
                    # tick-boundary kill: journal line AND snapshot
                    # landed; the restart must be seamless
                    box["state"] = self._crash_restart(clock)
            if self.knob_policy is not None:
                # forecast/policy outputs actuate engine knobs: the
                # decision rides the control tick, the change lands at
                # the next between-cycles safe point
                self.knob_policy.evaluate()
            check_stop()

        if self.loop is not None:
            box["state"] = self.loop.initial_policy_state()
            tick_event = sched.every(
                "control-tick", self.loop.config.poll_interval,
                control_tick, priority=PRIORITY_CONTROL, anchor="after",
            )
        # period 0 + anchor "after": the cycle event is always due —
        # back-to-back cycles, with the cycle body itself advancing
        # cycle_dt of virtual time, exactly like the hand-rolled loop
        cycle_event = sched.every(
            "fleet-cycle", 0.0, fleet_cycle,
            priority=PRIORITY_CYCLE, anchor="after",
        )
        try:
            sched.run()
        finally:
            sched.cancel(cycle_event)
            if tick_event is not None:
                sched.cancel(tick_event)
        return {
            "cycles": box["cycles"],
            "ticks": self.ticks,
            "processed": self.pool.processed,
            "replica_trajectory": trajectory,
            "final_replicas": self.pool.replicas,
            "crashes": self.crashes,
            "restarts": self.restarts,
        }
