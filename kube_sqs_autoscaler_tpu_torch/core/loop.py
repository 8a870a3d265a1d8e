"""The control loop: sleep → poll → plan → actuate.

The port's copy of ``kube_sqs_autoscaler_tpu/core/loop.py`` on its
reference path: no resilience layer and no durable state (both raise
``ValueError`` until they are ported), no scheduler seam.  The loop owns
the side effects; all decisions come from the pure policy
(:mod:`.policy`), in the reference's order:

- sleep *first*, then poll — so the first observation happens one poll
  interval after start, and the cooldown stamps initialized at start
  (:func:`~.policy.initial_state`) give the startup grace window;
- a metric failure logs ``"Failed to get SQS messages: …"`` and skips the
  tick — the loop never dies;
- every observation logs ``"Found %d messages in the queue"``;
- an up-cooling tick logs and ends the tick;
- an actuation failure logs and ends the tick without touching policy
  state;
- only successful actuation (including boundary no-ops) advances the
  matching cooldown stamp.

The loop takes an injectable :class:`~.clock.Clock` and supports bounded
runs (``max_ticks``) and a cooperative stop.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

from .clock import Clock, SystemClock
from .events import TickObserver, TickRecord
from .policy import (
    Gate,
    PolicyConfig,
    PolicyState,
    gate_down,
    gate_up,
    initial_state,
    mark_scaled_down,
    mark_scaled_up,
)
from .types import DepthPolicy, MetricSource, Scaler

log = logging.getLogger(__name__)


@dataclass
class LoopConfig:
    """Loop cadence + policy knobs."""

    poll_interval: float = 5.0  # --poll-period
    policy: PolicyConfig = field(default_factory=PolicyConfig)


class ControlLoop:
    """Drives one scaler from one metric source on one clock."""

    def __init__(
        self,
        scaler: Scaler,
        metric_source: MetricSource,
        config: LoopConfig | None = None,
        clock: Clock | None = None,
        observer: TickObserver | None = None,
        depth_policy: DepthPolicy | None = None,
        resilience=None,
        durable=None,
    ) -> None:
        for knob, given in (("resilience", resilience),
                            ("durable", durable)):
            if given is not None:
                raise ValueError(
                    f"{knob} is not yet ported to the PyTorch port's "
                    "ControlLoop (reference path only)"
                )
        self.scaler = scaler
        self.metric_source = metric_source
        self.config = config or LoopConfig()
        self.clock = clock or SystemClock()
        self.observer = observer
        # None = reference behavior: gates threshold the observed depth.
        self.depth_policy = depth_policy
        self.ticks = 0  # completed ticks (observability; not used by policy)
        self._stop = threading.Event()

    def stop(self) -> None:
        """Ask the loop to exit after its current tick.  Sticky: a stop
        requested before :meth:`run` starts still takes effect; use
        :meth:`reset` to reuse a stopped loop."""
        self._stop.set()

    def reset(self) -> None:
        """Clear a previous :meth:`stop` so the loop can run again."""
        self._stop.clear()

    def initial_policy_state(self) -> PolicyState:
        """The episode's starting policy state: both cooldowns start "just
        scaled", the startup grace window."""
        return initial_state(self.clock.now())

    def run(self, max_ticks: int | None = None) -> PolicyState:
        """Run the loop; blocks until ``max_ticks`` ticks or :meth:`stop`.
        ``max_ticks=None`` runs forever.  Each call is a fresh episode;
        ``self.ticks`` accumulates across episodes."""
        state = self.initial_policy_state()
        ticks_this_run = 0
        while not self._stop.is_set():
            if max_ticks is not None and ticks_this_run >= max_ticks:
                break
            self.clock.sleep(self.config.poll_interval)
            if self._stop.is_set():  # stop requested mid-sleep: skip the tick
                break
            state = self.tick(state)
            ticks_this_run += 1
            self.ticks += 1
        return state

    def tick(self, state: PolicyState) -> PolicyState:
        """One loop body (post-sleep): observe, plan, actuate.  Returns the
        new state; the :class:`~.events.TickRecord` goes to the optional
        observer after the tick completes."""
        record = TickRecord(start=self.clock.now())
        try:
            return self._tick(state, record)
        finally:
            record.duration = self.clock.now() - record.start
            # the decide span is the remainder once observation and scaler
            # time are accounted, for ticks that got past the observation
            if record.metric_error is None and record.observe_s is not None:
                record.decide_s = max(
                    0.0,
                    record.duration - record.observe_s
                    - (record.actuate_s or 0.0),
                )
            if self.observer is not None:
                try:
                    self.observer.on_tick(record)
                except Exception:  # instrumentation must never kill the loop
                    log.exception("Tick observer failed")

    def _actuate(self, record: TickRecord, action) -> str | None:
        """One scaler call with its clock time accumulated into the record's
        actuate span; returns the error string on failure (tick ends)."""
        started = self.clock.now()
        try:
            action()
        except Exception as err:
            return str(err)
        finally:
            record.actuate_s = (record.actuate_s or 0.0) + (
                self.clock.now() - started
            )
        return None

    def _tick(self, state: PolicyState, record: TickRecord) -> PolicyState:
        try:
            num_messages = self.metric_source.num_messages()
        except Exception as err:  # the loop must never die
            record.observe_s = self.clock.now() - record.start
            log.error("Failed to get SQS messages: %s", err)
            record.metric_error = str(err)
            return state
        record.observe_s = self.clock.now() - record.start
        log.info("Found %d messages in the queue", num_messages)
        record.num_messages = num_messages

        # depth-policy seam: the gates threshold `decision`, the observed
        # depth unless a depth policy substitutes its own; a policy failure
        # falls back to the observed depth
        decision = num_messages
        if self.depth_policy is not None:
            try:
                decision = max(0, int(self.depth_policy.effective_messages(
                    self.clock.now(), num_messages)))
            except Exception as err:
                log.error(
                    "Depth policy failed, using observed depth: %s", err
                )
                decision = num_messages
            else:
                if decision != num_messages:
                    log.info(
                        "Forecast %d messages at horizon (observed %d)",
                        decision, num_messages,
                    )
                record.predicted_messages = getattr(
                    self.depth_policy, "last_prediction", None
                )
                record.forecast_error = getattr(
                    self.depth_policy, "last_abs_error", None
                )
        record.decision_messages = decision

        # gates are evaluated in turn with a fresh clock read each: under a
        # real clock the down gate sees time past the scale-up call
        policy = self.config.policy
        record.up = up = gate_up(decision, self.clock.now(), policy, state)
        if up is Gate.COOLING:
            log.info("Waiting for cool down, skipping scale up ")
            return state
        if up is Gate.FIRE:
            error = self._actuate(record, self.scaler.scale_up)
            if error is not None:
                log.error("Failed scaling up: %s", error)
                record.up_error = error
                return state
            state = mark_scaled_up(state, self.clock.now())

        record.down = down = gate_down(
            decision, self.clock.now(), policy, state
        )
        if down is Gate.COOLING:
            log.info("Waiting for cool down, skipping scale down")
            return state
        if down is Gate.FIRE:
            error = self._actuate(record, self.scaler.scale_down)
            if error is not None:
                log.error("Failed scaling down: %s", error)
                record.down_error = error
                return state
            state = mark_scaled_down(state, self.clock.now())

        return state
