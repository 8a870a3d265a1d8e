"""The control loop: sleep → poll → plan → actuate.

The port's copy of ``kube_sqs_autoscaler_tpu/core/loop.py``.  The loop
owns the side effects;
all decisions come from the pure policy (:mod:`.policy`), in the
reference's order:

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

``resilience=`` (:mod:`.resilience`) adds retries, deadlines, a circuit
breaker and the stale-depth hold around the two RPC seams; ``durable=``
(:mod:`.durable`) snapshots the control state after every tick and
rehydrates it at the episode's start.  With both off the tick records
are the reference path's, byte for byte.  The loop takes an injectable
:class:`~.clock.Clock` and supports bounded runs (``max_ticks``) and a
cooperative stop.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

from .clock import Clock, SystemClock
from .durable import ControllerCrash, DurableStateStore
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
from .resilience import ResilienceConfig, ResiliencePolicy
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
        resilience: ResilienceConfig | None = None,
        durable: DurableStateStore | None = None,
    ) -> None:
        self.scaler = scaler
        self.metric_source = metric_source
        self.config = config or LoopConfig()
        self.clock = clock or SystemClock()
        self.observer = observer
        # None = reference behavior: gates threshold the observed depth.
        self.depth_policy = depth_policy
        # None / all-defaults = reference behavior: one attempt per RPC,
        # metric failures fail static, no breaker (core/resilience.py).
        self.resilience = (
            ResiliencePolicy(resilience, self.clock, self.config.poll_interval)
            if resilience is not None and resilience.enabled
            else None
        )
        # None = reference behavior: the controller's memory dies with
        # the process.  With a DurableStateStore the loop snapshots its
        # whole control state after every tick and REHYDRATES it (via
        # initial_policy_state) at episode start — core/durable.py.
        self.durable = durable
        self.ticks = 0  # completed ticks (observability; not used by policy)
        self._stop = threading.Event()

    def stop(self) -> None:
        """Ask the loop to exit after its current tick.

        Sticky: a stop requested even *before* :meth:`run` starts (e.g. a
        SIGTERM landing between handler installation and the run call) still
        takes effect — ``run`` never clears the flag itself.  Use
        :meth:`reset` to reuse a stopped loop.
        """
        self._stop.set()

    def reset(self) -> None:
        """Clear a previous :meth:`stop` so the loop can run again."""
        self._stop.clear()

    def initial_policy_state(self) -> PolicyState:
        """The episode's starting policy state.

        Reference behavior (no durable store): ``initial_state(now)`` —
        both cooldowns start "just scaled", the startup grace window.
        With a :class:`~.durable.DurableStateStore` the store rehydrates
        first (snapshot + journal tail + unresolved actuation intent,
        reconciled against the scaler's observed replica count) and the
        restored, rebased cooldown stamps stand in; any refusal —
        missing, torn, corrupt, or future-schema snapshot — falls back
        to the cold start above, never to a crash.
        """
        now = self.clock.now()
        if self.durable is None:
            return initial_state(now)
        self.durable.rehydrate(
            now, observed_replicas=getattr(self.scaler, "replicas", None)
        )
        # consumed, not read: only the FIRST episode after boot starts
        # from the restored stamps — a later run() on the same loop is
        # a fresh episode (reference grace), per run()'s contract
        restored = self.durable.take_restored_policy_state()
        return restored if restored is not None else initial_state(now)

    def run(self, max_ticks: int | None = None, *,
            scheduler=None) -> PolicyState:
        """Run the loop; blocks until ``max_ticks`` ticks or :meth:`stop`.

        ``max_ticks=None`` runs forever, like the reference.  Each call is a
        fresh episode (fresh startup-grace state and tick budget);
        ``self.ticks`` accumulates across episodes for observability.

        ``scheduler`` hands the sleep loop to the event scheduler
        (:mod:`..sched`): an :class:`~..sched.scheduler.EventScheduler`, or
        ``True`` to build one on this loop's clock, runs the episode as a
        registered ``control-tick`` event, with the same cadence, stop and
        ``max_ticks`` semantics and identical tick records, on a queue
        other events can share.
        """
        if scheduler is not None and scheduler is not False:
            from ..sched.scheduler import drive_loop

            return drive_loop(
                self, max_ticks=max_ticks,
                scheduler=None if scheduler is True else scheduler,
            )
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
        """One loop body (post-sleep): observe, plan, actuate. Returns new state.

        Side-effect order and log lines are the reference's; the only
        addition is the :class:`~.events.TickRecord` handed to the optional
        observer after the tick completes.
        """
        record = TickRecord(start=self.clock.now())
        crashed = False
        new_state = state
        try:
            new_state = self._tick(state, record)
            return new_state
        except ControllerCrash:
            # simulated process death (sim/faults.CrashPlan): nothing
            # after this instant happens — no observer, no journal line,
            # no snapshot — exactly like the pod vanishing mid-tick
            crashed = True
            raise
        finally:
            if not crashed:
                if self.resilience is not None:
                    record.breaker_state = self.resilience.breaker_state
                record.duration = self.clock.now() - record.start
                # The decide span is the remainder once observation and
                # scaler time are accounted — defined only for ticks that
                # got past the observation (a metric failure ends the
                # tick inside observe).
                if record.metric_error is None and record.observe_s is not None:
                    record.decide_s = max(
                        0.0,
                        record.duration
                        - record.observe_s
                        - (record.actuate_s or 0.0),
                    )
                if self.observer is not None:
                    try:
                        self.observer.on_tick(record)
                    except Exception:  # instrumentation must never kill the loop
                        log.exception("Tick observer failed")
                # The snapshot is the LAST durable act of the tick — after
                # the journal observer, so the journal is never behind the
                # snapshot (rehydration replays the journal tail forward,
                # never backward).  A torn-journal crash (ControllerCrash
                # out of the observer, a BaseException the guard above
                # does not swallow) therefore skips the snapshot too.
                if self.durable is not None:
                    try:
                        self.durable.snapshot(
                            clock_now=self.clock.now(),
                            policy_state=new_state,
                            ticks=self.ticks + 1,
                            last_tick_start=record.start,
                        )
                    except Exception:  # durability must never kill the loop
                        log.exception("Control-plane snapshot failed")

    def _actuate(self, record: TickRecord, action, direction: str) -> str | None:
        """One scaler call with its clock time accumulated into the record's
        actuate span; returns the error string on failure (tick ends).
        With a resilience policy the call goes through the circuit breaker,
        per-call deadline, and retry budget (``core/resilience.py``) — an
        open breaker fails here without touching the scaler.  With a
        durable store, a write-ahead INTENT lands before the RPC: a crash
        between the actuation and the tick's snapshot must rehydrate as
        "may have scaled" (cooldown stamp advanced), never double-scale."""
        started = self.clock.now()
        if self.durable is not None:
            try:
                self.durable.note_intent(direction, started)
            except Exception:  # durability must never block an actuation
                log.exception("Actuation intent write failed")
        try:
            if self.resilience is not None:
                self.resilience.actuate(action, record)
            else:
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
            if self.resilience is not None:
                num_messages = self.resilience.observe(
                    self.metric_source.num_messages, record
                )
            else:
                num_messages = self.metric_source.num_messages()
        except Exception as err:  # the loop must never die
            record.observe_s = self.clock.now() - record.start
            # Degraded mode: within the stale TTL the tick proceeds on the
            # last good depth (marked stale; the forecaster history skips
            # it); past the TTL the reference's fail-static skip applies.
            held = (
                self.resilience.stale_depth(self.clock.now())
                if self.resilience is not None
                else None
            )
            if held is None:
                log.error("Failed to get SQS messages: %s", err)
                record.metric_error = str(err)
                return state
            num_messages, age = held
            record.stale = True
            record.stale_age_s = age
            log.warning(
                "Metric poll failed (%s); holding last good depth %d"
                " (age %.1fs of %gs TTL)",
                err,
                num_messages,
                age,
                self.resilience.config.stale_depth_ttl,
            )
        else:
            record.observe_s = self.clock.now() - record.start
            log.info("Found %d messages in the queue", num_messages)
        record.num_messages = num_messages

        # Depth-policy seam: the gates threshold `decision` — the observed
        # depth under the reactive default, the forecasted depth at
        # now + horizon under a predictive policy.  A policy failure falls
        # back to the observed depth; the loop never dies.  A stale-held
        # depth bypasses the policy: forecasting forward from an
        # observation that is itself old double-counts the staleness.
        decision = num_messages
        if self.depth_policy is not None and not record.stale:
            try:
                decision = max(
                    0,
                    int(
                        self.depth_policy.effective_messages(
                            self.clock.now(), num_messages
                        )
                    ),
                )
            except Exception as err:
                log.error(
                    "Depth policy failed, using observed depth: %s", err
                )
                # no forecast fields on the record: a stale prediction from
                # an earlier tick must not be exported as this tick's
                decision = num_messages
            else:
                if decision != num_messages:
                    log.info(
                        "Forecast %d messages at horizon (observed %d)",
                        decision,
                        num_messages,
                    )
                record.predicted_messages = getattr(
                    self.depth_policy, "last_prediction", None
                )
                record.forecast_error = getattr(
                    self.depth_policy, "last_abs_error", None
                )
        record.decision_messages = decision

        # Gates are evaluated sequentially with a fresh clock read each:
        # under a real clock the down gate sees time that has advanced past
        # the scale-up RPCs.
        policy = self.config.policy
        record.up = up = gate_up(decision, self.clock.now(), policy, state)
        if up is Gate.COOLING:
            log.info("Waiting for cool down, skipping scale up ")
            return state
        if up is Gate.FIRE:
            error = self._actuate(record, self.scaler.scale_up, "up")
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
            error = self._actuate(record, self.scaler.scale_down, "down")
            if error is not None:
                log.error("Failed scaling down: %s", error)
                record.down_error = error
                return state
            state = mark_scaled_down(state, self.clock.now())

        return state
