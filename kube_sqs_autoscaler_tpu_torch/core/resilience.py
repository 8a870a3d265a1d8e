"""Resilience layer: retries, deadlines, circuit breaker, stale-depth hold.

The port's copy of ``kube_sqs_autoscaler_tpu/core/resilience.py``.

The reference's entire failure story is "log and skip the tick"
(``main.go:43-47,57-60,71-74``): a flaky metric source silently freezes
scaling for the whole poll interval, a dead API server eats the tick
budget on every gate fire, and nothing distinguishes "degraded for 20
minutes" from "one blip".  This module is the opt-in hardening around
those two RPC seams, composed from four small deterministic pieces:

- :class:`RetryPolicy` — jittered exponential backoff with a *seeded* RNG
  driven by the loop's injectable clock, budgeted within the poll
  interval (a retry storm must never push the next tick late by more
  than ``retry_budget_fraction`` of the period);
- :func:`call_with_deadline` — a per-call deadline measured on the same
  clock.  Python cannot safely cancel a blocking call, so the deadline
  is *post-hoc*: a call that returns after its deadline is treated as
  failed (``DeadlineExceeded``), which keeps the breaker/stale-hold
  accounting honest and is exactly measurable under a ``FakeClock``;
- :class:`CircuitBreaker` — three states (closed → open → half-open)
  around the scaler, so consecutive actuation failures stop paying the
  failing RPC's latency every tick; after ``reset_timeout`` one
  half-open probe decides re-close vs re-open;
- the stale-depth hold — on metric failure, the last good observation is
  reused within ``stale_depth_ttl`` (the tick proceeds, marked
  ``stale`` on the :class:`~.events.TickRecord`, never fed to forecaster
  history), then the loop falls back to the reference's fail-static
  skip.

Everything is configured by the frozen :class:`ResilienceConfig`; with
the defaults every feature is off and :class:`~.loop.ControlLoop`
behaves byte-for-byte like the reference (``ResilienceConfig().enabled``
is ``False`` and the loop keeps its original code path).

BaseException hygiene: only ``Exception`` is ever caught or retried —
``KeyboardInterrupt``/``SystemExit`` raised inside a wrapped call
propagate immediately, never consumed as "one more failure".
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .clock import Clock
from .types import ScaleError


class DeadlineExceeded(RuntimeError):
    """A wrapped call returned only after its per-call deadline."""


class CircuitOpenError(ScaleError):
    """The breaker rejected the call without attempting the RPC."""


#: Breaker states, in escalation order (the ints are the Prometheus
#: gauge encoding: closed=0, half_open=1, open=2).
BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
BREAKER_STATE_CODES = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


@dataclass(frozen=True)
class ResilienceConfig:
    """The resilience knobs, one per CLI flag.  Defaults = reference.

    ``metric_retries``/``scaler_retries`` are *extra* attempts after the
    first try; 0 (default) keeps the reference's single attempt.
    ``metric_timeout``/``scaler_timeout`` are per-attempt deadlines in
    seconds (0 = none).  ``breaker_failures`` consecutive scaler
    failures open the breaker (0 = no breaker); ``breaker_reset``
    seconds later one half-open probe is allowed through.
    ``stale_depth_ttl`` seconds is how long a failed poll may reuse the
    last good observation before the loop falls back to the reference's
    skip (0 = never hold).
    """

    metric_retries: int = 0  # --metric-retries
    metric_timeout: float = 0.0  # --metric-timeout (seconds)
    scaler_retries: int = 0  # --scaler-retries
    scaler_timeout: float = 0.0  # --scaler-timeout (seconds)
    breaker_failures: int = 0  # --breaker-failures
    breaker_reset: float = 60.0  # --breaker-reset (seconds)
    stale_depth_ttl: float = 0.0  # --stale-depth-ttl (seconds)
    retry_base_delay: float = 0.2  # first backoff (seconds)
    retry_max_delay: float = 2.0  # backoff cap (seconds)
    retry_jitter: float = 0.5  # fraction of each delay randomized away
    retry_budget_fraction: float = 0.5  # of the poll interval, per tick
    retry_seed: int = 0  # backoff jitter RNG seed (determinism)

    @property
    def enabled(self) -> bool:
        """Is any opt-in feature on?  ``False`` = pure reference loop."""
        return bool(
            self.metric_retries
            or self.metric_timeout
            or self.scaler_retries
            or self.scaler_timeout
            or self.breaker_failures
            or self.stale_depth_ttl
        )


class RetryPolicy:
    """Seeded jittered exponential backoff on an injectable clock.

    ``delay(attempt)`` for attempt ``n`` (0-based) is
    ``min(max_delay, base_delay * 2**n)`` with up to ``jitter`` of it
    removed by the seeded RNG — deterministic for a given seed, decorrelated
    across controllers sharing a flaky dependency.
    """

    def __init__(
        self,
        retries: int,
        base_delay: float = 0.2,
        max_delay: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
    ) -> None:
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.retries = retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based). Consumes one RNG draw."""
        delay = min(self.max_delay, self.base_delay * (2.0**attempt))
        if self.jitter:
            delay *= 1.0 - self.jitter * self._rng.random()
        return delay

    def run(
        self,
        fn,
        clock: Clock,
        timeout: float = 0.0,
        deadline: float | None = None,
        on_attempts=None,
    ) -> tuple[object, int]:
        """``fn()`` with up to ``retries`` retried attempts.

        Returns ``(result, extra_attempts_used)``.  ``timeout`` is the
        per-attempt deadline (:func:`call_with_deadline`); ``deadline``
        is the *budget*: no backoff sleep may carry the clock past it —
        the last error re-raises instead (the next poll is never pushed
        late by a retry storm).  ``on_attempts`` (optional) is called
        with the running extra-attempt count before every attempt, so
        callers can ledger retries even when the final attempt raises.
        Only ``Exception`` is retried.
        """
        attempt = 0
        while True:
            if on_attempts is not None:
                on_attempts(attempt)
            try:
                return call_with_deadline(fn, clock, timeout), attempt
            except Exception:
                if attempt >= self.retries:
                    raise
                backoff = self.delay(attempt)
                if deadline is not None and clock.now() + backoff > deadline:
                    raise  # out of budget: surface the real error now
                clock.sleep(backoff)
                attempt += 1


def call_with_deadline(fn, clock: Clock, timeout: float = 0.0):
    """``fn()`` under a clock-measured deadline (0 = none).

    Post-hoc by design: a synchronous Python call cannot be safely
    cancelled, so a call that *returns* after ``timeout`` clock-seconds
    raises :class:`DeadlineExceeded` instead — the result is discarded
    and the failure feeds retries/breaker/stale-hold exactly like an
    RPC error would.  (A boundary-exact call — duration == timeout —
    still succeeds, matching the gates' boundary-fires convention.)
    """
    if not timeout:
        return fn()
    started = clock.now()
    result = fn()
    elapsed = clock.now() - started
    if elapsed > timeout:
        raise DeadlineExceeded(
            f"call took {elapsed:g}s, exceeding the {timeout:g}s deadline"
        )
    return result


class CircuitBreaker:
    """Three-state breaker: closed → open → half-open, loop-thread only.

    Closed counts *consecutive* failures; at ``failure_threshold`` it
    opens at that instant.  While open, :meth:`allow` rejects until
    ``reset_timeout`` has elapsed, then flips to half-open and admits
    one probe: a success closes (counter reset), a failure re-opens and
    restarts the full reset wait.  Timestamps come from the caller (the
    loop's clock) so every transition is deterministic under a
    ``FakeClock``.
    """

    def __init__(self, failure_threshold: int, reset_timeout: float) -> None:
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if reset_timeout < 0:
            raise ValueError(
                f"reset_timeout must be >= 0, got {reset_timeout}"
            )
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.state = BREAKER_CLOSED
        self.failures = 0  # consecutive, reset on any success
        self.opened_at: float | None = None

    def allow(self, now: float) -> bool:
        """May a call proceed at ``now``?  Open→half-open happens here."""
        if self.state == BREAKER_OPEN:
            assert self.opened_at is not None
            if now >= self.opened_at + self.reset_timeout:
                self.state = BREAKER_HALF_OPEN  # one probe goes through
                return True
            return False
        return True  # closed or half-open (the probe itself)

    def seconds_until_probe(self, now: float) -> float:
        """Time until the next half-open probe (0 when calls may proceed)."""
        if self.state != BREAKER_OPEN or self.opened_at is None:
            return 0.0
        return max(0.0, self.opened_at + self.reset_timeout - now)

    def record_success(self) -> None:
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.opened_at = None

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == BREAKER_HALF_OPEN or (
            self.failures >= self.failure_threshold
        ):
            self.state = BREAKER_OPEN
            self.opened_at = now


class ResiliencePolicy:
    """One config + one clock, bound into the loop's two RPC seams.

    Owns the per-seam :class:`RetryPolicy` instances (independent seeded
    RNG streams so metric retries never perturb scaler jitter), the
    optional :class:`CircuitBreaker`, and the last-good-observation
    state behind the stale-depth hold.  Single-threaded by contract —
    it lives inside the loop's tick.
    """

    def __init__(
        self, config: ResilienceConfig, clock: Clock, poll_interval: float
    ) -> None:
        self.config = config
        self.clock = clock
        self.poll_interval = poll_interval
        self._metric_retry = RetryPolicy(
            config.metric_retries,
            base_delay=config.retry_base_delay,
            max_delay=config.retry_max_delay,
            jitter=config.retry_jitter,
            seed=config.retry_seed,
        )
        self._scaler_retry = RetryPolicy(
            config.scaler_retries,
            base_delay=config.retry_base_delay,
            max_delay=config.retry_max_delay,
            jitter=config.retry_jitter,
            seed=config.retry_seed + 1,
        )
        self.breaker = (
            CircuitBreaker(config.breaker_failures, config.breaker_reset)
            if config.breaker_failures > 0
            else None
        )
        self._last_good: tuple[float, int] | None = None  # (t, depth)

    @property
    def breaker_state(self) -> str | None:
        """Current breaker state name (``None`` when no breaker)."""
        return self.breaker.state if self.breaker is not None else None

    def _budget_deadline(self, tick_start: float) -> float:
        return tick_start + self.config.retry_budget_fraction * self.poll_interval

    def observe(self, fn, record) -> int:
        """One metric poll with retries + deadline; remembers the last
        good depth for the stale hold.  Retry attempts used (success or
        not) land on ``record.metric_retries``."""

        def note(extra: int) -> None:
            if extra:
                record.metric_retries = extra

        value, _ = self._metric_retry.run(
            fn,
            self.clock,
            timeout=self.config.metric_timeout,
            deadline=self._budget_deadline(record.start),
            on_attempts=note,
        )
        depth = int(value)
        self._last_good = (self.clock.now(), depth)
        return depth

    def stale_depth(self, now: float) -> tuple[int, float] | None:
        """``(depth, age_s)`` of a last good observation still inside the
        TTL, else ``None`` (fail static, the reference behavior)."""
        if self.config.stale_depth_ttl <= 0 or self._last_good is None:
            return None
        t, depth = self._last_good
        age = now - t
        if age > self.config.stale_depth_ttl:
            return None
        return depth, age

    def actuate(self, action, record) -> None:
        """One scaler call through the breaker, deadline, and retries.

        An open breaker raises :class:`CircuitOpenError` without touching
        the scaler (the loop's failed-actuation path handles it: log,
        end tick, cooldown untouched).  The breaker records the *final*
        outcome — retries within one tick are one verdict.
        """
        now = self.clock.now()
        if self.breaker is not None and not self.breaker.allow(now):
            raise CircuitOpenError(
                f"circuit breaker open after {self.breaker.failures} "
                f"consecutive scaler failures; next probe in "
                f"{self.breaker.seconds_until_probe(now):.1f}s"
            )
        base = record.scaler_retries or 0  # up + down share one ledger

        def note(extra: int) -> None:
            if base + extra:
                record.scaler_retries = base + extra

        try:
            self._scaler_retry.run(
                action,
                self.clock,
                timeout=self.config.scaler_timeout,
                deadline=self._budget_deadline(record.start),
                on_attempts=note,
            )
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure(self.clock.now())
            raise
        else:
            if self.breaker is not None:
                self.breaker.record_success()

    # ------------------------------------------------------------------
    # Durable-state surface (core/durable.py StateProvider): the breaker
    # and the stale-hold are exactly the control state a restart used to
    # zero — a crashed controller came back with a CLOSED breaker and
    # hammered the still-dead apiserver, and with no last-good depth to
    # hold through the outage that killed it.
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        state: dict = {"records": 0}
        if self._last_good is not None:
            t, depth = self._last_good
            state["last_good"] = {"t": t, "depth": depth}
            state["records"] += 1
        if self.breaker is not None:
            state["breaker"] = {
                "state": self.breaker.state,
                "failures": self.breaker.failures,
                "opened_at": self.breaker.opened_at,
            }
            state["records"] += 1
        return state

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        """Restore the stale-hold observation and the breaker, every
        instant shifted by ``rebase`` — a held depth that aged past its
        TTL during the downtime expires through the ordinary
        :meth:`stale_depth` age check, and an open breaker whose reset
        window elapsed while the pod was down re-probes immediately
        through the ordinary :meth:`~CircuitBreaker.allow` check."""
        recovered = 0
        last_good = state.get("last_good")
        if isinstance(last_good, dict):
            try:
                t = float(last_good["t"]) + rebase
                depth = int(last_good["depth"])
            except (KeyError, TypeError, ValueError):
                pass
            else:
                self._last_good = (t, depth)
                recovered += 1
        saved = state.get("breaker")
        if self.breaker is not None and isinstance(saved, dict):
            name = saved.get("state")
            opened = saved.get("opened_at")
            if name == BREAKER_OPEN and opened is None:
                # an open breaker with no timestamp could never probe
                # again — refuse the record, keep the fresh closed
                # breaker (cold is safe; wedged-open forever is not)
                name = None
            if name in BREAKER_STATE_CODES:
                self.breaker.state = name
                self.breaker.failures = int(saved.get("failures", 0) or 0)
                self.breaker.opened_at = (
                    float(opened) + rebase if opened is not None else None
                )
                recovered += 1
        return recovered
