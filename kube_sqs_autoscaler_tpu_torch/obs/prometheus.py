"""Prometheus registries: the controller's ``ControllerMetrics`` and the
serving worker's ``WorkloadMetrics``.

The port's copy of ``kube_sqs_autoscaler_tpu/obs/prometheus.py``.
:class:`ControllerMetrics` aggregates the loop's tick records (a
:class:`~..core.events.TickObserver`), with the resilience layer's
counters and the durable store's restart gauges; :class:`WorkloadMetrics`
holds the worker's gauges, cumulative histograms and span-timer
summaries.  Both render the Prometheus text format 0.0.4, standard
library only, and are thread-safe: the loop or the worker's cycle thread
writes, the HTTP handler threads render.  Every value here is a host
number; rendering never touches a device tensor.
"""

from __future__ import annotations

import threading
import time

from ..core.events import TickRecord
from ..core.policy import Gate
from ..core.resilience import BREAKER_STATE_CODES

_PREFIX = "kube_sqs_autoscaler"

# Tick latency histogram buckets (seconds).  A tick is two RPC round trips
# (SQS read + at most two apiserver writes): sub-ms in simulation, tens to
# hundreds of ms in production, pathological past 1 s — the buckets bracket
# all three regimes.  Cumulative ``le`` semantics; +Inf is the count.
TICK_DURATION_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_help(text: str) -> str:
    """Escape a HELP line per the text exposition format (``\\`` and LF)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    """Escape a label value (``\\``, ``"`` and LF) — caller-supplied values
    (help text, versions, policy names) must not corrupt the exposition."""
    return (
        text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class ControllerMetrics:
    """Tick-record aggregator + Prometheus text renderer.

    Implements the :class:`~..core.events.TickObserver` protocol; pass as
    ``ControlLoop(observer=...)``.
    """

    def __init__(
        self,
        version: str | None = None,
        policy: str = "reactive",
        forecaster: str = "",
    ) -> None:
        if version is None:
            from .. import __version__ as version  # the package's own build id
        self._build_labels = (
            ("version", version), ("policy", policy), ("forecaster", forecaster)
        )
        self._started_monotonic = time.monotonic()
        self._lock = threading.Lock()
        self._ticks = 0
        self._observations = 0
        self._metric_failures = 0
        self._queue_messages: int | None = None
        self._decision_messages: int | None = None
        self._predicted_messages: int | None = None
        self._forecast_abs_error: float | None = None
        self._cooldown_skips = {"up": 0, "down": 0}
        self._scale_events = {"up": 0, "down": 0}
        self._scale_failures = {"up": 0, "down": 0}
        self._tick_seconds_sum = 0.0
        self._tick_bucket_counts = [0] * len(TICK_DURATION_BUCKETS)
        # Resilience layer (core/resilience.py): degradation visibility.
        self._stale_ticks = 0
        self._retries = {"metric": 0, "scaler": 0}
        self._breaker_state: str | None = None
        self._consecutive_metric_failures = 0
        self._consecutive_scale_failures = 0
        self._last_successful_poll: float | None = None  # unix seconds
        self._last_successful_scale: float | None = None
        self._last_tick_monotonic: float | None = None
        # Durable control-plane restarts (core/durable.py): the store
        # pushes its RehydrationReport here; the rehydrating flag gates
        # /healthz at 503 until the first post-restart tick completes
        # (readiness must not route to a controller still reconciling).
        self._rehydrating = False
        self._restarts_total = 0
        self._rehydration_duration: float | None = None
        self._snapshot_age: float | None = None
        self._records_recovered: int | None = None
        self._records_expired: int | None = None

    def begin_rehydration(self) -> None:
        """The controller is reconciling restored state against the
        world; ``/healthz`` answers 503 until the next completed tick."""
        with self._lock:
            self._rehydrating = True

    @property
    def rehydrating(self) -> bool:
        with self._lock:
            return self._rehydrating

    def set_rehydration(self, report) -> None:
        """Record a :class:`~..core.durable.RehydrationReport`'s numbers
        (restart counter, duration, snapshot age, recovered/expired)."""
        with self._lock:
            self._restarts_total = int(getattr(report, "restarts", 0) or 0)
            self._rehydration_duration = float(
                getattr(report, "duration_s", 0.0) or 0.0
            )
            self._snapshot_age = float(
                getattr(report, "snapshot_age_s", 0.0) or 0.0
            )
            self._records_recovered = int(
                getattr(report, "records_recovered", 0) or 0
            )
            self._records_expired = int(
                getattr(report, "records_expired", 0) or 0
            )

    def on_tick(self, record: TickRecord) -> None:
        with self._lock:
            self._ticks += 1
            self._rehydrating = False  # first post-restart tick completed
            self._last_tick_monotonic = time.monotonic()
            self._tick_seconds_sum += record.duration
            for i, le in enumerate(TICK_DURATION_BUCKETS):
                if record.duration <= le:
                    self._tick_bucket_counts[i] += 1
            self._retries["metric"] += record.metric_retries or 0
            self._retries["scaler"] += record.scaler_retries or 0
            if record.breaker_state is not None:
                self._breaker_state = record.breaker_state
            # A stale-held tick IS a failed poll (the hold is the degraded
            # response to it): the consecutive-failure gauge must climb
            # through a blackout even while depth holds keep the gates fed.
            if record.metric_error is not None or record.stale:
                self._consecutive_metric_failures += 1
            else:
                self._consecutive_metric_failures = 0
                self._last_successful_poll = time.time()
            if record.stale:
                self._stale_ticks += 1
            if record.metric_error is not None:
                self._metric_failures += 1
                return
            if not record.stale:
                # a stale tick proceeded to the gates, but it is NOT a
                # successful queue read: readiness and the observed-depth
                # gauge stay pinned to genuinely fresh observations
                self._observations += 1
                self._queue_messages = record.num_messages
            if record.scaled("up") or record.scaled("down"):
                self._consecutive_scale_failures = 0
                self._last_successful_scale = time.time()
            elif record.up_error is not None or record.down_error is not None:
                self._consecutive_scale_failures += 1
            # unconditional: a tick without a forecast (reactive, warm-up,
            # or a failing depth policy) must CLEAR the forecast gauges —
            # latching the last success would export an arbitrarily stale
            # forecast as live (the loop's no-stale-forecast contract).
            self._decision_messages = record.decision_messages
            self._predicted_messages = record.predicted_messages
            self._forecast_abs_error = record.forecast_error
            for direction, gate, error in (
                ("up", record.up, record.up_error),
                ("down", record.down, record.down_error),
            ):
                if gate is Gate.COOLING:
                    self._cooldown_skips[direction] += 1
                elif gate is Gate.FIRE:
                    if error is None:
                        self._scale_events[direction] += 1
                    else:
                        self._scale_failures[direction] += 1

    @property
    def ready(self) -> bool:
        """Readiness = at least one successful queue observation."""
        with self._lock:
            return self._observations > 0

    def seconds_since_last_tick(self) -> float:
        """Wall seconds since the last completed tick (registry creation
        before the first one) — the liveness signal behind the server's
        ``--healthz-stale-after`` staleness threshold."""
        with self._lock:
            base = (
                self._last_tick_monotonic
                if self._last_tick_monotonic is not None
                else self._started_monotonic
            )
        return time.monotonic() - base

    def render(self) -> str:
        """The registry as Prometheus text exposition format 0.0.4."""
        with self._lock:
            lines = [
                f"# HELP {_PREFIX}_ticks_total Completed control-loop ticks.",
                f"# TYPE {_PREFIX}_ticks_total counter",
                f"{_PREFIX}_ticks_total {self._ticks}",
                f"# HELP {_PREFIX}_observations_total Successful queue-depth reads.",
                f"# TYPE {_PREFIX}_observations_total counter",
                f"{_PREFIX}_observations_total {self._observations}",
                f"# HELP {_PREFIX}_metric_failures_total Failed queue-depth reads.",
                f"# TYPE {_PREFIX}_metric_failures_total counter",
                f"{_PREFIX}_metric_failures_total {self._metric_failures}",
                f"# HELP {_PREFIX}_queue_messages Last observed queue depth.",
                f"# TYPE {_PREFIX}_queue_messages gauge",
            ]
            if self._queue_messages is not None:
                lines.append(f"{_PREFIX}_queue_messages {self._queue_messages}")
            lines += [
                f"# HELP {_PREFIX}_predicted_queue_messages Effective depth"
                " the depth policy substituted this tick: the forecast at"
                " now + horizon (predictive) or the network's decision"
                " depth (learned).",
                f"# TYPE {_PREFIX}_predicted_queue_messages gauge",
            ]
            if self._predicted_messages is not None:
                lines.append(
                    f"{_PREFIX}_predicted_queue_messages"
                    f" {self._predicted_messages}"
                )
            lines += [
                f"# HELP {_PREFIX}_decision_messages Depth the scaling gates"
                " thresholded on this tick (= observed depth when reactive).",
                f"# TYPE {_PREFIX}_decision_messages gauge",
            ]
            if self._decision_messages is not None:
                lines.append(
                    f"{_PREFIX}_decision_messages {self._decision_messages}"
                )
            lines += [
                f"# HELP {_PREFIX}_forecast_abs_error |forecast - actual| for"
                " the latest matured forecast (messages).",
                f"# TYPE {_PREFIX}_forecast_abs_error gauge",
            ]
            if self._forecast_abs_error is not None:
                lines.append(
                    f"{_PREFIX}_forecast_abs_error {self._forecast_abs_error}"
                )
            lines += [
                f"# HELP {_PREFIX}_scale_events_total Successful scale actuations"
                " (includes boundary no-ops, which the reference counts as"
                " success).",
                f"# TYPE {_PREFIX}_scale_events_total counter",
            ]
            lines += self._directional(self._scale_events, "scale_events_total")
            lines += [
                f"# HELP {_PREFIX}_scale_failures_total Failed scale actuations.",
                f"# TYPE {_PREFIX}_scale_failures_total counter",
            ]
            lines += self._directional(self._scale_failures, "scale_failures_total")
            lines += [
                f"# HELP {_PREFIX}_cooldown_skips_total Ticks skipped in cooldown.",
                f"# TYPE {_PREFIX}_cooldown_skips_total counter",
            ]
            lines += self._directional(self._cooldown_skips, "cooldown_skips_total")
            # Real cumulative histogram (was a 2-sample summary); the
            # _sum/_count names are unchanged so existing dashboards keep
            # working and rate(_sum)/rate(_count) stays the mean latency.
            lines += [
                f"# HELP {_PREFIX}_tick_duration_seconds Tick latency"
                " (observe + decide + actuate).",
                f"# TYPE {_PREFIX}_tick_duration_seconds histogram",
            ]
            for le, count in zip(
                TICK_DURATION_BUCKETS, self._tick_bucket_counts
            ):
                lines.append(
                    f'{_PREFIX}_tick_duration_seconds_bucket{{le="{le:g}"}}'
                    f" {count}"
                )
            lines += [
                f'{_PREFIX}_tick_duration_seconds_bucket{{le="+Inf"}}'
                f" {self._ticks}",
                f"{_PREFIX}_tick_duration_seconds_sum {self._tick_seconds_sum}",
                f"{_PREFIX}_tick_duration_seconds_count {self._ticks}",
            ]
            # Resilience layer: degradation made scrapable.  The counters
            # always render (zero = healthy); the breaker gauge and the
            # last-success timestamps render once they have a value
            # (no breaker configured / nothing succeeded yet).
            lines += [
                f"# HELP {_PREFIX}_stale_ticks_total Ticks that proceeded"
                " on a held (stale) queue depth after a failed poll.",
                f"# TYPE {_PREFIX}_stale_ticks_total counter",
                f"{_PREFIX}_stale_ticks_total {self._stale_ticks}",
                f"# HELP {_PREFIX}_retries_total Extra RPC attempts spent"
                " by the retry policy.",
                f"# TYPE {_PREFIX}_retries_total counter",
            ]
            lines += [
                f'{_PREFIX}_retries_total{{call="{call}"}} {count}'
                for call, count in self._retries.items()
            ]
            lines += [
                f"# HELP {_PREFIX}_consecutive_metric_failures Failed polls"
                " (incl. stale holds) since the last fresh observation.",
                f"# TYPE {_PREFIX}_consecutive_metric_failures gauge",
                f"{_PREFIX}_consecutive_metric_failures"
                f" {self._consecutive_metric_failures}",
                f"# HELP {_PREFIX}_consecutive_scale_failures Failed"
                " actuations since the last successful one.",
                f"# TYPE {_PREFIX}_consecutive_scale_failures gauge",
                f"{_PREFIX}_consecutive_scale_failures"
                f" {self._consecutive_scale_failures}",
                f"# HELP {_PREFIX}_breaker_state Scaler circuit breaker"
                " state (0=closed, 1=half_open, 2=open).",
                f"# TYPE {_PREFIX}_breaker_state gauge",
            ]
            if self._breaker_state is not None:
                lines.append(
                    f"{_PREFIX}_breaker_state"
                    f" {BREAKER_STATE_CODES[self._breaker_state]}"
                )
            lines += [
                f"# HELP {_PREFIX}_last_successful_poll_timestamp Unix time"
                " of the last fresh queue observation.",
                f"# TYPE {_PREFIX}_last_successful_poll_timestamp gauge",
            ]
            if self._last_successful_poll is not None:
                lines.append(
                    f"{_PREFIX}_last_successful_poll_timestamp"
                    f" {self._last_successful_poll}"
                )
            lines += [
                f"# HELP {_PREFIX}_last_successful_scale_timestamp Unix"
                " time of the last successful scale actuation.",
                f"# TYPE {_PREFIX}_last_successful_scale_timestamp gauge",
            ]
            if self._last_successful_scale is not None:
                lines.append(
                    f"{_PREFIX}_last_successful_scale_timestamp"
                    f" {self._last_successful_scale}"
                )
            # Durable restart visibility (core/durable.py): the restart
            # counter always renders (0 = never restarted); the report
            # gauges render once a rehydration produced them.
            lines += [
                f"# HELP {_PREFIX}_controller_restarts_total Controller"
                " restarts observed via the durable snapshot chain"
                " (0 = first boot or durability disabled).",
                f"# TYPE {_PREFIX}_controller_restarts_total counter",
                f"{_PREFIX}_controller_restarts_total {self._restarts_total}",
            ]
            for name, value, help_text in (
                ("rehydration_duration_seconds", self._rehydration_duration,
                 "Wall seconds the last startup rehydration took."),
                ("snapshot_age_seconds", self._snapshot_age,
                 "Age of the snapshot the last rehydration loaded"
                 " (the restart's downtime)."),
                ("state_records_recovered", self._records_recovered,
                 "Control-state records the last rehydration restored."),
                ("state_records_expired", self._records_expired,
                 "Control-state records the last rehydration expired or"
                 " refused (wall-clock TTLs, schema/hash refusals)."),
            ):
                lines += [
                    f"# HELP {_PREFIX}_{name} {help_text}",
                    f"# TYPE {_PREFIX}_{name} gauge",
                ]
                if value is not None:
                    lines.append(f"{_PREFIX}_{name} {value}")
            build_labels = ",".join(
                f'{name}="{escape_label_value(value)}"'
                for name, value in self._build_labels
            )
            lines += [
                f"# HELP {_PREFIX}_build_info Constant 1; controller"
                " build/config identity in the labels.",
                f"# TYPE {_PREFIX}_build_info gauge",
                f"{_PREFIX}_build_info{{{build_labels}}} 1",
                f"# HELP {_PREFIX}_process_uptime_seconds Seconds since the"
                " controller metrics registry was created.",
                f"# TYPE {_PREFIX}_process_uptime_seconds gauge",
                f"{_PREFIX}_process_uptime_seconds"
                f" {round(time.monotonic() - self._started_monotonic, 3)}",
            ]
            return "\n".join(lines) + "\n"

    @staticmethod
    def _directional(values: dict[str, int], name: str) -> list[str]:
        return [
            f'{_PREFIX}_{name}{{direction="{d}"}} {v}' for d, v in values.items()
        ]


_WORKLOAD_PREFIX = "kube_sqs_autoscaler_workload"


class WorkloadMetrics:
    """Workload-side registry: the worker's serving gauges, its TTFT
    histogram, the fleet's per-replica gauges and serve-cycle latency
    summaries pulled live from attached
    :class:`~..utils.profiling.SpanTimer` s at scrape time (p50/p99/max
    straight from the timer, no double bookkeeping), served by
    :class:`~.server.ObservabilityServer`.
    """

    #: Default latency buckets (seconds) for :meth:`observe_histogram` —
    #: spanning sub-ms prefill phases through minute-scale queue waits.
    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
        0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (name, labels) -> (value, help, kind); labels is a tuple of
        # (label, value) pairs or None for the unlabeled family
        self._gauges: dict[
            tuple[str, tuple[tuple[str, str], ...] | None],
            tuple[float, str, str],
        ] = {}
        # (name, labels) -> [bucket counts, sum, count, help, bounds]
        self._histograms: dict[
            tuple[str, tuple[tuple[str, str], ...] | None],
            list,
        ] = {}
        self._timers: dict[str, object] = {}

    def set_gauge(
        self,
        name: str,
        value: float,
        help_text: str = "",
        *,
        labels: tuple[tuple[str, str], ...] | None = None,
        kind: str = "gauge",
    ) -> None:
        """Record one sample (e.g. ``train_tokens_per_sec``).

        ``labels`` makes it one series of a labeled family (the fleet's
        per-replica gauges: ``fleet_replica_state{replica="3"}``);
        ``kind="counter"`` changes only the exposition TYPE line —
        monotonicity is the caller's contract, as with every counter the
        registries derive from caller-owned state."""
        with self._lock:
            self._gauges[(name, labels)] = (float(value), help_text, kind)

    def observe_histogram(
        self,
        name: str,
        value: float,
        help_text: str = "",
        *,
        labels: tuple[tuple[str, str], ...] | None = None,
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        """Record one observation into a CUMULATIVE histogram series —
        the real thing, not a windowed-deque gauge: counts never reset,
        so rate()/histogram_quantile() work across scrapes and restarts
        of the scraper (the request-lifecycle phase/TTFT/ITL/TPOT
        families are the motivating producers).  ``buckets`` fixes the
        upper bounds on the FIRST observation of a series; later calls
        reuse them."""
        with self._lock:
            entry = self._histograms.get((name, labels))
            if entry is None:
                bounds = tuple(buckets or self.DEFAULT_BUCKETS)
                entry = [[0] * len(bounds), 0.0, 0, help_text, bounds]
                self._histograms[(name, labels)] = entry
            counts, _, _, _, bounds = entry
            for index, bound in enumerate(bounds):
                if value <= bound:
                    counts[index] += 1
            entry[1] += value
            entry[2] += 1

    def histogram_quantile(
        self,
        name: str,
        q: float,
        *,
        labels: tuple[tuple[str, str], ...] | None = None,
    ) -> float | None:
        """Nearest-bucket-upper-bound quantile from the cumulative
        counts (what the benches gate on; coarser than the old
        sample-deque nearest-rank but bounded-memory and
        restart-additive).  None when the series has no observations;
        +Inf-bucket hits report the largest finite bound."""
        with self._lock:
            entry = self._histograms.get((name, labels))
            if entry is None:
                return None
            counts, _, count, _, bounds = entry
            if count <= 0:
                return None
            rank = max(1, int(round(q * count)))
            for index, bound in enumerate(bounds):
                if counts[index] >= rank:
                    return bound
            return bounds[-1] if bounds else None

    def attach_timer(self, name: str, timer) -> None:
        """Expose a SpanTimer's spans as ``<name>_<span>_seconds{quantile}``
        families, read live at every scrape."""
        with self._lock:
            self._timers[name] = timer

    def set_serving_gauges(
        self,
        *,
        tokens_per_second: float,
        time_to_first_token_seconds: float,
        active_slots: int,
        decode_block_utilization: float,
    ) -> None:
        """The serving hot-path gauge family the continuous worker
        reports each engine cycle, scraped alongside its cycle-latency
        summaries (one canonical name per number — dashboards pin these
        four)."""
        self.set_gauge(
            "tokens_per_second", tokens_per_second,
            "Generated tokens per second over the worker's serving "
            "lifetime (prefill first tokens included).",
        )
        self.set_gauge(
            "time_to_first_token_seconds", time_to_first_token_seconds,
            "Mean seconds from request admission to its first generated "
            "token being host-visible.",
        )
        self.set_gauge(
            "active_slots", active_slots,
            "Decode slots currently holding an in-flight request.",
        )
        self.set_gauge(
            "decode_block_utilization", decode_block_utilization,
            "Kept tokens per dispatched block-decode position "
            "(accepted/block-size; 0 until a block runs).",
        )

    def set_shard_gauges(
        self,
        shard: int,
        *,
        active: bool,
        active_slots: int,
        tokens_per_second: float,
        health: int = 0,
    ) -> None:
        """The sharded serving plane's per-shard gauge family (one labeled
        series per engine shard, refreshed every plane cycle by
        :class:`~..fleet.sharded.ShardedWorkerPool`).  ``health`` is the
        quarantine state machine's code (0 = healthy, 1 = probing, 2 =
        quarantined: ``fleet.SHARD_HEALTH_CODES``)."""
        labels = (("shard", str(shard)),)
        self.set_gauge(
            "shard_health", health,
            "Shard health per the quarantine state machine "
            "(0=healthy, 1=probing half-open, 2=quarantined).",
            labels=labels,
        )
        self.set_gauge(
            "shard_active", 1.0 if active else 0.0,
            "Shard participates in admission (1 — serving, or probing "
            "half-open with one slot; shard_health discriminates) or is "
            "draining/inactive/quarantined (0). Flipped by the scale "
            "path's device-side mask.",
            labels=labels,
        )
        self.set_gauge(
            "shard_active_slots", active_slots,
            "Decode slots of this shard currently holding an in-flight "
            "request.",
            labels=labels,
        )
        self.set_gauge(
            "shard_tokens_per_second", tokens_per_second,
            "Generated tokens per second attributed to this shard over "
            "the plane's serving lifetime.",
            labels=labels,
        )

    def set_tenant_gauges(
        self,
        tenant: str,
        *,
        queue_depth: int,
        ttft_seconds: float,
        tokens_per_second: float,
    ) -> None:
        """The multi-tenant admission plane's per-tenant gauges (one
        labeled series per tenant, refreshed every engine cycle by a
        tenancy :class:`~..workloads.continuous.ContinuousWorker`)."""
        labels = (("tenant", tenant),)
        self.set_gauge(
            "tenant_queue_depth", queue_depth,
            "Requests staged in this tenant's fair-admission sub-queue "
            "(the DRR lookahead window, not the shared queue's backlog).",
            labels=labels,
        )
        self.set_gauge(
            "tenant_ttft_seconds", ttft_seconds,
            "Mean seconds to first generated token over this tenant's "
            "requests, measured from QUEUE ARRIVAL (SentTimestamp) when "
            "the queue stamps it, else from admission: the queue wait is "
            "where a flooding tenant starves its victims, so this is the "
            "isolation signal.",
            labels=labels,
        )
        self.set_gauge(
            "tenant_tokens_per_second", tokens_per_second,
            "Generated tokens per second attributed to this tenant over "
            "the worker's serving lifetime.",
            labels=labels,
        )

    def set_admission_shard_gauges(self, shards) -> None:
        """The sharded admission plane's gauges, from its
        :class:`~..workloads.admission_shards.AdmissionShard` list: the
        ladder rollup (``overload_tier`` and ``overload_pressure`` the max
        over the shards' ladders, ``overload_tier_transitions_total``
        their sum) and one labeled series a shard of
        ``admission_shard_staged``, ``admission_shard_tenants`` and
        ``admission_shard_state`` (shard labels are a config knob, so they
        need no tenant-label bound)."""
        ladders = [s.ladder for s in shards if s.ladder is not None]
        if ladders:
            self.set_gauge(
                "overload_tier", max(ladder.tier for ladder in ladders),
                "Active overload-ladder tier (0 = serving normally, "
                "1 = degrading over-share tenants, 2 = + evicting cold "
                "prefix entries, 3 = + shedding staged requests).  "
                "Sharded admission: the MAX across per-shard ladders.",
            )
            self.set_gauge(
                "overload_pressure",
                max(ladder.last_pressure for ladder in ladders),
                "Measured overload pressure the ladder last acted on.  "
                "Sharded admission: the MAX across per-shard ladders.",
            )
            self.set_gauge(
                "overload_tier_transitions_total",
                sum(ladder.transitions for ladder in ladders),
                "Ladder tier transitions (enter + exit), summed across "
                "admission shards.",
                kind="counter",
            )
        for shard in shards:
            labels = (("shard", str(shard.index)),)
            self.set_gauge(
                "admission_shard_staged", shard.fair.staged,
                "Requests parked in this admission shard's staging slice.",
                labels=labels,
            )
            self.set_gauge(
                "admission_shard_tenants",
                sum(1 for depth in shard.fair.drr.depths().values()
                    if depth > 0),
                "Tenants with staged work on this admission shard.",
                labels=labels,
            )
            self.set_gauge(
                "admission_shard_state",
                0 if not shard.alive else (1 if shard.partitioned else 2),
                "Admission-shard liveness: 2 = serving, 1 = "
                "gossip-partitioned (still admitting), 0 = killed "
                "(staged work handed back; rehydrates next cycle).",
                labels=labels,
            )

    def set_plane_engine_gauges(self, batcher) -> None:
        """The decode plane's engine gauges, from a
        :class:`~..planes.engine.DecodePlaneBatcher`: the accepted-draft
        fraction ``speculative_accept_rate`` (unlabeled plane-wide, and
        one series a tenant, bounded upstream like every tenant series)
        and the ``plane_kv_transfers_total`` handoff counter."""
        if batcher.spec_layers:
            accept_help = (
                "Accepted-draft fraction of proposed speculative tokens in "
                "[0, 1] (labeled rows are per-tenant, bounded like every "
                "tenant series; the unlabeled row is plane-wide)."
            )
            rate = batcher.accept_rate()
            if rate is not None:
                self.set_gauge("speculative_accept_rate", rate, accept_help)
            for tenant in sorted(batcher.tenant_spec_rounds):
                self.set_gauge(
                    "speculative_accept_rate",
                    batcher.accept_rate(tenant) or 0.0, accept_help,
                    labels=(("tenant", tenant),),
                )
        self.set_gauge(
            "plane_kv_transfers_total", batcher.kv_transfers,
            "KV rows this decode plane adopted from prefill-plane donors "
            "over the handoff transport.",
            kind="counter",
        )

    def set_plane_pool_gauges(self, *, prefill_replicas: int,
                              decode_shards: int, kv_handoffs: int) -> None:
        """The disaggregated pool's plane gauges: serving prefill
        replicas and decode shards (the two Scaler axes) and the rows the
        pool's shuttle has handed from prefill to decode."""
        self.set_gauge(
            "plane_prefill_replicas", prefill_replicas,
            "Serving prefill-plane replicas (the pool Scaler's axis).",
        )
        self.set_gauge(
            "plane_decode_shards", decode_shards,
            "Serving decode-plane shards (the decode Scaler's axis).",
        )
        self.set_gauge(
            "plane_kv_transfers_total", kv_handoffs,
            "KV rows handed from the prefill plane to decode slots over "
            "the pool shuttle.",
            kind="counter",
        )

    def set_build_info(self, version: str, **labels: str) -> None:
        """The workload binary's ``build_info`` stamp (value 1, identity
        in the labels — the serving twin of the controller registry's
        build_info): version plus whatever deployment knobs the caller
        wants scrape-visible, e.g. the tenancy flags."""
        rendered = (("version", version),) + tuple(
            (name, str(value)) for name, value in sorted(labels.items())
        )
        self.set_gauge(
            "build_info", 1.0,
            "Workload build/deployment identity; value is always 1.",
            labels=rendered,
        )

    @property
    def ready(self) -> bool:
        """Readiness = at least one gauge sample or timed span recorded."""
        with self._lock:
            gauges, timers = dict(self._gauges), dict(self._timers)
            histograms = bool(self._histograms)
        return bool(gauges) or histograms or any(
            t.summary() for t in timers.values()
        )

    def render(self) -> str:
        with self._lock:
            gauges = dict(self._gauges)
            histograms = {
                key: (list(entry[0]), entry[1], entry[2], entry[3],
                      entry[4])
                for key, entry in self._histograms.items()
            }
            timers = dict(self._timers)
        lines: list[str] = []
        last_family = None
        for (name, labels), (value, help_text, kind) in sorted(
            gauges.items(),
            key=lambda item: (item[0][0], item[0][1] or ()),
        ):
            metric = f"{_WORKLOAD_PREFIX}_{name}"
            if name != last_family:
                # HELP/TYPE once per family, however many labeled series
                if help_text:
                    # caller-supplied text: a raw newline/backslash here
                    # would corrupt the whole exposition for every scraper
                    lines.append(
                        f"# HELP {metric} {escape_help(help_text)}"
                    )
                lines.append(f"# TYPE {metric} {kind}")
                last_family = name
            if labels:
                rendered = ",".join(
                    f'{label}="{escape_label_value(str(val))}"'
                    for label, val in labels
                )
                lines.append(f"{metric}{{{rendered}}} {value}")
            else:
                lines.append(f"{metric} {value}")
        last_family = None
        for (name, labels), (counts, total, count, help_text, bounds) in (
            sorted(
                histograms.items(),
                key=lambda item: (item[0][0], item[0][1] or ()),
            )
        ):
            metric = f"{_WORKLOAD_PREFIX}_{name}"
            if name != last_family:
                if help_text:
                    lines.append(
                        f"# HELP {metric} {escape_help(help_text)}"
                    )
                lines.append(f"# TYPE {metric} histogram")
                last_family = name
            base = ",".join(
                f'{label}="{escape_label_value(str(val))}"'
                for label, val in (labels or ())
            )
            for bound, cumulative in zip(bounds, counts):
                le = f'le="{bound:g}"'
                rendered = f"{base},{le}" if base else le
                lines.append(f"{metric}_bucket{{{rendered}}} {cumulative}")
            le = 'le="+Inf"'
            rendered = f"{base},{le}" if base else le
            lines.append(f"{metric}_bucket{{{rendered}}} {count}")
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{metric}_sum{suffix} {total}")
            lines.append(f"{metric}_count{suffix} {count}")
        for name, timer in sorted(timers.items()):
            for span, stats in sorted(timer.summary().items()):
                metric = f"{_WORKLOAD_PREFIX}_{name}_{span}_seconds"
                lines += [
                    f"# HELP {metric} Wall-clock span latency.",
                    f"# TYPE {metric} summary",
                    f'{metric}{{quantile="0.5"}} {stats["p50_s"]}',
                    f'{metric}{{quantile="0.99"}} {stats["p99_s"]}',
                    f'{metric}{{quantile="1.0"}} {stats["max_s"]}',
                    f"{metric}_sum {stats['total_s']}",
                    f"{metric}_count {stats['count']}",
                ]
        return "\n".join(lines) + "\n"
