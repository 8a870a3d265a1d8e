"""Prometheus registry of the serving worker: ``WorkloadMetrics``.

The port's copy of ``WorkloadMetrics`` from
``kube_sqs_autoscaler_tpu/obs/prometheus.py``: gauges, cumulative
histograms and span-timer summaries in the Prometheus text format 0.0.4,
standard library only.  Thread-safe: the worker's cycle thread writes,
the HTTP handler threads render.  Every value here is a host number the
worker wrote; rendering never touches a device tensor.
"""

from __future__ import annotations

import threading


def escape_help(text: str) -> str:
    """Escape a HELP line per the text exposition format (``\\`` and LF)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    """Escape a label value (``\\``, ``"`` and LF) — caller-supplied values
    (help text, versions, policy names) must not corrupt the exposition."""
    return (
        text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


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
