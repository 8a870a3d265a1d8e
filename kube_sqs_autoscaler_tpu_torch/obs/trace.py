"""Chrome/Perfetto trace-event export of tick records and instants.

The port's copy of ``kube_sqs_autoscaler_tpu/obs/trace.py``: one
complete ("X") span per tick with child spans for its three phases
(observe → decide → actuate), instant ("i") events at gate fires,
cooldown skips and metric failures, and instants from ``(name, t, args)``
events such as the fleet's supervisor decisions and the durable store's
restart instants, and per-request lifecycle spans threaded by flow
arrows (:func:`request_trace_events`).  Every event lands on the lane
(pid, tid) of its category, so the dicts equal the reference's for the
same inputs.
Timestamps are microseconds from the first record's start on the loop's
own clock.  Served live at ``/debug/trace`` by
:class:`~.server.ObservabilityServer`.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Sequence

from ..core.events import TickRecord
from ..core.policy import Gate

_PID = 1
_TID = 1

#: Category -> (pid, tid, process label, thread label).  Perfetto
#: renders one lane per (pid, tid), so giving each event category a
#: STATIC track assignment turns the previously interleaved single row
#: into separate lanes: controller ticks, fleet/replica lifecycle,
#: shard failure domain, restart/rehydration, knob actuations, the
#: overload ladder, prefix-pool residency, the disaggregated planes'
#: KV shuttle, and per-request lifecycle spans.  Keyed by category —
#: never by discovery order — so the same event lands on the same lane
#: across controller restarts and journal-rotation rejoins (pinned by
#: tests).
_TRACKS: dict[str, tuple[int, int, str, str]] = {
    "tick": (_PID, _TID, "controller", "ticks"),
    "phase": (_PID, _TID, "controller", "ticks"),
    "event": (_PID, _TID, "controller", "ticks"),
    "fleet": (2, 1, "fleet", "replicas"),
    "shard": (2, 2, "fleet", "shards"),
    "restart": (2, 3, "fleet", "restart"),
    "knob": (2, 4, "fleet", "knobs"),
    "overload": (3, 1, "admission", "overload"),
    "prefix": (3, 2, "admission", "prefix-pool"),
    "plane": (3, 3, "admission", "kv-shuttle"),
    "request": (4, 1, "requests", "queue"),
}

#: The request process's per-phase lanes (pid 4): each lifecycle span
#: renders on the lane of the phase that owns it, threaded together by
#: flow arrows carrying the trace's flow id.
_REQUEST_PID = 4
_REQUEST_LANES: dict[str, tuple[int, str]] = {
    "queue": (1, "queue"),
    "prefill": (2, "prefill"),
    "handoff": (3, "kv-handoff"),
    "decode": (4, "decode"),
    "settle": (5, "settle"),
    # scheduled-collective transfer windows (comms/): rendered at their
    # ABSOLUTE stamp times, not cursor-chained — an overlapped transfer
    # sits visibly parallel to the decode span hiding it
    "transfer": (6, "transfers"),
}

_SPAN_FIELDS = (
    ("observe", "observe_s"),
    ("decide", "decide_s"),
    ("actuate", "actuate_s"),
)


_PREFIX_CATEGORIES = (
    ("shard-", "shard"), ("prefix-", "prefix"), ("overload-", "overload"),
    ("restart-", "restart"), ("knob-", "knob"), ("admission-", "admission"),
    ("kv-", "plane"), ("plane-", "plane"),
)


def track_for(cat: str) -> tuple[int, int]:
    """The stable (pid, tid) lane of an event category."""
    pid, tid, _, _ = _TRACKS.get(cat, _TRACKS["fleet"])
    return pid, tid


def track_metadata_events() -> list[dict[str, Any]]:
    """Perfetto ``"M"`` metadata naming every track in :data:`_TRACKS`
    (process_name / thread_name), plus the request process's phase
    lanes.  Appended by :func:`to_chrome_trace` only when the trace has
    real events — an empty trace stays empty."""
    events: list[dict[str, Any]] = []
    seen_pid: set[int] = set()
    seen_tid: set[tuple[int, int]] = set()

    def _add(pid: int, tid: int, process: str, thread: str) -> None:
        if pid not in seen_pid:
            seen_pid.add(pid)
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process},
            })
        if (pid, tid) not in seen_tid:
            seen_tid.add((pid, tid))
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })

    for pid, tid, process, thread in _TRACKS.values():
        _add(pid, tid, process, thread)
    for tid, thread in _REQUEST_LANES.values():
        _add(_REQUEST_PID, tid, "requests", thread)
    return events


def _us(seconds: float) -> int:
    return int(round(seconds * 1e6))


def trace_events(
    records: Sequence[TickRecord] | Iterable[TickRecord],
    time_origin: float | None = None,
) -> list[dict[str, Any]]:
    """The records as a flat trace-event list (oldest record first).

    ``time_origin`` defaults to the first record's start, so traces begin
    at t=0 regardless of the recording clock's epoch.
    """
    records = list(records)
    if not records:
        return []
    origin = records[0].start if time_origin is None else time_origin
    events: list[dict[str, Any]] = []
    for index, record in enumerate(records):
        start = record.start - origin
        end = start + record.duration
        events.append(
            {
                "name": "tick",
                "cat": "tick",
                "ph": "X",
                "ts": _us(start),
                "dur": _us(record.duration),
                "pid": _PID,
                "tid": _TID,
                "args": {
                    "tick": index,
                    "num_messages": record.num_messages,
                    "decision_messages": record.decision_messages,
                    "up": record.up.value,
                    "down": record.down.value,
                },
            }
        )
        cursor = start
        for name, field in _SPAN_FIELDS:
            span = getattr(record, field)
            if span is None:
                continue
            events.append(
                {
                    "name": name,
                    "cat": "phase",
                    "ph": "X",
                    "ts": _us(cursor),
                    "dur": _us(span),
                    "pid": _PID,
                    "tid": _TID,
                }
            )
            cursor += span
        if record.metric_error is not None:
            events.append(
                _instant("metric-failure", end, {"error": record.metric_error})
            )
        for direction, gate, error in (
            ("up", record.up, record.up_error),
            ("down", record.down, record.down_error),
        ):
            if gate is Gate.COOLING:
                events.append(
                    _instant("cooldown-skip", end, {"direction": direction})
                )
            elif gate is Gate.FIRE:
                args: dict[str, Any] = {
                    "direction": direction,
                    "ok": error is None,
                }
                if error is not None:
                    args["error"] = error
                events.append(_instant(f"scale-{direction}", end, args))
    return events


def _instant(name: str, at: float, args: dict[str, Any],
             cat: str = "event") -> dict[str, Any]:
    pid, tid = track_for(cat)
    return {
        "name": name,
        "cat": cat,
        "ph": "i",
        "s": "t",  # thread-scoped instant
        "ts": _us(at),
        "pid": pid,
        "tid": tid,
        "args": args,
    }


def instant_trace_events(
    events: Iterable[Any], time_origin: float | None = None
) -> list[dict[str, Any]]:
    """Instant events from ``(name, t, args)``-shaped values, such as the
    fleet's :class:`~..fleet.pool.FleetEvent` decisions (replica spawn,
    kill, drain).  ``time_origin`` defaults to the first event's time;
    the category follows the name's prefix, else ``"fleet"``."""
    events = list(events)
    if not events:
        return []
    origin = events[0].t if time_origin is None else time_origin

    def _cat(name: str) -> str:
        for prefix, cat in _PREFIX_CATEGORIES:
            if name.startswith(prefix):
                return cat
        return "fleet"

    return [
        _instant(e.name, e.t - origin, dict(e.args), cat=_cat(e.name))
        for e in events
    ]


def to_chrome_trace(
    records: Sequence[TickRecord] | Iterable[TickRecord],
    meta: dict[str, Any] | None = None,
    extra_events: Sequence[dict[str, Any]] | None = None,
) -> dict[str, Any]:
    """The JSON-object trace format (``{"traceEvents": [...]}``).

    ``extra_events`` are pre-built trace-event dicts appended verbatim
    (e.g. the fleet's :func:`instant_trace_events` with ``time_origin``
    set to the first tick's start, so both streams share t=0)."""
    events = trace_events(records) + list(extra_events or ())
    if events:
        # name the tracks (process/thread lanes) — but an empty trace
        # stays byte-empty, so consumers can cheaply test for "nothing
        # recorded yet"
        events = track_metadata_events() + events
    trace: dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if meta:
        trace["otherData"] = meta
    return trace


def render_chrome_trace(
    records: Sequence[TickRecord] | Iterable[TickRecord],
    meta: dict[str, Any] | None = None,
    extra_events: Sequence[dict[str, Any]] | None = None,
) -> str:
    """``to_chrome_trace`` as a compact JSON string (the HTTP body)."""
    return json.dumps(
        to_chrome_trace(records, meta, extra_events), separators=(",", ":")
    )


def request_trace_events(
    traces: Iterable[Any], time_origin: float | None = None
) -> list[dict[str, Any]]:
    """Per-request lifecycle spans threaded by Perfetto flow arrows.

    ``traces`` is any iterable of :class:`~.lifecycle.RequestTrace`
    values (anything with ``rid`` / ``flow_id`` / ``tenant`` and the
    ``first``/``last`` stamp accessors).  Each request renders as one
    span per lifecycle phase — queue wait, prefill, KV-handoff stall,
    decode, settle — on the ``requests`` process's per-phase lanes,
    linked start-to-finish by flow events (``s``/``t``/``f``) carrying
    the trace's flow id, so Perfetto draws the arrow a postmortem
    follows: THIS request waited here, prefilled there, stalled on the
    shuttle, decoded on the plane.  ``time_origin`` defaults to the
    first trace's arrival so request spans share t=0 with whatever tick
    records they are merged with.
    """
    from .lifecycle import (  # local: avoid import cycle
        phase_durations,
        transfer_spans,
    )

    traces = list(traces)
    starts = [
        t.first("arrival") for t in traces
        if t.first("arrival") is not None
    ]
    if time_origin is None:
        if not starts:
            return []
        time_origin = min(starts)
    events: list[dict[str, Any]] = []
    for trace in traces:
        arrival = trace.first("arrival")
        if arrival is None:
            continue
        durations = phase_durations(trace)
        cursor = arrival - time_origin
        spans: list[tuple[str, float, float]] = []
        for phase in ("queue", "prefill", "handoff", "decode", "settle"):
            span = durations.get(phase)
            if span is None:
                continue
            spans.append((phase, cursor, span))
            cursor += span
        if not spans:
            continue
        args = {
            "rid": trace.rid,
            "tenant": trace.tenant,
            "notes": dict(trace.notes),
        }
        if getattr(trace, "error", None) is not None:
            args["error"] = trace.error
        for index, (phase, start, span) in enumerate(spans):
            tid, _ = _REQUEST_LANES[phase]
            events.append({
                "name": phase,
                "cat": "request",
                "ph": "X",
                "ts": _us(start),
                "dur": _us(span),
                "pid": _REQUEST_PID,
                "tid": tid,
                "args": args,
            })
            # the flow arrow: start at the first span, step through the
            # middle ones, finish (binding to the enclosing slice) at
            # the last — one arrow per request, id = its flow id, which
            # the registry keeps unique across restart epochs
            if index == 0:
                ph = "s"
            elif index == len(spans) - 1:
                ph = "f"
            else:
                ph = "t"
            flow: dict[str, Any] = {
                "name": "request",
                "cat": "request",
                "ph": ph,
                "id": trace.flow_id,
                "ts": _us(start),
                "pid": _REQUEST_PID,
                "tid": tid,
            }
            if ph == "f":
                flow["bp"] = "e"
            events.append(flow)
        # scheduled-collective windows (comms/): absolute-time spans on
        # the transfers lane.  The chained spans above start at the
        # trace's absolute stamp times too, so a transfer dispatched
        # while a block decodes renders exactly under the decode span
        # it hides behind — the overlap the bench gate looks for.
        transfer_tid, _ = _REQUEST_LANES["transfer"]
        routes = getattr(trace, "routes", None) or []
        for index, (t0, t1) in enumerate(transfer_spans(trace)):
            transfer_args = args
            if index < len(routes):
                # the comms route planner appended hop lists in stamp
                # order — the i-th route belongs to the i-th span
                transfer_args = dict(args)
                transfer_args["route"] = routes[index]
            events.append({
                "name": "transfer",
                "cat": "request",
                "ph": "X",
                "ts": _us(t0 - time_origin),
                "dur": _us(max(0.0, t1 - t0)),
                "pid": _REQUEST_PID,
                "tid": transfer_tid,
                "args": transfer_args,
            })
    return events


def to_chrome_trace(
    records: Sequence[TickRecord] | Iterable[TickRecord],
    meta: dict[str, Any] | None = None,
    extra_events: Sequence[dict[str, Any]] | None = None,
) -> dict[str, Any]:
    """The JSON-object trace format (``{"traceEvents": [...]}``).

    ``extra_events`` are pre-built trace-event dicts appended verbatim
    (e.g. the fleet's :func:`instant_trace_events` with ``time_origin``
    set to the first tick's start, so both streams share t=0)."""
    events = trace_events(records) + list(extra_events or ())
    if events:
        # name the tracks (process/thread lanes) — but an empty trace
        # stays byte-empty, so consumers can cheaply test for "nothing
        # recorded yet"
        events = track_metadata_events() + events
    trace: dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if meta:
        trace["otherData"] = meta
    return trace


def render_chrome_trace(
    records: Sequence[TickRecord] | Iterable[TickRecord],
    meta: dict[str, Any] | None = None,
    extra_events: Sequence[dict[str, Any]] | None = None,
) -> str:
    """``to_chrome_trace`` as a compact JSON string (the HTTP body)."""
    return json.dumps(
        to_chrome_trace(records, meta, extra_events), separators=(",", ":")
    )
