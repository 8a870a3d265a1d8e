"""Chrome-trace instant events of the fleet's supervisor decisions.

The port's copy of ``instant_trace_events`` from
``kube_sqs_autoscaler_tpu/obs/trace.py``, with the lane table it reads:
one instant dict per ``(name, t, args)`` event, its category picked by
name prefix and its (pid, tid) lane by category, so the dicts equal the
reference's for the same events.
"""

from __future__ import annotations

from typing import Any, Iterable

_PID = 1
_TID = 1

#: Category -> (pid, tid): one stable Perfetto lane per event category.
_TRACKS: dict[str, tuple[int, int]] = {
    "tick": (_PID, _TID),
    "phase": (_PID, _TID),
    "event": (_PID, _TID),
    "fleet": (2, 1),
    "shard": (2, 2),
    "restart": (2, 3),
    "knob": (2, 4),
    "overload": (3, 1),
    "prefix": (3, 2),
    "plane": (3, 3),
    "request": (4, 1),
}

_PREFIX_CATEGORIES = (
    ("shard-", "shard"), ("prefix-", "prefix"), ("overload-", "overload"),
    ("restart-", "restart"), ("knob-", "knob"), ("admission-", "admission"),
    ("kv-", "plane"), ("plane-", "plane"),
)


def _instant(name: str, at: float, args: dict[str, Any],
             cat: str = "event") -> dict[str, Any]:
    pid, tid = _TRACKS.get(cat, _TRACKS["fleet"])
    return {
        "name": name,
        "cat": cat,
        "ph": "i",
        "s": "t",  # thread-scoped instant
        "ts": int(round(at * 1e6)),
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
