"""The port's flight recorder, trace export, controller metrics and HTTP
endpoints, held against the JAX package's.

The same tick records (an episode with stale holds, retries, a breaker
trip and failed actuations) go through both packages' ``TickRing``,
``TickJournal`` (rotation, restart headers, torn lines, event lines),
readers, Chrome-trace export, ``ControllerMetrics`` and
``ObservabilityServer``; files must be byte-equal, dicts equal and the
rendered text equal less its wall-clock values.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest

from .test_torch_controller_loop import (
    PORT,
    REF,
    RESILIENCE,
    SIDES,
    Scenario,
    fresh,
    run_episode,
    scrub,
)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """An episode's records as dicts: stale holds, retries, a breaker that
    opens and closes, metric failures and cooldown skips."""
    tmp = tmp_path_factory.mktemp("episode")
    run = run_episode(REF, tmp, Scenario(resilience=RESILIENCE["full"],
                                         faults="correlated"))
    more = run_episode(REF, fresh(tmp, "breaker"), Scenario(
        resilience=RESILIENCE["full"], faults="scaler-blackout"))
    return run["records"] + more["records"]


def as_records(side, dicts):
    return [side.events.TickRecord.from_dict(d) for d in dicts]


def test_episode_records_cover_every_field(records):
    keys = {k for r in records for k in r}
    assert {"stale", "stale_age_s", "metric_retries", "scaler_retries",
            "breaker_state", "metric_error", "up_error"} <= keys


def test_record_fields_and_dicts_are_the_references(records):
    import dataclasses

    assert [f.name for f in dataclasses.fields(PORT.events.TickRecord)] == [
        f.name for f in dataclasses.fields(REF.events.TickRecord)]
    for d in records:
        assert PORT.events.TickRecord.from_dict(d).to_dict() == \
            REF.events.TickRecord.from_dict(d).to_dict() == d
    assert PORT.events.TickRecord.from_dict(
        {"start": 1.0, "unknown": 3}).to_dict() == {
        "start": 1.0, "duration": 0.0, "up": "skipped", "down": "skipped"}


@pytest.mark.parametrize("capacity,last", [(1, None), (5, None), (5, 3),
                                           (64, 0), (64, -1)])
def test_ring_matches_reference(records, capacity, last):
    out = []
    for side in SIDES:
        ring = side.journal.TickRing(capacity)
        for r in as_records(side, records):
            ring.on_tick(r)
        out.append((len(ring), [r.to_dict() for r in ring.snapshot(last)]))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        PORT.journal.TickRing(0)


def write_journal(side, path, records, *, max_bytes=64 * 1024 * 1024,
                  meta=None, events=()):
    journal = side.journal.TickJournal(str(path), meta=meta or {"m": 1},
                                       max_bytes=max_bytes)
    for i, r in enumerate(as_records(side, records)):
        journal.on_tick(r)
        for at, kind, payload in events:
            if at == i:
                journal.append_event(kind, payload)
    journal.close()


@pytest.mark.parametrize("max_bytes", [4096, 8192, 64 * 1024 * 1024])
def test_journal_files_are_byte_equal(tmp_path, records, max_bytes):
    events = [(3, "knob", {"knob": "x", "value": 1}), (40, "note", {"a": []})]
    files = []
    for side in SIDES:
        path = fresh(tmp_path, side.root) / "j.jsonl"
        write_journal(side, path, records * 3, max_bytes=max_bytes,
                      events=events)
        rotated = path.with_name("j.jsonl.1")
        files.append((path.read_bytes(),
                      rotated.read_bytes() if rotated.exists() else None))
    assert files[0] == files[1]
    if max_bytes == 4096:
        assert files[1][1] is not None  # it rotated
    path = tmp_path / PORT.root / "j.jsonl"
    for kind in ("knob", "note"):
        assert PORT.journal.read_journal_events(
            str(path), kind, rejoin=True) == REF.journal.read_journal_events(
            str(path), kind, rejoin=True)


def test_restart_headers_and_torn_tails_read_the_same(tmp_path, records):
    for side in SIDES:
        path = fresh(tmp_path, side.root) / "j.jsonl"
        write_journal(side, path, records[:5], meta={"boot": 1})
        journal = side.journal.TickJournal(str(path), meta={"boot": 2})
        journal.tear(as_records(side, records[5:6])[0])
        journal.close()
        write_journal(side, path, records[6:9], meta={"boot": 3})
    paths = [tmp_path / side.root / "j.jsonl" for side in SIDES]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got = []
    for side in SIDES:
        for reader in SIDES:
            episodes = reader.journal.read_journal_episodes(
                str(tmp_path / side.root / "j.jsonl"))
            got.append([(m, [r.to_dict() for r in rs]) for m, rs in episodes])
    assert all(g == got[0] for g in got)
    assert [m["boot"] for m, _ in got[0]] == [1, 2, 3]
    meta, flat = PORT.journal.read_journal(str(paths[1]))
    assert meta == {"boot": 1} and len(flat) == 8


BROKEN = {
    "empty": "",
    "headerless": '{"kind":"tick","start":1.0}\n',
    "not-json-header": "nope\n",
    "foreign-schema": '{"kind":"header","schema":2,"meta":{}}\n',
    "foreign-restart": ('{"kind":"header","schema":1,"meta":{}}\n'
                        '{"kind":"header","schema":9,"meta":{}}\n'),
    "corrupt-middle": ('{"kind":"header","schema":1,"meta":{}}\n'
                       'garbage\n{"kind":"tick","start":1.0}\n'),
}


@pytest.mark.parametrize("name", list(BROKEN))
def test_reader_refusals_match_reference(tmp_path, name):
    path = tmp_path / "j.jsonl"
    path.write_text(BROKEN[name])
    errors = []
    for side in SIDES:
        with pytest.raises(side.journal.JournalSchemaError) as info:
            side.journal.read_journal_episodes(str(path))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_journal_reserved_kinds_and_size_floor():
    for side in SIDES:
        with pytest.raises(ValueError):
            side.journal.TickJournal("/dev/null", max_bytes=100)
    assert (PORT.journal.JOURNAL_SCHEMA_VERSION
            == REF.journal.JOURNAL_SCHEMA_VERSION == 1)


# ---------------------------------------------------------------------------
# Chrome trace
# ---------------------------------------------------------------------------


class _Event:
    def __init__(self, name, t, args):
        self.name, self.t, self.args = name, t, args


INSTANTS = [_Event(name, 3.0 + i, {"i": i}) for i, name in enumerate((
    "spawn", "shard-quarantine", "prefix-install", "overload-tier",
    "restart-detected", "restart-rehydrated", "knob-set", "admission-kill",
    "kv-handoff", "plane-up", "drain-done"))]


@pytest.mark.parametrize("origin", [None, 0.0, 2.5])
def test_trace_matches_reference(records, origin):
    out = []
    for side in SIDES:
        recs = as_records(side, records)
        extra = side.trace.instant_trace_events(INSTANTS, time_origin=origin)
        out.append((side.trace.trace_events(recs, time_origin=origin),
                    extra,
                    side.trace.render_chrome_trace(
                        recs, meta={"m": 1}, extra_events=extra)))
    assert out[0] == out[1]
    assert json.loads(out[1][2])["otherData"] == {"m": 1}


def test_trace_lanes_are_the_references():
    for cat in ("tick", "phase", "event", "fleet", "shard", "restart",
                "knob", "overload", "prefix", "plane", "request",
                "admission", "unknown"):
        assert PORT.trace.track_for(cat) == REF.trace.track_for(cat)
    assert PORT.trace.track_metadata_events() == \
        REF.trace.track_metadata_events()
    assert PORT.trace.to_chrome_trace([]) == REF.trace.to_chrome_trace([])
    assert PORT.trace.instant_trace_events([]) == []


# ---------------------------------------------------------------------------
# ControllerMetrics
# ---------------------------------------------------------------------------


class _Report:
    restarts = 2
    duration_s = 0.25
    snapshot_age_s = 13.5
    records_recovered = 4
    records_expired = 1


def registry(side, records, *, policy="reactive", report=False,
             rehydrating=False):
    metrics = side.prom.ControllerMetrics(version=side.version,
                                          policy=policy)
    if rehydrating:
        metrics.begin_rehydration()
    if report:
        metrics.set_rehydration(_Report())
    for r in as_records(side, records):
        metrics.on_tick(r)
    return metrics


@pytest.mark.parametrize("report", [False, True], ids=["fresh", "restarted"])
@pytest.mark.parametrize("ticks", [0, 1, 12, None], ids=lambda n: f"t{n}")
def test_controller_metrics_match_reference(records, ticks, report):
    recs = records if ticks is None else records[:ticks]
    texts = [scrub(registry(side, recs, report=report).render())
             for side in SIDES]
    assert texts[0] == texts[1]
    port = registry(PORT, recs, report=report)
    assert port.ready == registry(REF, recs, report=report).ready
    assert f'version="{PORT.version}"' in port.render()


def test_controller_metrics_rehydration_gate():
    for side in SIDES:
        metrics = side.prom.ControllerMetrics(version="v")
        metrics.begin_rehydration()
        assert metrics.rehydrating
        metrics.on_tick(side.events.TickRecord(start=0.0, num_messages=1))
        assert not metrics.rehydrating
        assert metrics.seconds_since_last_tick() < 5.0
    assert PORT.prom.TICK_DURATION_BUCKETS == REF.prom.TICK_DURATION_BUCKETS
    assert PORT.prom.escape_label_value('a"b\\c\n') == \
        REF.prom.escape_label_value('a"b\\c\n')


# ---------------------------------------------------------------------------
# ObservabilityServer
# ---------------------------------------------------------------------------


def fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


class _Store:
    """A trace source shaped like the durable store's ``events``."""

    events = INSTANTS[4:6]


def serve_both(make, paths, **kwargs):
    out = []
    for side in SIDES:
        metrics, ring = make(side)
        obs = side.server.ObservabilityServer(metrics, host="127.0.0.1", port=0,
                                         ring=ring, **kwargs)
        obs.start()
        try:
            out.append([fetch(f"http://127.0.0.1:{obs.port}{p}")
                        for p in paths])
        finally:
            obs.stop()
    return out


PATHS = ["/healthz", "/readyz", "/debug/ticks", "/debug/ticks?n=3",
         "/debug/ticks?n=x", "/debug/trace", "/debug/requests", "/nope"]


@pytest.mark.parametrize("state", ["fresh", "ticked", "rehydrating",
                                   "no-ring"])
def test_endpoints_match_reference(records, state):
    def make(side):
        metrics = registry(side, records if state == "ticked" else [],
                           rehydrating=state == "rehydrating")
        ring = None
        if state != "no-ring":
            ring = side.journal.TickRing(16)
            for r in as_records(side, records):
                ring.on_tick(r)
        return metrics, ring

    ref, port = serve_both(make, PATHS + ["/metrics"],
                           trace_sources=(_Store(),))
    assert ref[:-1] == port[:-1]
    assert (ref[-1][0], scrub(ref[-1][1])) == (port[-1][0],
                                               scrub(port[-1][1]))
    if state == "rehydrating":
        assert port[0][0] == 503 and port[0][1].startswith("rehydrating")


def test_healthz_turns_503_when_ticks_stop():
    def make(side):
        metrics = side.prom.ControllerMetrics(version="v")
        metrics.on_tick(side.events.TickRecord(start=0.0, num_messages=1))
        return metrics, None

    def stale(side):
        metrics, ring = make(side)
        metrics._last_tick_monotonic = time.monotonic() - 30.0
        return metrics, ring

    for factory, want in ((make, 200), (stale, 503)):
        ref, port = serve_both(factory, ["/healthz"], unhealthy_after=10.0)
        assert ref[0][0] == port[0][0] == want
        assert ref[0][1][:20] == port[0][1][:20]


def test_workload_registry_still_serves():
    def make(side):
        metrics = side.prom.WorkloadMetrics()
        metrics.set_gauge("x", 1.0, "help")
        return metrics, None

    ref, port = serve_both(make, ["/healthz", "/readyz", "/metrics"])
    assert ref == port and port[0][0] == 200
