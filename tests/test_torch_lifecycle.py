"""The port's request-lifecycle tracing held against the JAX package's.

The registry (``obs/lifecycle.py``) is pure host code: every scenario
runs through the port's and the reference's registries on the same
virtual clock, and their snapshots, exported state, SLO attributions,
Perfetto events, journal records and rendered histograms must be equal
(exactly: the same floats from the same stamp sequence).  The stamp sites
run on the CPU at the tiny models of ``test_torch_quantize`` (2 layers,
d_model 64, f32): a traced episode on a ``FakeClock`` gives the same
chains, stamp for stamp and time for time, as the reference's engine on
the same traffic, for the continuous worker with tenancy (both families),
the sharded plane with an evacuation and the disaggregated pool; and an
untraced run's replies and odometers equal the traced run's.

The reference's ``tests/test_lifecycle.py`` is mirrored by name, except
its two bench tests.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu import obs as jax_obs
from kube_sqs_autoscaler_tpu.obs import journal as jax_journal
from kube_sqs_autoscaler_tpu.obs import lifecycle as jax_lifecycle
from kube_sqs_autoscaler_tpu.obs import trace as jax_trace
from kube_sqs_autoscaler_tpu.planes import pool as jax_planes_pool
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch import obs
from kube_sqs_autoscaler_tpu_torch.obs import journal, lifecycle, trace
from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
    RequestTrace, phase_durations, request_key, validate_chain,
)
from kube_sqs_autoscaler_tpu_torch.planes import pool as planes_pool
from kube_sqs_autoscaler_tpu_torch.workloads import tenancy

from .test_torch_tenant_serving import SIDES, config, flood_schedule, send

torch.set_num_threads(1)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class Mods:
    """One side's obs modules."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.lifecycle = lifecycle if port else jax_lifecycle
        self.trace = trace if port else jax_trace
        self.journal = journal if port else jax_journal
        self.obs = obs if port else jax_obs


BOTH = (Mods(True), Mods(False))


def make_registry(mods, clock, **kwargs):
    return mods.lifecycle.LifecycleRegistry(now_fn=clock.now, **kwargs)


def drive(reg, clock, rid, tenant="a", staged=True, handoff=True,
          tokens=3, step=0.01):
    """One full request through every seam on the virtual clock."""
    reg.arrival(rid, tenant=tenant)
    if staged:
        clock.advance(step)
        reg.stamp(rid, "staged")
        clock.advance(step)
        reg.stamp(rid, "picked")
    clock.advance(step)
    reg.stamp(rid, "admitted")
    reg.stamp(rid, "prefill")
    clock.advance(step)
    reg.stamp(rid, "first_token")
    reg.token(rid)
    if handoff:
        clock.advance(step)
        reg.stamp(rid, "handoff")
    for _ in range(max(0, tokens - 1)):
        clock.advance(step)
        reg.token(rid)
    reg.stamp(rid, "completed")
    clock.advance(step)
    reg.settle(rid)


def on_both(scenario):
    """Run ``scenario(mods)`` on both sides; their results must be equal
    (the port's is returned)."""
    port, ref = (scenario(mods) for mods in BOTH)
    assert port == ref
    return port


# -- trace keys and chain validation ------------------------------------


def test_request_key_prefers_message_id():
    for message in ({"MessageId": "m-1", "ReceiptHandle": "rh"},
                    {"ReceiptHandle": "rh"}, {"MessageId": ""}, "m", None,
                    {"MessageId": 7}):
        assert request_key(message) == jax_lifecycle.request_key(message)
    assert request_key({"MessageId": "m-1", "ReceiptHandle": "rh"}) == "m-1"
    assert request_key({"ReceiptHandle": "rh"}) == "rh"
    assert request_key({"MessageId": ""}) is None


def test_full_chain_validates_gap_free():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1")
        (t,) = reg.done_traces()
        problems = mods.lifecycle.validate_chain(
            t, require_staged=True, require_handoff=True)
        return problems, t.count("reply"), t.total_s(), reg.snapshot()

    problems, replies, total, snap = on_both(scenario)
    assert problems == [] and replies == 1
    assert total == pytest.approx(0.08)
    assert snap["replies"] == 1 and snap["open"] == 0


@pytest.mark.parametrize("stamps,expect", [
    ([("arrival", 0.0), ("reply", 1.0), ("reply", 2.0)],
     ("exactly one reply", "missing admitted", "missing first_token")),
    ([("arrival", 1.0), ("admitted", 0.5), ("prefill", 0.6),
      ("first_token", 0.7), ("completed", 0.8), ("reply", 0.9)],
     ("non-monotone",)),
    ([("arrival", 0.0), ("admitted", 0.1), ("prefill", 0.1),
      ("first_token", 0.2), ("completed", 0.5), ("reply", 0.4),
      ("completed", 0.6)], ("reply stamped before",)),
], ids=["missing-and-double-reply", "non-monotone", "reply-before-done"])
def test_validate_chain_flags_missing_phases_and_double_reply(stamps,
                                                              expect):
    problems = []
    for mods in BOTH:
        t = mods.lifecycle.RequestTrace(rid="r", flow_id=1)
        t.stamps = list(stamps)
        problems.append(mods.lifecycle.validate_chain(t))
    assert problems[0] == problems[1]
    for needle in expect:
        assert any(needle in p for p in problems[0]), problems[0]


def test_validate_chain_flags_non_monotone_first_occurrences():
    t = RequestTrace(rid="r", flow_id=1)
    t.stamps = [("arrival", 1.0), ("admitted", 0.5), ("prefill", 0.6),
                ("first_token", 0.7), ("completed", 0.8), ("reply", 0.9)]
    assert any("non-monotone" in p for p in validate_chain(t))


def test_restamps_after_redispatch_keep_the_chain_valid():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1", staged=False, handoff=False)
        (t,) = reg.done_traces()
        t.stamps.append(("admitted", clock.advance(0.01)))
        return mods.lifecycle.validate_chain(t)

    assert on_both(scenario) == []


def test_error_reply_needs_only_arrival_and_reply():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        reg.arrival("r1", tenant="a")
        clock.advance(0.01)
        reg.settle("r1", error="shed: queue TTL exceeded")
        (t,) = reg.done_traces()
        return t.error, mods.lifecycle.validate_chain(t), reg.export_state()

    error, problems, _ = on_both(scenario)
    assert error is not None and problems == []


def test_arrival_is_idempotent_and_backdates_to_sent():
    def scenario(mods):
        clock = Clock(10.0)
        reg = make_registry(mods, clock)
        reg.arrival("r1", sent=4.5)
        reg.arrival("r1")  # a redelivered copy of the still-open request
        (t,) = reg.open_traces()
        return t.count("arrival"), t.first("arrival"), reg.snapshot()

    count, first, _ = on_both(scenario)
    assert (count, first) == (1, 4.5)


def test_duplicate_closes_without_a_reply_stamp():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1")
        reg.arrival("r1")
        reg.duplicate("r1")
        copies = reg.traces_of("r1")
        return ([t.to_dict() for t in copies], reg.duplicates,
                reg.snapshot())

    copies, duplicates, _ = on_both(scenario)
    assert len(copies) == 2 and duplicates == 1
    dup = [t for t in copies if t["notes"].get("duplicate")]
    assert len(dup) == 1
    assert not any(name == "reply" for name, _ in dup[0]["stamps"])
    assert sum(name == "reply" for t in copies
               for name, _ in t["stamps"]) == 1


def test_capacity_eviction_bounds_open_traces():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock, capacity=2)
        for i in range(4):
            reg.arrival(f"r{i}")
        evicted = {t.rid for t in reg.done_traces() if t.notes.get("evicted")}
        return reg.open_count, reg.evicted, evicted, reg.snapshot()

    open_count, evicted_count, evicted, _ = on_both(scenario)
    assert (open_count, evicted_count, evicted) == (2, 2, {"r0", "r1"})
    with pytest.raises(ValueError):
        lifecycle.LifecycleRegistry(capacity=0)


# -- the critical-path decomposition ------------------------------------


def test_phase_durations_decompose_the_chain():
    stamps = [("arrival", 0.0), ("admitted", 0.3), ("prefill", 0.3),
              ("first_token", 0.5), ("handoff", 0.6), ("completed", 1.0),
              ("reply", 1.1)]
    out = []
    for mods in BOTH:
        t = mods.lifecycle.RequestTrace(rid="r", flow_id=1)
        t.stamps = list(stamps)
        out.append(mods.lifecycle.phase_durations(t))
    assert out[0] == out[1]
    durations = phase_durations(RequestTrace("r", 1, stamps=list(stamps)))
    assert durations["queue"] == pytest.approx(0.3)
    assert durations["prefill"] == pytest.approx(0.2)
    assert durations["handoff"] == pytest.approx(0.1)
    assert durations["decode"] == pytest.approx(0.4)
    assert durations["settle"] == pytest.approx(0.1)


def test_inter_token_and_tpot():
    out = []
    for mods in BOTH:
        t = mods.lifecycle.RequestTrace(rid="r", flow_id=1)
        t.token_times = [1.0, 1.0, 1.2, 1.5]
        out.append((t.inter_token_s(), t.tpot_s(),
                    mods.lifecycle.RequestTrace(rid="r", flow_id=1).tpot_s()))
    assert out[0] == out[1]
    assert out[0][0] == pytest.approx([0.0, 0.2, 0.3])
    assert out[0][1] == pytest.approx(0.5 / 3) and out[0][2] is None


def test_attribute_slo_names_the_dominant_phase():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        reg.arrival("r-queue")
        clock.advance(1.0)
        for phase in ("admitted", "prefill", "first_token", "completed"):
            reg.stamp("r-queue", phase)
        reg.settle("r-queue")
        reg.arrival("r-decode")
        for phase in ("admitted", "prefill", "first_token"):
            reg.stamp("r-decode", phase)
        clock.advance(2.0)
        reg.stamp("r-decode", "completed")
        reg.settle("r-decode")
        return reg.attribute_slo(0.0), reg.attribute_slo(10.0)

    report, lenient = on_both(scenario)
    assert report["requests"] == 2 and report["over_slo"] == 2
    assert report["by_phase"] == {"decode": 1, "queue": 1}
    assert [w["dominant"] for w in report["worst"]] == ["decode", "queue"]
    assert lenient["over_slo"] == 0


# -- restart: epochs, flow ids, restored notes --------------------------


def test_import_bumps_epoch_so_flow_ids_never_collide():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "done-1")
        reg.arrival("open-1")
        state = reg.export_state()
        fresh = make_registry(mods, clock)
        recovered = fresh.import_state(state, now=clock.now())
        drive(fresh, clock, "post-restart")
        return state, recovered, fresh.export_state(), fresh.snapshot()

    state, recovered, after, snap = on_both(scenario)
    assert recovered >= 2 and after["epoch"] == state["epoch"] + 1
    (restored,) = after["open"]
    assert restored["rid"] == "open-1" and restored["notes"]["restored"] == 1
    before = {t["flow_id"] for t in state["open"] + state["done"]}
    post = {t["flow_id"] for t in snap["requests"]
            if t["rid"] == "post-restart"}
    assert post and not before & post
    assert all(fid >> 32 == after["epoch"] for fid in post)


def test_import_counters_survive_and_stale_open_traces_age_out():
    def scenario(mods):
        clock = Clock(100.0)
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1")
        reg.arrival("stale")
        clock.advance(50.0)
        reg.arrival("fresh")
        state = reg.export_state()
        fresh = make_registry(mods, clock)
        fresh.import_state(state, now=clock.now(), max_age_s=10.0,
                           rebase=0.5)
        return ({t.rid for t in fresh.open_traces()}, fresh.replies,
                fresh.created, fresh.export_state())

    rids, replies, created, _ = on_both(scenario)
    assert rids == {"fresh"} and replies == 1 and created == 3


# -- histogram export ----------------------------------------------------


def test_export_metrics_renders_cumulative_phase_histograms():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1", tenant="tenant-a")
        metrics = mods.obs.WorkloadMetrics()
        reg.export_metrics(metrics)
        body = metrics.render()
        q99 = metrics.histogram_quantile(
            "request_phase_seconds", 0.99, labels=(("phase", "queue"),))
        reg.export_metrics(metrics)  # drained: adds nothing
        return body, q99, metrics.render()

    body, q99, again = on_both(scenario)
    assert 'request_phase_seconds_bucket{phase="queue",le="' in body
    assert 'request_phase_seconds_bucket{phase="decode",le="' in body
    assert 'tenant_inter_token_seconds_bucket{tenant="tenant-a"' in body
    assert ('tenant_time_per_output_token_seconds_bucket{tenant="tenant-a"'
            in body)
    assert q99 is not None and q99 > 0
    assert again == body


def test_tenant_histogram_series_are_bounded():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        reg.MAX_TENANT_SERIES = 2
        for i in range(4):
            drive(reg, clock, f"r{i}", tenant=f"tenant-{i}")
        metrics = mods.obs.WorkloadMetrics()
        reg.export_metrics(metrics)
        return metrics.render()

    body = on_both(scenario)
    assert 'tenant="tenant-0"' in body and 'tenant="tenant-1"' in body
    assert 'tenant="tenant-2"' not in body
    assert f'tenant="{lifecycle.LifecycleRegistry.OTHER_TENANTS}"' in body


# -- journal sidecar records: rotation and torn tails -------------------


def journal_records(mods, path, drives, max_bytes=None, rejoin=False):
    clock = Clock()
    kw = {} if max_bytes is None else {"max_bytes": max_bytes}
    j = mods.journal.TickJournal(path, meta={"run": "t"}, **kw)
    reg = make_registry(mods, clock, journal=j)
    for rid in drives:
        drive(reg, clock, rid, tenant="a")
    j.close()
    return mods.journal.read_journal_events(path, "request", rejoin=rejoin)


def test_settle_journals_request_records(tmp_path):
    out = [journal_records(m, str(tmp_path / f"{m.port}.jsonl"), ["r1"])
           for m in BOTH]
    assert out[0] == out[1]
    (event,) = out[0]
    assert event["rid"] == "r1"
    restored = RequestTrace.from_dict(event)
    assert validate_chain(restored, require_staged=True,
                          require_handoff=True) == []


def test_request_records_survive_rotation_with_rejoin(tmp_path):
    rids = [f"r{i}" for i in range(30)]
    out = []
    for mods in BOTH:
        path = str(tmp_path / f"{mods.port}.jsonl")
        journal_records(mods, path, rids, max_bytes=4096)
        assert os.path.exists(path + ".1"), "episode never rotated"
        live = [e["rid"] for e in
                mods.journal.read_journal_events(path, "request")]
        rejoined = [e["rid"] for e in mods.journal.read_journal_events(
            path, "request", rejoin=True)]
        out.append((live, rejoined))
    assert out[0] == out[1]
    live, rejoined = out[0]
    assert len(live) < 30 and len(rejoined) > len(live)
    assert rejoined[-len(live):] == live
    first = int(rejoined[0][1:])
    assert rejoined == [f"r{i}" for i in range(first, 30)]


def test_torn_tail_does_not_lose_earlier_request_records(tmp_path):
    for mods in BOTH:
        path = str(tmp_path / f"{mods.port}.jsonl")
        journal_records(mods, path, ["r1", "r2"])
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"kind":"request","rid":"torn","sta')
        events = mods.journal.read_journal_events(path, "request",
                                                  rejoin=True)
        assert [e["rid"] for e in events] == ["r1", "r2"]


def test_flow_ids_do_not_collide_across_journal_restart_episodes(tmp_path):
    out = []
    for mods in BOTH:
        clock = Clock()
        path = str(tmp_path / f"{mods.port}.jsonl")
        j = mods.journal.TickJournal(path, meta={"run": "t"})
        reg = make_registry(mods, clock, journal=j)
        for i in range(3):
            drive(reg, clock, f"pre-{i}")
        state = reg.export_state()
        j.close()
        j2 = mods.journal.TickJournal(path, meta={"run": "t"})
        reg2 = make_registry(mods, clock, journal=j2)
        reg2.import_state(state, now=clock.now())
        for i in range(3):
            drive(reg2, clock, f"post-{i}")
        j2.close()
        out.append([e["flow_id"] for e in mods.journal.read_journal_events(
            path, "request", rejoin=True)])
    assert out[0] == out[1]
    assert len(set(out[0])) == 6
    assert {fid >> 32 for fid in out[0]} == {0, 1}


# -- Perfetto export: pinned tracks, flow arrows ------------------------


def test_track_assignments_are_pinned():
    for cat in ("tick", "fleet", "shard", "restart", "knob", "overload",
                "prefix", "plane", "request", "admission", "never-heard"):
        assert trace.track_for(cat) == jax_trace.track_for(cat)
    assert trace.track_for("request") == (4, 1)
    assert trace.track_for("knob") == (2, 4)


def test_track_metadata_names_the_request_phase_lanes():
    events = trace.track_metadata_events()
    assert events == jax_trace.track_metadata_events()
    lanes = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in events if e["name"] == "thread_name"}
    assert [lanes[(4, tid)] for tid in range(1, 6)] == [
        "queue", "prefill", "kv-handoff", "decode", "settle"]


def test_request_trace_events_render_flow_linked_phase_spans():
    def scenario(mods):
        clock = Clock(50.0)
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1", tenant="a")
        drive(reg, clock, "r2", tenant="b")
        return mods.trace.request_trace_events(reg.done_traces())

    events = on_both(scenario)
    spans = [e for e in events if e["ph"] == "X"]
    flows = [e for e in events if e["ph"] in ("s", "t", "f")]
    assert {e["tid"] for e in spans} == {1, 2, 3, 4, 5}
    assert min(e["ts"] for e in events) == 0
    assert len({e["id"] for e in flows}) == 2


def test_request_trace_events_skip_unarrived_and_render_errors():
    def scenario(mods):
        never = mods.lifecycle.RequestTrace(rid="r", flow_id=1)
        never.stamps = [("admitted", 1.0)]
        clock = Clock()
        reg = make_registry(mods, clock)
        reg.arrival("shed-1")
        clock.advance(0.25)
        reg.stamp("shed-1", "admitted")
        reg.settle("shed-1", error="shed")
        return (mods.trace.request_trace_events([]),
                mods.trace.request_trace_events([never]),
                mods.trace.request_trace_events(reg.done_traces()))

    empty, unarrived, events = on_both(scenario)
    assert empty == [] and unarrived == []
    spans = [e for e in events if e["ph"] == "X"]
    assert spans and all(e["args"]["error"] == "shed" for e in spans)


def test_chrome_trace_merges_request_spans_without_tick_records():
    def scenario(mods):
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1")
        return (mods.trace.to_chrome_trace(
            [], extra_events=mods.trace.request_trace_events(
                reg.done_traces())),
                mods.trace.to_chrome_trace([], extra_events=[]))

    merged, empty = on_both(scenario)
    assert "request" in {e.get("cat") for e in merged["traceEvents"]}
    assert empty["traceEvents"] == []


# -- the /debug/requests endpoint ---------------------------------------


def test_debug_requests_endpoint_serves_snapshot_and_attribution():
    bodies = []
    for mods in BOTH:
        clock = Clock()
        reg = make_registry(mods, clock)
        drive(reg, clock, "r1", tenant="a")
        reg.arrival("still-open")
        server = mods.obs.ObservabilityServer(
            mods.obs.ControllerMetrics(), host="127.0.0.1", port=0,
            lifecycle=reg)
        server.start()
        try:
            bodies.append(json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/debug/requests?n=10&slo=0.0"
            ).read().decode()))
        finally:
            server.stop()
    assert bodies[0] == bodies[1]
    body = bodies[0]
    assert body["replies"] == 1 and body["open"] == 1
    assert [t["rid"] for t in body["requests"]] == ["r1"]
    assert [t["rid"] for t in body["open_requests"]] == ["still-open"]
    assert body["attribution"]["over_slo"] == 1


def test_debug_requests_404_without_a_registry():
    server = obs.ObservabilityServer(obs.ControllerMetrics(),
                                     host="127.0.0.1", port=0)
    server.start()
    try:
        for path in ("/debug/requests", "/debug/topology"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}{path}")
            assert err.value.code == 404
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The stamp sites: the same chains as the reference's engines
# ---------------------------------------------------------------------------


def chains(reg) -> list:
    """Every trace's stamps, notes and token times, by rid (flow ids
    included: both registries mint them in the same order)."""
    traces = reg.done_traces() + reg.open_traces()
    return sorted((t.rid, t.flow_id, t.stamps, t.token_times,
                   sorted(t.notes.items()), t.error) for t in traces)


def traced_worker_episode(side, family, traced, cycles=40, tenancy_kw=None):
    """The tenancy flood episode on a ``FakeClock``, traced or not:
    (registry or None, per-cycle odometers, replies)."""
    clock = side.Clock(1000.0)
    queue = side.Queue(now_fn=clock.now)
    results = side.Queue(now_fn=clock.now)
    cfg, params = side.model(family)
    worker = side.continuous.ContinuousWorker(
        queue, params, cfg, config(side), result_queue=results,
        now_fn=clock.now, family=family,
        tenancy=side.tenancy.TenancyConfig(
            **(tenancy_kw or dict(tenants=("v0", "v1", "flood")))),
        **side.device)
    reg = None
    if traced:
        mods = BOTH[0] if side.port else BOTH[1]
        reg = mods.lifecycle.LifecycleRegistry()
        worker.attach_lifecycle(reg)
    schedule = flood_schedule(family, 20, seed=41, pooled=False)
    odo = []
    for cycle in range(cycles):
        for tenant, ids, prefix in schedule.get(cycle, ()):
            send(queue, tenant, ids, prefix)
        worker.run_once()
        b = worker.batcher
        odo.append((b.insert_dispatches, b.decode_dispatches,
                    b.host_transfers, worker.staged))
        clock.advance(0.25)
    replies, _ = side.service.collect_replies(results, "t://r")
    return reg, odo, replies


@pytest.mark.parametrize("family,tenancy_kw", [
    ("gpt", None), ("llama", None),
    ("gpt", dict(tenants=("v0", "v1", "flood"), admission_shards=2)),
], ids=["gpt", "llama", "gpt-admission-shards"])
def test_worker_chains_equal_the_reference(family, tenancy_kw):
    port = traced_worker_episode(SIDES[0], family, True,
                                 tenancy_kw=tenancy_kw)
    ref = traced_worker_episode(SIDES[1], family, True,
                                tenancy_kw=tenancy_kw)
    assert chains(port[0]) == chains(ref[0])
    assert port[1] == ref[1]
    assert port[0].snapshot(last=1000) == ref[0].snapshot(last=1000)
    staged = [t for t in port[0].done_traces() if t.first("staged")]
    assert staged and len(port[0].done_traces()) == len(port[2])
    for t in port[0].done_traces():
        assert validate_chain(t, require_staged=True) == [], t.rid
    # tracing off: the same odometers and replies
    untraced = traced_worker_episode(SIDES[0], family, False,
                                     tenancy_kw=tenancy_kw)
    assert untraced[1] == port[1] and untraced[2] == port[2]


def disagg_episode(side_port: bool, tiny, traced: bool, comms=None):
    params, cfg = tiny[2:] if side_port else tiny[:2]
    side = SIDES[0] if side_port else SIDES[1]
    pool_mod = planes_pool if side_port else jax_planes_pool
    ten = tenancy if side_port else jax_tenancy
    clock = side.Clock()
    queue = side.Queue(visibility_timeout=30.0, now_fn=clock.now)
    results = side.Queue(now_fn=clock.now)
    service = side.service.ServiceConfig(
        queue_url="d://q", batch_size=2, seq_len=8, generate_tokens=6,
        decode_block=2, shards=2, result_queue_url="d://r")
    pool = pool_mod.DisaggregatedPool.serving(
        queue, params, cfg, service, result_queue=results, min=2, max=2,
        decode_shards=2, spec_layers=1, spec_tokens=2,
        tenancy=ten.TenancyConfig(tenants=("t",)), clock=clock,
        now_fn=clock.now, **side.device)
    reg = None
    if traced:
        mods = BOTH[0] if side_port else BOTH[1]
        reg = mods.lifecycle.LifecycleRegistry()
        pool.attach_lifecycle(reg)
    if comms is not None:
        pool.attach_comms(comms)
    rng = np.random.default_rng(5)
    sent, odo = [], []
    for cycle in range(80):
        if len(sent) < 8:
            ids = rng.integers(0, 96, int(rng.integers(2, 9))).tolist()
            sent.append(queue.send_message(
                "d://q", json.dumps({"tenant": "t", "ids": ids})))
        pool.run_cycle()
        b = pool.decode.batcher
        odo.append((b.insert_dispatches, b.decode_dispatches,
                    b.host_transfers, pool.kv_handoffs_total))
        clock.advance(0.2)
        if len(sent) == 8 and pool.processed >= 8 and pool.idle:
            break
    replies, _ = side.service.collect_replies(results, "d://r")
    return reg, odo, replies, pool


@pytest.fixture(scope="module")
def tiny():
    from .test_torch_quantize import weights

    jcfg, jp, tcfg, tp = weights("gpt")
    return jp, jcfg, tp, tcfg


def test_disaggregated_chains_carry_the_handoff(tiny):
    port, ref = (disagg_episode(p, tiny, True) for p in (True, False))
    assert chains(port[0]) == chains(ref[0])
    assert port[1] == ref[1]
    reg, _, replies, pool = port
    assert len(replies) == 8 and pool.kv_handoffs_total > 0
    handed = [t for t in reg.done_traces() if t.notes.get("handed_off")]
    assert handed
    for t in reg.done_traces():
        assert validate_chain(
            t, require_handoff=bool(t.notes.get("handed_off"))) == [], t.rid
        if t.notes.get("handed_off"):
            assert t.notes.get("transfer_handoff_kv") == 1
    untraced = disagg_episode(True, tiny, False)
    assert untraced[1] == port[1] and untraced[2] == port[2]
