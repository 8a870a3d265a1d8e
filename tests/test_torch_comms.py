"""The port's scheduled collectives (``comms/``) held against the JAX
package's.

Host code is compared exactly: the op taxonomy, the scheduler's counters
over the same op sequences, the route planner's plans and the schedule
simulator's results over seeded op batteries on all four topology kinds,
and ``/debug/topology``.  The engine seam runs on the CPU at the tiny GPT
of ``test_torch_quantize`` (2 layers, d_model 64, f32): with comms off, or
attached but disabled, the port's engines are byte for byte as before;
with comms on, greedy replies are unchanged (comms moves no arithmetic),
the blocking host transfers strictly fall, and the counters
(``host_transfers``, the scheduler's, ``by_kind`` and ``by_bucket``
included) equal the reference engine's on the same traffic, for the
block engine, the sharded evacuation and the KV handoff.  Byte totals
differ where the port keeps token ids as int64 and the reference as
int32, so ``transfer_bytes`` is compared only for the KV moves.

The reference's ``tests/test_comms.py`` is mirrored by name, except its
two bench tests.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu import comms as jax_comms
from kube_sqs_autoscaler_tpu.obs import lifecycle as jax_lifecycle
from kube_sqs_autoscaler_tpu.planes import engine as jax_engine
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch import comms
from kube_sqs_autoscaler_tpu_torch.comms import (
    EVACUATION_KV, HANDOFF_KV, PREFIX_INSTALL, SETTLE_PULL,
    SIZE_BUCKET_LABELS, SMALL_OP_BYTES, TOPOLOGY_KINDS, CollectiveScheduler,
    RoutePlanner, TransferOp, array_nbytes, assert_no_oversubscription,
    settle_pull_op, simulate_schedule, size_bucket, topology_from_geometry,
)
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.obs import (
    ControllerMetrics, ObservabilityServer, WorkloadMetrics,
)
from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
    LifecycleRegistry, phase_durations, transfer_spans,
)
from kube_sqs_autoscaler_tpu_torch.planes.engine import DecodePlaneBatcher
from kube_sqs_autoscaler_tpu_torch.sched import EventScheduler
from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
    ContinuousBatcher, _HostCopy,
)
from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
    ShardedBatcher,
)
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
    PrefixPool, prefix_pool_key,
)

from .test_torch_quantize import tokens, weights

torch.set_num_threads(1)

PROMPT, TOKENS, BLOCK = 8, 5, 2
SIDES = ("port", "ref")


@pytest.fixture(scope="module")
def tiny():
    """(reference params, reference config, port params, port config)."""
    jcfg, jp, tcfg, tp = weights("gpt")
    return jp, jcfg, tp, tcfg


def prompts_for(n, seed=7):
    rng = np.random.default_rng(seed)
    return [tokens("gpt", 1, int(rng.integers(2, PROMPT + 1)), seed + i)[0]
            for i in range(n)]


def side_of(tiny, side):
    """(params, config, extra constructor keywords, comms module,
    lifecycle module) of one side."""
    jp, jcfg, tp, tcfg = tiny
    if side == "port":
        return tp, tcfg, {"device": "cpu"}, comms, None
    return jp, jcfg, {}, jax_comms, jax_lifecycle


def registry_of(side, **kw):
    if side == "port":
        return LifecycleRegistry(**kw)
    return jax_lifecycle.LifecycleRegistry(**kw)


def counters(c) -> dict:
    """The counters less what follows the token ids' byte width (the
    port's int64 against the reference's int32): the byte total and the
    routed links' modeled bytes and virtual time."""
    out = c.counters()
    out.pop("transfer_bytes")
    routing = out.get("routing")
    if routing is not None:
        routing.pop("link_bytes")
        routing.pop("virtual_now_s")
    return out


# ---------------------------------------------------------------------------
# The op taxonomy
# ---------------------------------------------------------------------------


def test_size_buckets_are_total_and_ordered():
    for n in (1, 1 << 12, (1 << 12) + 1, 1 << 16, (1 << 16) + 1, 1 << 20,
              (1 << 20) + 1, 1 << 30):
        assert size_bucket(n) == jax_comms.size_bucket(n)
    assert size_bucket(1) == "le4k"
    assert size_bucket((1 << 20) + 1) == "gt1m"
    assert SIZE_BUCKET_LABELS == jax_comms.SIZE_BUCKET_LABELS
    assert comms.TRANSFER_KINDS == jax_comms.TRANSFER_KINDS
    assert SMALL_OP_BYTES == jax_comms.SMALL_OP_BYTES


def test_transfer_op_smallness_and_coalesce_key():
    small = TransferOp(SETTLE_PULL, "host", nbytes=64)
    big = TransferOp(EVACUATION_KV, "shard:1", nbytes=SMALL_OP_BYTES + 1)
    assert small.small and not big.small
    assert small.coalesce_key() == ("host", SETTLE_PULL)
    assert big.coalesce_key() == ("shard:1", EVACUATION_KV)
    assert (small.bucket, big.bucket) == (
        jax_comms.TransferOp(SETTLE_PULL, "host", nbytes=64).bucket,
        jax_comms.TransferOp(EVACUATION_KV, "h", SMALL_OP_BYTES + 1).bucket)


def test_array_nbytes_walks_nested_structures():
    a = torch.zeros((2, 3), dtype=torch.float32)
    assert array_nbytes(a) == 24
    assert array_nbytes([{"k": a, "v": a}, {"k": a, "v": a}]) == 96
    j = jnp.zeros((2, 3), jnp.float32)
    assert array_nbytes([{"k": a, "v": a}]) == jax_comms.array_nbytes(
        [{"k": j, "v": j}])
    # metadata only: a bf16 tensor counts its element size, numpy works too
    assert array_nbytes(torch.zeros(4, dtype=torch.bfloat16)) == 8
    assert array_nbytes((np.zeros(3, np.int32), None, "x")) == 12


def test_settle_pull_op_dispatch_starts_async_copies():
    arrays = (torch.arange(4, dtype=torch.int32), torch.ones(2))
    copy = _HostCopy(*arrays)
    op = settle_pull_op(copy.host, wait=copy.wait, rids=("r1", ""))
    assert op.kind == SETTLE_PULL and op.rids == ("r1",)
    assert op.nbytes == 16 + 8
    assert not op.dispatched
    # the copy is already under way: the dispatch starts nothing new
    assert op.dispatch() is None
    c = CollectiveScheduler()
    c.submit(op)
    c.flush(overlapped=True)
    c.finish(op)
    assert op.finished and copy.wait()[0].tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# The scheduler: coalescing, counters, lifecycle stamps
# ---------------------------------------------------------------------------


def op_battery(module):
    ops = [module.TransferOp(SETTLE_PULL, "host", nbytes=128)
           for _ in range(3)]
    ops += [module.TransferOp(SETTLE_PULL, "host", nbytes=SMALL_OP_BYTES + 1),
            module.TransferOp(SETTLE_PULL, "shard:1", nbytes=128)]
    # a coalesced group seals at the small-op threshold
    ops += [module.TransferOp(HANDOFF_KV, "decode-plane",
                              nbytes=SMALL_OP_BYTES // 3 + 7)
            for _ in range(5)]
    return ops


def test_flush_coalesces_small_same_destination_ops():
    results = []
    for module in (comms, jax_comms):
        c = module.CollectiveScheduler()
        for op in op_battery(module):
            c.submit(op)
        results.append((c.flush(overlapped=True), c.counters()))
    assert results[0] == results[1]
    n, cc = results[0]
    assert n == 3 + 3
    assert cc["dispatched_ops"] == 10
    assert cc["overlapped_transfers_total"] == 10
    assert cc["pending"] == 0


def test_record_counts_one_dispatch_and_stamps_the_trace():
    reg = LifecycleRegistry(now_fn=time.perf_counter)
    c = CollectiveScheduler(lifecycle=reg)
    t0 = reg.now_fn()
    op = c.record(EVACUATION_KV, "shard:0", nbytes=2048,
                  rids=("req-1",), t0=t0)
    assert op.dispatched and op.finished
    cc = c.counters()
    assert cc["transfer_dispatches"] == 1
    assert cc["by_kind"][EVACUATION_KV] == 1
    (trace,) = reg.open_traces()
    (span,) = transfer_spans(trace)
    assert span[0] == t0 and span[1] >= t0
    ref = jax_comms.CollectiveScheduler()
    ref.record(EVACUATION_KV, "shard:0", nbytes=2048, rids=("req-1",))
    assert ref.counters() == cc


def test_finish_is_idempotent_and_none_safe():
    waits = []
    c = CollectiveScheduler()
    c.finish(None)  # no-op
    op = TransferOp(SETTLE_PULL, "host", nbytes=8,
                    wait=lambda: waits.append(1))
    c.submit(op)
    c.flush()
    c.finish(op)
    c.finish(op)
    assert c.counters()["finished_ops"] == 1
    assert waits == [1]  # the finish waits once, for the copy


def test_disabled_scheduler_declines_settle_pulls():
    c = CollectiveScheduler(enabled=False)
    assert c.settle_pull((torch.zeros(2, dtype=torch.int32),)) is None
    assert c.record(EVACUATION_KV, "host", 64) is None
    assert c.flush() == 0
    assert c.counters()["transfer_dispatches"] == 0
    assert c.counters() == jax_comms.CollectiveScheduler(
        enabled=False).counters()


def test_register_flushes_from_the_event_scheduler():
    c = CollectiveScheduler()
    c.submit(TransferOp(SETTLE_PULL, "host", nbytes=8))
    sched = EventScheduler(FakeClock())
    event = c.register(sched, period=1.0)
    assert event.name == "comms-flush"
    sched.run(max_events=1)
    assert c.counters()["flushes"] >= 1
    assert c.counters()["pending"] == 0
    assert c.counters()["overlapped_transfers_total"] == 0


# ---------------------------------------------------------------------------
# The obs seam: transfer durations, SLO attribution, the trace lane
# ---------------------------------------------------------------------------


def test_phase_durations_gains_a_transfer_axis():
    out = []
    for side in SIDES:
        reg = registry_of(side, now_fn=lambda: 0.0)
        for phase, t in (("arrival", 0.0), ("prefill", 1.0),
                         ("transfer", 1.5), ("transfer_done", 1.9),
                         ("first_token", 2.0)):
            reg.stamp("r", phase, t=t)
        (trace,) = reg.open_traces()
        mod = jax_lifecycle if side == "ref" else None
        durations = (mod.phase_durations(trace) if mod
                     else phase_durations(trace))
        out.append(durations)
    assert out[0] == out[1]
    assert out[0]["transfer"] == pytest.approx(0.4)


def test_attribute_slo_names_transfer_bound_requests():
    reports = []
    for side in SIDES:
        clock = [0.0]
        reg = registry_of(side, now_fn=lambda: clock[0])
        for phase, t in (("arrival", 0.0), ("prefill", 0.1),
                         ("first_token", 0.2), ("completed", 1.0),
                         ("transfer", 0.2), ("transfer_done", 5.0)):
            reg.stamp("r", phase, t=t)
        clock[0] = 5.2
        reg.settle("r")
        reports.append(reg.attribute_slo(1.0))
    assert reports[0] == reports[1]
    assert reports[0]["dominant"] == "transfer"
    assert reports[0]["by_phase"] == {"transfer": 1}


def test_request_trace_exports_transfer_spans_on_their_own_lane():
    from kube_sqs_autoscaler_tpu.obs.trace import (
        request_trace_events as jax_events,
    )
    from kube_sqs_autoscaler_tpu_torch.obs.trace import (
        _REQUEST_LANES, request_trace_events,
    )

    assert "transfer" in _REQUEST_LANES
    rendered = []
    for side, render in zip(SIDES, (request_trace_events, jax_events)):
        clock = [0.0]
        reg = registry_of(side, now_fn=lambda: clock[0])
        for phase, t in (("arrival", 0.0), ("prefill", 1.0),
                         ("first_token", 1.1), ("transfer", 1.2),
                         ("transfer_done", 1.8), ("completed", 3.0)):
            reg.stamp("r", phase, t=t)
        reg.route("r", [["shard:0", "host"]])
        clock[0] = 3.0
        reg.settle("r")
        rendered.append(render(reg.done_traces(), time_origin=0.0))
    events = rendered[0]
    assert events == rendered[1]
    tid, _ = _REQUEST_LANES["transfer"]
    (xfer,) = [e for e in events if e.get("ph") == "X" and e["tid"] == tid]
    assert xfer["args"]["route"] == [["shard:0", "host"]]
    decode_tid, _ = _REQUEST_LANES["decode"]
    (decode,) = [e for e in events
                 if e.get("ph") == "X" and e["tid"] == decode_tid]
    assert decode["ts"] <= xfer["ts"]
    assert xfer["ts"] + xfer["dur"] <= decode["ts"] + decode["dur"]


# ---------------------------------------------------------------------------
# Routes and schedules against the reference, on every topology kind
# ---------------------------------------------------------------------------


def route_battery(kind, shards, seed):
    """A seeded battery of moves over the geometry's endpoints, as the
    simulator's op dicts: settle pulls, KV moves, handoffs, installs."""
    rng = np.random.default_rng(seed)
    nodes = [f"shard:{i}" for i in range(shards)] + ["host"]
    out = []
    for _ in range(24):
        src, dst = rng.choice(len(nodes), 2, replace=False)
        size = int(rng.choice([64, 4096, SMALL_OP_BYTES,
                               SMALL_OP_BYTES * 4 + 3, 1 << 20, 5 << 20]))
        kind_of = ("settle_pull", "evacuation_kv", "handoff_kv",
                   "prefix_install")[int(rng.integers(4))]
        out.append({"kind": kind_of, "source": nodes[src],
                    "destination": nodes[dst], "nbytes": size})
    return out


def plan_view(plan):
    return (plan.local, plan.paths, [c.nbytes for c in plan.chunks],
            plan.first_link())


@pytest.mark.parametrize("kind", TOPOLOGY_KINDS)
@pytest.mark.parametrize("shards", [4, 8])
def test_routes_and_schedules_equal_the_reference(kind, shards):
    port_topo = topology_from_geometry(kind, shards=shards)
    ref_topo = jax_comms.topology_from_geometry(kind, shards=shards)
    assert port_topo.snapshot() == ref_topo.snapshot()
    battery = route_battery(kind, shards, seed=shards * 10 + len(kind))
    planner = RoutePlanner(port_topo)
    ref_planner = jax_comms.RoutePlanner(ref_topo)
    for op in battery:
        src, dst, size = op["source"], op["destination"], op["nbytes"]
        assert plan_view(planner.plan(src, dst, size)) == plan_view(
            ref_planner.plan(src, dst, size))
        assert planner.first_hop(src, dst, size) == ref_planner.first_hop(
            src, dst, size)
    for routed in (True, False):
        got = simulate_schedule(battery, port_topo, routed=routed)
        want = jax_comms.simulate_schedule(battery, ref_topo, routed=routed)
        assert got.to_dict() == want.to_dict()
        assert got.ops == want.ops
        assert_no_oversubscription(got.ledger)


@pytest.mark.parametrize("kind", TOPOLOGY_KINDS)
def test_routed_scheduler_counters_equal_the_reference(kind):
    got = []
    for module in (comms, jax_comms):
        topo = module.topology_from_geometry(kind, shards=4)
        c = module.CollectiveScheduler(topology=topo)
        for op in route_battery(kind, 4, seed=5):
            kind_of, src, dst, size = (op["kind"], op["source"],
                                       op["destination"], op["nbytes"])
            if kind_of == "settle_pull":
                c.submit(module.TransferOp(kind_of, dst, size, source=src))
            else:
                c.record(kind_of, dst, size, source=src)
        c.flush(overlapped=True)
        assert_no_oversubscription(c.ledger)
        got.append((c.counters(), c.topology_snapshot()))
    assert got[0] == got[1]


def test_debug_topology_endpoint_serves_snapshot_and_404s_without():
    c = CollectiveScheduler(topology=topology_from_geometry("torus",
                                                            shards=4))
    c.record(EVACUATION_KV, "host", 1 << 20, source="shard:3")
    served = ObservabilityServer(WorkloadMetrics(), host="127.0.0.1",
                                 port=0, comms=c)
    bare = ObservabilityServer(ControllerMetrics(), host="127.0.0.1",
                               port=0, comms=CollectiveScheduler())
    served.start()
    bare.start()
    try:
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{served.port}/debug/topology").read())
        assert body == json.loads(json.dumps(c.topology_snapshot()))
        assert body["routing"]["routed_ops"] == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{bare.port}/debug/topology")
        assert err.value.code == 404
    finally:
        served.stop()
        bare.stop()
    metrics = WorkloadMetrics()
    c.export_gauges(metrics)
    assert 'link_bytes_total{link="shard:3->' in metrics.render()


# ---------------------------------------------------------------------------
# The engine seam: byte identity off, strictly fewer blocking syncs on
# ---------------------------------------------------------------------------


def block_episode(tiny, side, comms_on=None):
    """The reference's block-engine episode: 4 prompts through 2 slots at
    decode_block 2.  ``comms_on``: None (no scheduler), "off" (attached,
    disabled), "when" (WHEN-only) or a topology kind (routed)."""
    params, config, kw, module, _ = side_of(tiny, side)
    cls = (ContinuousBatcher if side == "port"
           else jax_continuous.ContinuousBatcher)
    b = cls(params, config, batch_size=2, prompt_len=PROMPT,
            generate_tokens=TOKENS, decode_block=BLOCK, **kw)
    c = make_comms(module, comms_on, shards=1)
    if c is not None:
        b.attach_comms(c)
    queue = list(enumerate(prompts_for(4)))
    results = {}
    for _ in range(300):
        while queue and b.free_slots:
            idx, ids = queue.pop(0)
            b.submit(ids, payload=idx)
        for idx, toks in b.step():
            results[idx] = tuple(int(t) for t in toks)
        if not queue and b.active == 0:
            break
    return results, odometers(b), c


def make_comms(module, mode, shards, lifecycle=None):
    if mode is None:
        return None
    if mode == "off":
        return module.CollectiveScheduler(enabled=False, lifecycle=lifecycle)
    topology = (None if mode == "when"
                else module.topology_from_geometry(mode, shards=shards))
    return module.CollectiveScheduler(lifecycle=lifecycle, topology=topology)


def odometers(b) -> tuple:
    return (b.host_transfers, b.decode_dispatches, b.insert_dispatches)


def test_block_engine_comms_identical_replies_fewer_blocking_syncs(tiny):
    r_off, odo_off, _ = block_episode(tiny, "port")
    r_on, odo_on, c = block_episode(tiny, "port", "when")
    assert r_on == r_off  # exact greedy parity: comms moves no arithmetic
    assert odo_on[1:] == odo_off[1:]  # the same dispatch schedule
    assert odo_on[0] < odo_off[0]  # the overlap: fewer blocking reads
    cc = c.counters()
    assert cc["overlapped_transfers_total"] >= 1
    assert cc["by_kind"][SETTLE_PULL] >= 1
    assert cc["pending"] == 0 and cc["finished_ops"] == cc["dispatched_ops"]
    # against the reference engine on the same traffic
    _, ref_odo, ref_c = block_episode(tiny, "ref", "when")
    _, ref_odo_off, _ = block_episode(tiny, "ref")
    assert (odo_on, odo_off) == (ref_odo, ref_odo_off)
    assert counters(c) == counters(ref_c)


@pytest.mark.parametrize("mode", ["off", "when", "torus"])
def test_attached_but_disabled_comms_is_byte_identical(tiny, mode):
    """Disabled: everything as with no scheduler.  WHEN-only and routed:
    the same replies and dispatches, and the routed engine's odometers
    equal the WHEN-only engine's."""
    r_off, odo_off, _ = block_episode(tiny, "port")
    r_on, odo_on, c = block_episode(tiny, "port", mode)
    assert r_on == r_off
    if mode == "off":
        assert odo_on == odo_off
        assert c.counters()["transfer_dispatches"] == 0
        assert c.counters()["submitted_ops"] == 0
        return
    _, odo_when, when = block_episode(tiny, "port", "when")
    assert odo_on == odo_when
    ref_counters = counters(block_episode(tiny, "ref", mode)[2])
    assert counters(c) == ref_counters
    if mode != "when":
        assert_no_oversubscription(c.ledger)


def sharded_evac_episode(tiny, side, comms_on=None, traced=False):
    """The reference's evacuation episode: 6 prompts on a 2 x 2 plane,
    shard 1's in-flight rows taken after two steps and resumed."""
    params, config, kw, module, _ = side_of(tiny, side)
    cls = ShardedBatcher if side == "port" else jax_plane.ShardedBatcher
    plane = cls(params, config, shards=2, shard_slots=2, prompt_len=PROMPT,
                generate_tokens=TOKENS, decode_block=BLOCK, **kw)
    lifecycle = registry_of(side, now_fn=time.perf_counter) if traced else None
    if lifecycle is not None:
        plane.lifecycle = lifecycle
    c = make_comms(module, comms_on, shards=2, lifecycle=lifecycle)
    if c is not None:
        plane.attach_comms(c)
    ps = prompts_for(6)
    queue = [(ids, {"MessageId": f"r{i}"}) for i, ids in enumerate(ps)]
    results = {}

    def collect(finished):
        for payload, toks in finished:
            results[payload["MessageId"]] = tuple(int(t) for t in toks)

    def fill():
        n = min(len(queue), len(plane.free_slots))
        if n:
            plane.submit_many(queue[:n])
            del queue[:n]

    fill()
    collect(plane.step())
    collect(plane.step())
    evacuated = plane.take_shard_inflight(1)
    resumes = [
        (ps[int(payload["MessageId"][1:])], payload, produced, budget, t)
        for payload, produced, budget, t in evacuated
    ]
    for _ in range(400):
        fill()
        if resumes and plane.free_slots:
            admitted = plane.submit_resume(resumes)
            del resumes[:len(admitted)]
        collect(plane.step())
        if not queue and not resumes and plane.active == 0:
            break
    return results, odometers(plane), c, lifecycle


def test_sharded_evacuation_comms_parity_and_transfer_stamps(tiny):
    r_off, odo_off, _, _ = sharded_evac_episode(tiny, "port")
    assert len(r_off) == 6  # exactly once through the evacuation
    r_dis, odo_dis, _, _ = sharded_evac_episode(tiny, "port", "off")
    assert (r_dis, odo_dis) == (r_off, odo_off)
    r_on, odo_on, c, reg = sharded_evac_episode(tiny, "port", "when",
                                                traced=True)
    assert r_on == r_off
    assert odo_on[0] < odo_off[0] and odo_on[1:] == odo_off[1:]
    cc = c.counters()
    assert cc["by_kind"][EVACUATION_KV] == 1
    # each evacuated request carries its transfer window
    traces = reg.open_traces() + reg.done_traces()
    evacuated = [t for t in traces if t.notes.get("transfer_evacuation_kv")]
    assert evacuated
    assert all(transfer_spans(t) for t in evacuated)
    # the reference engine on the same traffic: the same odometers, the
    # same counters, the same evacuation bytes and the same notes
    _, ref_odo, ref_c, ref_reg = sharded_evac_episode(tiny, "ref", "when",
                                                      traced=True)
    _, ref_odo_off, _, _ = sharded_evac_episode(tiny, "ref")
    assert (odo_on, odo_off) == (ref_odo, ref_odo_off)
    assert counters(c) == counters(ref_c)
    evac_bytes = [[op.nbytes for op in x.recent if op.kind == EVACUATION_KV]
                  for x in (c, ref_c)]
    assert evac_bytes[0] == evac_bytes[1]
    ref_traces = ref_reg.open_traces() + ref_reg.done_traces()
    assert sorted((t.rid, sorted(t.notes.items())) for t in traces) == sorted(
        (t.rid, sorted(t.notes.items())) for t in ref_traces)


@pytest.mark.parametrize("mode", ["when", "two-tier"])
def test_handoff_records_transfer_and_stamps_requests(tiny, mode):
    out = []
    for side in SIDES:
        params, config, kw, module, _ = side_of(tiny, side)
        reg = registry_of(side, now_fn=time.perf_counter)
        c = make_comms(module, mode, shards=2, lifecycle=reg)
        if c.topology is not None:
            c.topology.ensure_node("prefill")
            c.topology.ensure_node("decode-plane")
        donor_cls = (ContinuousBatcher if side == "port"
                     else jax_continuous.ContinuousBatcher)
        plane_cls = (DecodePlaneBatcher if side == "port"
                     else jax_engine.DecodePlaneBatcher)
        donor = donor_cls(params, config, 2, PROMPT, TOKENS,
                          decode_block=BLOCK, **kw)
        donor.submit_many([(ids, {"MessageId": f"p{i}"})
                           for i, ids in enumerate(prompts_for(2))])
        donor._settle_pending_firsts()
        records = [
            (row, slot.payload, list(slot.produced), slot.budget,
             slot.submitted_at, slot.tenant)
            for row, slot in enumerate(donor.slots)
            if slot.busy and slot.produced and not slot.done
        ]
        plane = plane_cls(params, config, shards=2, shard_slots=1,
                          prompt_len=PROMPT, generate_tokens=TOKENS,
                          decode_block=BLOCK, **kw)
        plane.lifecycle = reg
        plane.attach_comms(c)
        rows = plane.submit_handoff(donor, records)
        assert len(rows) == len(records) == 2
        traces = reg.open_traces() + reg.done_traces()
        stamped = [t for t in traces if transfer_spans(t)]
        assert len(stamped) == 2
        assert all(t.notes.get("transfer_handoff_kv") for t in stamped)
        assert all(t.first("handoff") is not None for t in stamped)
        out.append((c.counters(), [op.nbytes for op in c.recent],
                    [(t.rid, t.notes, t.routes) for t in traces]))
    assert out[0] == out[1]
    assert out[0][0]["by_kind"][HANDOFF_KV] == 1


def test_prefix_pool_install_records_a_transfer(tiny):
    got = []
    for side in SIDES:
        params, config, kw, module, _ = side_of(tiny, side)
        cls = PrefixPool if side == "port" else jax_tenancy.PrefixPool
        key_of = (prefix_pool_key if side == "port"
                  else jax_tenancy.prefix_pool_key)
        pool = cls(params, config, entries=2, prefix_len=4, **kw)
        c = module.CollectiveScheduler()
        pool.comms = c
        ids = tokens("gpt", 1, 4, 3)[0]
        pool.acquire(0, key_of("a", ids), ids)
        assert c.counters()["by_kind"][PREFIX_INSTALL] == 1
        pool.acquire(0, key_of("a", ids), ids)  # hit: no new op
        assert c.counters()["by_kind"][PREFIX_INSTALL] == 1
        got.append(c.counters())
    assert got[0] == got[1]


@pytest.mark.parametrize("mode", ["off", "when", "torus"])
def test_disaggregated_pool_comms_off_is_byte_identical(mode):
    """``DisaggregatedPool.attach_comms``: attached but disabled, the pool
    serves exactly as with no scheduler (odometers and replies); WHEN-only
    and routed, the same replies at fewer blocking host transfers, and
    every handoff recorded."""
    from .test_torch_lifecycle import disagg_episode

    jcfg, jp, tcfg, tp = weights("gpt")
    tiny = (jp, jcfg, tp, tcfg)
    base = disagg_episode(True, tiny, False)
    c = make_comms(comms, mode, shards=2)
    run = disagg_episode(True, tiny, False, comms=c)
    assert run[2] == base[2] and len(run[2]) == 8
    if mode == "off":
        assert run[1] == base[1]
        assert c.counters()["submitted_ops"] == 0
        return
    def blocking(episode):
        pool = episode[3]
        return pool.decode.batcher.host_transfers + sum(
            r.worker.batcher.host_transfers for r in pool.members)

    # the prefill replicas' block engines pull inside their windows; the
    # drafted decode plane's rounds read their own copies, as in the
    # reference
    assert blocking(run) < blocking(base)
    # the decode plane's inserts, dispatches and handoffs, cycle by cycle
    assert [(o[0], o[1], o[3]) for o in run[1]] == [
        (o[0], o[1], o[3]) for o in base[1]]
    cc = c.counters()
    assert cc["by_kind"][HANDOFF_KV] > 0 and cc["pending"] == 0
