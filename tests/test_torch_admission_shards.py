"""The port's sharded admission plane held against the JAX package's.

Host bookkeeping, so the comparisons are exact:

- ``HashRing``'s tenant-to-shard maps, with and without dead owners, equal
  the reference's over 10,000 tenant names;
- ``AdmissionCoordinator``'s grants and state, and ``ShardedAdmission``'s
  pick orders, hand-backs and ``export_state`` dicts equal the reference's
  cycle by cycle over a seeded flood trace, through a shard kill and a
  gossip partition;
- the ``ContinuousWorker`` with ``admission_shards=4`` (f32, both sides'
  tiny GPT and llama) replies, counts and exports its admission state as
  the reference worker does, also with a kill and a partition mid-flood,
  and the ``ShardedWorkerPool`` under ``FleetFaultPlan``'s admission faults
  answers every request exactly once, as the reference's pool does.

The reference's own tests (``tests/test_admission_shards.py``, all but its
two bench tests) are mirrored by name on the port.
"""

import json

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu.fleet import ShardedWorkerPool as JaxShardedPool
from kube_sqs_autoscaler_tpu.sim import faults as jax_faults
from kube_sqs_autoscaler_tpu.workloads import __main__ as jax_binary
from kube_sqs_autoscaler_tpu.workloads import admission_shards as jax_shards
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch.fleet import ShardedWorkerPool
from kube_sqs_autoscaler_tpu_torch.obs import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, tenancy
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.admission_shards import (
    AdmissionCoordinator, HashRing, ShardedAdmission,
)
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
    FairAdmission, TenancyConfig,
)

from .test_torch_prefix_pool import jitted_reference_prefill  # noqa: F401
from .test_torch_tenant_serving import (
    EPISODES, PREFIX, REPLIES, SIDES, URL, config, flood_schedule, send,
)

SHARDS = {True: (tenancy, ShardedAdmission, AdmissionCoordinator, HashRing),
          False: (jax_tenancy, jax_shards.ShardedAdmission,
                  jax_shards.AdmissionCoordinator, jax_shards.HashRing)}


def _plane(shards=4, tenants=("a", "b", "c", "d"), port=True, **overrides):
    tenancy_mod, plane_cls = SHARDS[port][:2]
    kw = dict(tenants=tenants, admission_shards=shards,
              staging_per_tenant=8, staging_total=32)
    kw.update(overrides)
    return plane_cls(tenancy_mod.TenancyConfig(**kw), per_tenant_limit=8,
                     total_limit=32)


def _item(tenant, index):
    # the worker stages (tenant, prefix_ids, ids, message); item[3] is the
    # queue message a kill hands back
    return (tenant, None, (1, 2, 3),
            {"MessageId": f"{tenant}-{index}",
             "ReceiptHandle": f"rh-{tenant}-{index}", "Body": "{}"})


def normalized(state):
    return json.loads(json.dumps(state))


# ---------------------------------------------------------------------------
# Against the reference, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4, 5])
def test_hash_ring_maps_equal_the_reference(shards):
    tenants = [f"tenant-{i}" for i in range(10_000)]
    port, ref = HashRing(shards), jax_shards.HashRing(shards)
    assert [port.shard_of(t) for t in tenants] == \
        [ref.shard_of(t) for t in tenants]
    alive = set(range(1, shards))
    assert [port.shard_of(t, alive=alive) for t in tenants] == \
        [ref.shard_of(t, alive=alive) for t in tenants]


def test_coordinator_grants_equal_the_reference():
    rng = np.random.default_rng(3)
    port, ref = AdmissionCoordinator(3), jax_shards.AdmissionCoordinator(3)
    for _ in range(400):
        k = int(rng.integers(0, 9))
        demands = [int(d) for d in rng.integers(0, 12, 3)]
        weights = [float(w) for w in rng.choice([0.0, 0.5, 1.0, 3.0], 3)]
        assert port.allocate(k, demands, weights) == \
            ref.allocate(k, demands, weights)
        assert port.export_state() == ref.export_state()


def flood_trace(seed: int, cycles: int):
    """cycle -> staged (tenant, index): a flooding tenant, three victims
    and a long tail of one-off tenants."""
    rng = np.random.default_rng(seed)
    out, n = {}, 0
    for cycle in range(cycles):
        sends = []
        if cycle < cycles - 8:
            sends += ["flood"] * int(rng.integers(3, 7))
            sends += [f"v{int(v)}" for v in rng.integers(0, 3, 2)]
            sends += [f"tail{int(t)}" for t in rng.integers(0, 200, 2)]
        out[cycle] = [(t, n + i) for i, t in enumerate(sends)]
        n += len(sends)
    return out


def plane_run(port: bool, trace, cycles: int, kill_at: int,
              partition: tuple[int, int, int]):
    """Stage ``trace``, gossip and pick 5 a cycle, partition a shard for a
    window and kill the flooding tenant's shard at ``kill_at``; returns the
    plane and each cycle's outcomes and exported state."""
    plane = _plane(port=port, tenants=("flood", "v0", "v1", "v2"),
                   shed_tiers=2)
    log = []
    for cycle in range(cycles):
        plane.note_cycle()
        start, end, shard = partition
        if cycle == start:
            plane.partition_shard(shard, True)
        elif cycle == end:
            plane.partition_shard(shard, False)
        staged = [plane.stage(t, _item(t, i), message_id=f"m{i}")
                  for t, i in trace[cycle]]
        flood = sorted(plane.over_share())
        handed = []
        if cycle == kill_at:
            plane.kill_shard(plane.shard_of("flood").index,
                             handback=lambda m: handed.append(m["MessageId"]))
        picked = [(t, item[3]["MessageId"])
                  for t, item in plane.pick(5, now=None)]
        log.append((staged, flood, handed, picked, plane.staged, plane.room,
                    normalized(plane.export_state())))
    return plane, log


def test_plane_picks_and_state_equal_the_reference_through_faults():
    trace = flood_trace(5, 40)
    runs = [plane_run(port, trace, 40, kill_at=12, partition=(6, 18, 2))
            for port in (True, False)]
    (port, got), (ref, want) = runs
    for cycle, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"cycle {cycle}"
    assert any(entry[2] for entry in got)  # the kill handed work back
    killed = [s for s in port.shards if s.kills]
    assert len(killed) == 1 and killed[0].rehydrations == 1
    assert killed[0].rehydrated_records > 0  # rehydrated, not cold
    assert any(entry[1] for entry in got)  # the flood was classified
    assert port.host_ops_by_shard() == ref.host_ops_by_shard()


def fault_episode(side, family, tenancy_kw, schedule, cycles, faults,
                  service_kw=None, dt=0.25):
    """The reference tenancy worker episode (``worker_episode``) with
    ``faults``: cycle -> [(worker method, args of the worker)] applied
    before the cycle."""
    clock = side.Clock(1000.0)
    queue, results = side.Queue(now_fn=clock.now), side.Queue(
        now_fn=clock.now)
    cfg, params = side.model(family)
    worker = side.continuous.ContinuousWorker(
        queue, params, cfg, config(side, **(service_kw or {})),
        result_queue=results, now_fn=clock.now, family=family,
        tenancy=side.tenancy.TenancyConfig(**tenancy_kw), **side.device)
    sent, trace = [], []
    for cycle in range(cycles):
        for tenant, ids, prefix in schedule.get(cycle, ()):
            sent.append(send(queue, tenant, ids, prefix))
        handed = [getattr(worker, name)(*args(worker))
                  for name, args in faults.get(cycle, ())]
        done = worker.run_once()
        trace.append((handed, done, worker.staged,
                      dict(worker.shed_by_reason), sorted(
                          worker._degrade_tenants),
                      [(s.tenant, s.budget) for s in worker.batcher.slots
                       if s.busy],
                      worker.batcher.insert_dispatches,
                      worker.batcher.decode_dispatches))
        clock.advance(dt)
    replies, duplicates = side.service.collect_replies(results, REPLIES)
    answered = [{k: v for k, v in replies[mid].items() if k != "request_id"}
                if mid in replies else None for mid in sent]
    return worker, trace, answered, duplicates


def flood_home(worker) -> int:
    return worker._fair.shard_of("flood").index


# partition a victim's shard for a window, kill the flood's mid-flood
FAULTS = {6: [("partition_admission_shard", lambda w: (
              w._fair.shard_of("v0").index, True))],
          7: [("kill_admission_shard", lambda w: (flood_home(w),))],
          14: [("partition_admission_shard", lambda w: (
               w._fair.shard_of("v0").index, False))]}


@pytest.mark.parametrize("family,episode,faults", [
    ("gpt", "drr", False), ("llama", "drr", False), ("gpt", "ladder", False),
    ("gpt", "drr", True), ("gpt", "ladder", True),
], ids=["gpt-drr", "llama-drr", "gpt-ladder", "gpt-drr-faults",
        "gpt-ladder-faults"])
def test_sharded_admission_worker_matches_the_reference(family, episode,
                                                        faults):
    kw = dict(EPISODES[episode], prefix_pool=2, prefix_len=PREFIX,
              admission_shards=4)
    schedule = flood_schedule(family, 30, seed=33)
    runs = [fault_episode(side, family, kw, schedule, 80,
                          FAULTS if faults else {}) for side in SIDES]
    (port, trace, replies, dup), (ref, ref_trace, ref_replies, _) = runs
    for cycle, (got, want) in enumerate(zip(trace, ref_trace)):
        assert got == want, f"cycle {cycle}"
    assert replies == ref_replies and None not in replies and dup == 0
    assert normalized(port.export_admission_state()) == \
        normalized(ref.export_admission_state())
    assert port.completed_by_tenant == ref.completed_by_tenant
    assert isinstance(port._fair, ShardedAdmission)
    if faults:
        (shard,) = [s for s in port._fair.shards if s.kills]
        assert shard.kills == 1 and shard.rehydrations == 1
        assert trace[7][0][0] >= 1  # the kill handed staged work back
        assert shard.rehydrated_records > 0  # rehydrated, not cold


def test_single_admission_shard_never_builds_the_sharded_plane():
    cfg, params = SIDES[0].model("gpt")
    worker = continuous.ContinuousWorker(
        SIDES[0].Queue(), params, cfg, config(result_queue_url=""),
        tenancy=TenancyConfig(tenants=("a",), admission_shards=1),
        device="cpu")
    assert type(worker._fair) is FairAdmission
    with pytest.raises(ValueError, match="admission_shards must be >= 2"):
        worker.kill_admission_shard(0)
    with pytest.raises(ValueError, match="admission_shards must be >= 2"):
        worker.partition_admission_shard(0)


def pool_run(side, pool_cls, plan_cls, schedule, cycles):
    clock = side.Clock(1000.0)
    queue, results = side.Queue(now_fn=clock.now), side.Queue(
        now_fn=clock.now)
    cfg, params = side.model("gpt")
    pool = pool_cls.serving(
        queue, params, cfg, config(side, result_queue_url=REPLIES),
        min=2, max=2, shards=2, result_queue=results, now_fn=clock.now,
        tenancy=side.tenancy.TenancyConfig(
            tenants=("v0", "v1", "flood"), prefix_pool=2, prefix_len=PREFIX,
            admission_shards=3), clock=clock, **side.device)
    plan = plan_cls(admission_kills=((5, 0),),
                    admission_partitions=((3, 9, 2),))
    sent, log = [], []
    for cycle in range(cycles):
        for tenant, ids, prefix in schedule.get(cycle, ()):
            sent.append(send(queue, tenant, ids, prefix))
        plan.apply(cycle, pool)
        pool.run_cycle()
        log.append((pool.processed, pool.worker.staged))
        clock.advance(0.25)
    replies, duplicates = side.service.collect_replies(results, REPLIES)
    return pool, sent, replies, duplicates, log


def test_sharded_pool_admission_faults_exactly_once_as_the_reference():
    schedule = flood_schedule("gpt", 24, seed=37)
    (port, sent, replies, dup, log), (ref, _, ref_replies, _, ref_log) = [
        pool_run(side, pool_cls, plan_cls, schedule, 70)
        for side, pool_cls, plan_cls in (
            (SIDES[0], ShardedWorkerPool, FleetFaultPlan),
            (SIDES[1], JaxShardedPool, jax_faults.FleetFaultPlan))]
    assert log == ref_log
    assert set(replies) == set(sent) and dup == 0  # exactly once
    strip = lambda r: {m: {k: v for k, v in p.items() if k != "request_id"}
                       for m, p in r.items()}
    assert strip(replies) == strip(ref_replies)
    state, ref_state = port.export_state(), ref.export_state()
    assert normalized(state["admission"]) == \
        normalized(ref_state["admission"])
    assert state["admission"]["fair"]["sharded"] is True
    assert port.worker._fair.shards[0].kills == 1
    assert port.completed_by_tenant == ref.completed_by_tenant
    fresh = ShardedWorkerPool(lambda p: port.worker, min=1)
    assert fresh.import_state(normalized(state)) > 0


# ---------------------------------------------------------------------------
# The reference's tests, mirrored on the port
# ---------------------------------------------------------------------------


def test_hash_ring_moves_about_one_over_n_when_growing():
    tenants = [f"t{i}" for i in range(10_000)]
    four, five = HashRing(4), HashRing(5)
    moved = sum(1 for t in tenants if four.shard_of(t) != five.shard_of(t))
    assert 0.10 < moved / len(tenants) < 0.30


def test_hash_ring_is_deterministic_across_instances():
    tenants = [f"t{i}" for i in range(500)]
    a, b = HashRing(4), HashRing(4)
    assert [a.shard_of(t) for t in tenants] == [b.shard_of(t)
                                                for t in tenants]
    assert {a.shard_of(t) for t in tenants} == {0, 1, 2, 3}


def test_hash_ring_failover_walks_past_dead_owner():
    ring = HashRing(4)
    home = ring.shard_of("victim-tenant")
    alive = {s for s in range(4) if s != home}
    rerouted = ring.shard_of("victim-tenant", alive=alive)
    assert rerouted != home and rerouted in alive
    for t in (f"t{i}" for i in range(200)):
        if ring.shard_of(t) != home:
            assert ring.shard_of(t, alive=alive) == ring.shard_of(t)


def test_sticky_home_survives_export_import():
    plane = _plane()
    tenants = [f"t{i}" for i in range(64)]
    for tenant in tenants:
        plane.stage(tenant, _item(tenant, 0), message_id=f"{tenant}-m0")
    homes = {t: plane.shard_of(t).index for t in tenants}
    fresh = _plane()
    fresh.import_state(normalized(plane.export_state()))
    assert {t: fresh.shard_of(t).index for t in tenants} == homes


def test_sticky_home_survives_kill_and_restart():
    plane = _plane()
    plane.stage("sticky-tenant", _item("sticky-tenant", 0), message_id="m0")
    home = plane.shard_of("sticky-tenant").index
    handed = []
    plane.kill_shard(home, handback=handed.append)
    assert [m["MessageId"] for m in handed] == ["sticky-tenant-0"]
    failover = plane.shard_of("sticky-tenant").index
    assert failover != home
    plane.restart_shard(home)
    assert plane.shard_of("sticky-tenant").index == failover


def test_coordinator_debt_never_exceeds_borrow_cap():
    coordinator = AdmissionCoordinator(4)
    demands = [40, 1, 0, 3]
    weights = [1.0, 1.0, 0.0, 2.0]
    for cycle in range(300):
        demands[1] = cycle % 3
        grants = coordinator.allocate(4, demands, weights)
        assert sum(grants) <= min(4, sum(demands))
        assert all(g >= 0 for g in grants)
        for s in range(4):
            assert coordinator.debt(s) <= coordinator.BORROW_CAP + 1e-9


def test_coordinator_never_starves_a_busy_peer():
    coordinator = AdmissionCoordinator(2)
    granted, offered = [0, 0], 0
    for cycle in range(200):
        demands = [1000, 2 if cycle % 2 else 0]
        offered += bool(demands[1])
        grants = coordinator.allocate(4, demands, [1.0, 1.0])
        granted[0] += grants[0]
        granted[1] += grants[1]
    assert granted[1] >= offered
    assert granted[0] > granted[1]


def test_coordinator_state_round_trips():
    coordinator = AdmissionCoordinator(3)
    for _ in range(20):
        coordinator.allocate(4, [5, 3, 1], [1.0, 2.0, 1.0])
    state = coordinator.export_state()
    fresh = AdmissionCoordinator(3)
    fresh.import_state(state)
    assert fresh.export_state() == state
    assert fresh.borrows_total == coordinator.borrows_total


def test_pick_never_exceeds_free_slots_under_banked_credit():
    plane = _plane()
    staged = sum(1 for i in range(24)
                 if plane.stage(f"burst{i}", _item(f"burst{i}", i),
                                message_id=f"b{i}"))
    assert staged >= 16
    for k in (1, 1, 1, 4, 4, 8):
        plane.note_cycle()
        assert len(plane.pick(k, now=None)) <= k


def test_kill_hands_back_staged_and_rehydrates_from_tombstone():
    plane = _plane()
    staged = sum(1 for i in range(12)
                 if plane.stage(f"t{i}", _item(f"t{i}", i),
                                message_id=f"m{i}"))
    victim = max(range(4), key=lambda s: plane.shards[s].fair.staged)
    before = plane.shards[victim].fair.staged
    assert before >= 1
    handed = []
    released = plane.kill_shard(victim, handback=handed.append)
    assert released == before == len(handed)
    assert not plane.shards[victim].alive
    assert plane.staged == staged - released
    plane.note_cycle()
    shard = plane.shards[victim]
    assert shard.alive and shard.rehydrations == 1
    assert shard.rehydrated_records >= 1
    assert shard.fair.staged == 0


def test_killed_shard_tombstone_carries_flood_state_to_restart():
    plane = _plane()
    plane.shards[1].fair._flood_sticky.add("coalition")
    plane.kill_shard(1)
    plane.restart_shard(1)
    assert "coalition" in plane.shards[1].fair._flood_sticky


def test_gossip_unions_flood_state_except_across_partitions():
    plane = _plane(shards=3, tenants=("a", "b", "c"))
    plane.partition_shard(2, True)
    plane.shards[0].fair._flood_sticky.add("mob")
    plane.gossip()
    assert "mob" in plane.shards[1].fair._flood_sticky
    assert "mob" not in plane.shards[2].fair._flood_sticky
    plane.partition_shard(2, False)
    plane.gossip()
    assert "mob" in plane.shards[2].fair._flood_sticky


def test_restarted_shard_adopts_peer_flood_gossip():
    plane = _plane()
    plane.kill_shard(0)
    plane.shards[1].fair._flood_sticky.add("mob")
    plane.restart_shard(0)
    assert "mob" in plane.shards[0].fair._flood_sticky


def test_adopt_flood_arms_sticky_grace():
    fair = FairAdmission(TenancyConfig(tenants=("a",)), per_tenant_limit=4,
                         total_limit=8)
    fair.adopt_flood({"mob"})
    assert "mob" in fair._flood_sticky
    assert fair._sticky_grace["mob"] == fair.STICKY_RESTORE_GRACE
    fair._sticky_grace["mob"] = 3
    fair.adopt_flood({"mob"})
    assert fair._sticky_grace["mob"] == 3


def test_single_shard_config_builds_the_plain_plane():
    with pytest.raises(ValueError, match="admission_shards"):
        ShardedAdmission(TenancyConfig(tenants=("a",), admission_shards=1),
                         per_tenant_limit=4, total_limit=8)
    with pytest.raises(ValueError, match="admission_shards"):
        TenancyConfig(tenants=("a",), admission_shards=0)
    with pytest.raises(ValueError, match="decode_slo_s"):
        TenancyConfig(tenants=("a",), decode_slo_s=-0.1)


def test_fault_plan_validates_admission_partition_windows():
    with pytest.raises(ValueError, match="admission_partitions"):
        FleetFaultPlan(admission_partitions=((5, 5, 0),))
    with pytest.raises(ValueError, match="admission_partitions"):
        FleetFaultPlan(admission_partitions=((8, 2, 1),))
    plan = FleetFaultPlan(admission_kills=((3, 1),),
                          admission_partitions=((2, 6, 0),))
    assert plan.admission_shards() == {0, 1}


def test_fault_plan_dispatches_admission_faults_by_cycle():
    calls = []

    class Pool:
        def kill_admission_shard(self, shard):
            calls.append(("kill", shard))

        def partition_admission_shard(self, shard, partitioned=True):
            calls.append(("partition", shard, partitioned))

    plan = FleetFaultPlan(admission_kills=((3, 1),),
                          admission_partitions=((2, 5, 0),))
    for cycle in range(7):
        plan.apply(cycle, Pool())
    assert calls == [("partition", 0, True), ("kill", 1),
                     ("partition", 0, False)]


@pytest.mark.parametrize("args,message", [
    (["--admission-shards", "2"], "requires --tenants"),
    (["--decode-slo-budget", "0.5"], "requires --tenants"),
    (["--tenants", "a", "--admission-shards", "0"], "must be >= 1"),
    (["--tenants", "a", "--decode-slo-budget", "-1"], "must be >= 0"),
], ids=["shards-alone", "budget-alone", "shards-0", "budget-negative"])
def test_admission_shard_flag_rejections(args, message):
    argv = ["--demo", "1", "--continuous", "--generate-tokens", "2", *args]
    for main, extra in ((jax_binary.main, []), (binary, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=message):
            main([*argv, *extra])


def test_admission_shards_binary_serves_the_demo():
    summary = binary(["--device", "cpu", "--demo", "6", "--seq-len", "8",
                      "--generate-tokens", "3", "--batch-size", "2",
                      "--continuous", "--decode-block", "2", "--tenants",
                      "a,b", "--admission-shards", "4", "--shed-tiers", "2",
                      "--result-queue-url", "demo://replies"])
    assert summary["processed"] == 6 and len(summary["replies"]) == 6
    assert summary["completed_by_tenant"] == {"a": 6}


def test_per_shard_gauges_render():
    cfg, params = SIDES[0].model("gpt")
    queue, results = SIDES[0].Queue(), SIDES[0].Queue()
    worker = continuous.ContinuousWorker(
        queue, params, cfg, config(batch_size=2, generate_tokens=4),
        result_queue=results,
        tenancy=TenancyConfig(tenants=("a", "b"), admission_shards=4),
        device="cpu")
    metrics = WorkloadMetrics()
    worker.attach_metrics(metrics)
    rng = np.random.default_rng(41)
    for index in range(3):
        queue.send_message(URL, json.dumps(
            {"tenant": ("a", "b")[index % 2],
             "ids": rng.integers(1, 64, 3).tolist()}))
    cycles = 0
    while worker.processed < 3:
        worker.run_once()
        cycles += 1
        assert cycles < 200, "worker did not drain"
    text = metrics.render()
    prefix = "kube_sqs_autoscaler_workload"
    for shard in range(4):
        label = f'{{shard="{shard}"}}'
        assert f"{prefix}_admission_shard_staged{label}" in text
        assert f"{prefix}_admission_shard_tenants{label}" in text
        assert f"{prefix}_admission_shard_state{label} 2.0" in text
    worker._fair.kill_shard(1)
    worker._update_metrics()
    assert f'{prefix}_admission_shard_state{{shard="1"}} 0.0' in \
        metrics.render()


def test_gossip_kill_and_rehydrate_journal_as_admission_lines(tmp_path):
    from kube_sqs_autoscaler_tpu_torch.obs.journal import (
        TickJournal, read_journal_events,
    )

    path = str(tmp_path / "journal.jsonl")
    journal = TickJournal(path)
    # the port's plane, then the reference's, on one journal
    for port in (True, False):
        plane = _plane(port=port)
        plane.attach_journal(journal)
        plane.stage("a", _item("a", 0), message_id="m0")
        plane.shards[0].fair._flood_sticky.add("mob")
        plane.gossip()
        plane.gossip()  # journaled once, when it first spreads
        plane.partition_shard(2, True)
        plane.kill_shard(plane.shard_of("a").index)
        plane.note_cycle()
    journal.close()
    events = read_journal_events(path, "admission")
    half = len(events) // 2
    port_lines, ref_lines = events[:half], events[half:]
    assert port_lines == ref_lines  # the reference's lines, in order
    assert [e["event"] for e in port_lines] == [
        "gossip", "partition", "kill", "rehydrate"]
    assert port_lines[0]["flood"] == ["mob"]
    assert port_lines[2]["handed_back"] == 1
