"""The port's shard failure domain held against the JAX package's.

The same weights (the reference's, converted), the same queue bodies and
the same fault plan drive the reference's ``ShardedWorkerPool`` and the
port's, f32 and greedy on the CPU, on a ``FakeClock``:

- ``FleetFaultPlan``'s shard part validates its windows and applies them
  at exact cycles; the admission faults stay refused;
- one episode per fault class (a poison window, a wedge window, a mask
  corruption), and one under each side's ``ControlLoop`` with all three
  on three shards while the loop scales the plane: the same sequence of
  events (name, time, shard, cause, rows evacuated and released), the
  same replies, every request answered exactly once;
- evacuation with no free slot hands the rows back to the queue,
  ``scale_up`` never resurrects a quarantined shard, ``stop_all`` clears
  the probe cap; the binary's ``--shards`` usage errors, and its plane
  alone and as the replicas of a fleet.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu import fleet as jax_fleet
from kube_sqs_autoscaler_tpu.core import loop as jax_loop
from kube_sqs_autoscaler_tpu.core import policy as jax_policy
from kube_sqs_autoscaler_tpu.core.clock import FakeClock as JaxClock
from kube_sqs_autoscaler_tpu.metrics import fake as jax_fake
from kube_sqs_autoscaler_tpu.metrics import queue as jax_queue
from kube_sqs_autoscaler_tpu.sim import faults as jax_faults
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch import fleet
from kube_sqs_autoscaler_tpu_torch.core import loop, policy
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.fleet import (
    PROBING,
    QUARANTINED,
    SERVING,
    SHARD_HEALTH_CODES,
    SHARD_STATE_CODES,
    ShardedWorkerPool,
)
from kube_sqs_autoscaler_tpu_torch.metrics import fake, queue
from kube_sqs_autoscaler_tpu_torch.obs import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
from kube_sqs_autoscaler_tpu_torch.workloads import service
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary

from .test_torch_model import DIMS, both_params

SHARDS, SLOTS, PROMPT, TOKENS, BLOCK = 3, 2, 8, 8, 2

SIDES = {
    "jax": SimpleNamespace(
        Clock=JaxClock, Queue=jax_fake.FakeMessageQueue,
        Service=jax_service.ServiceConfig, Pool=jax_fleet.ShardedWorkerPool,
        Driver=jax_fleet.FleetDriver, Plan=jax_faults.FleetFaultPlan,
        Loop=jax_loop.ControlLoop, LoopConfig=jax_loop.LoopConfig,
        Policy=jax_policy.PolicyConfig, Source=jax_queue.QueueMetricSource,
        collect=jax_service.collect_replies,
    ),
    "port": SimpleNamespace(
        Clock=FakeClock, Queue=fake.FakeMessageQueue,
        Service=service.ServiceConfig, Pool=ShardedWorkerPool,
        Driver=fleet.FleetDriver, Plan=FleetFaultPlan, Loop=loop.ControlLoop,
        LoopConfig=loop.LoopConfig, Policy=policy.PolicyConfig,
        Source=queue.QueueMetricSource, collect=service.collect_replies,
    ),
}


@pytest.fixture(scope="module")
def weights():
    return both_params()


@pytest.fixture(scope="module")
def jax_donor(weights):
    """One reference plane whose compiled programs every reference pool
    of this module adopts, so each compiles once."""
    jcfg, jp, _, _ = weights
    return jax_plane.ShardedBatcher(
        jp, jcfg, shards=SHARDS, shard_slots=SLOTS, prompt_len=PROMPT,
        generate_tokens=TOKENS, decode_block=BLOCK)


def bodies(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [json.dumps(rng.integers(1, DIMS["vocab_size"],
                                    rng.integers(2, PROMPT + 1)).tolist())
            for _ in range(n)]


def build(side, weights, donor, *, url, min_, max_, initial, **pool_kw):
    """One side's clock, queues and pool over the plane."""
    jcfg, jp, tcfg, tp = weights
    s = SIDES[side]
    clock = s.Clock()
    jobs = s.Queue(visibility_timeout=30.0, now_fn=clock.now)
    results = s.Queue(now_fn=clock.now)
    config = s.Service(queue_url=url, batch_size=SLOTS, seq_len=PROMPT,
                       generate_tokens=TOKENS, decode_block=BLOCK,
                       shards=SHARDS, result_queue_url=url + "-r")
    kw = dict(result_queue=results, min=min_, max=max_, initial=initial,
              clock=clock, now_fn=clock.now, **pool_kw)
    if side == "jax":
        pool = s.Pool.serving(jobs, jp, jcfg, config, engine_source=donor,
                              **kw)
    else:
        pool = s.Pool.serving(jobs, tp, tcfg, config, device="cpu", **kw)
    return SimpleNamespace(side=s, clock=clock, jobs=jobs, results=results,
                           pool=pool, url=url)


def settled(pool) -> bool:
    return pool.idle and not any(st in (QUARANTINED, PROBING)
                                 for st in pool.shard_states)


def stream(world, messages, plan, *, send_every=1, max_cycles=300):
    """Send one body every ``send_every`` cycles, apply ``plan`` before
    each cycle and run the pool until every request settled and every
    quarantined shard is back; returns the sent message ids."""
    pool, waiting, sent = world.pool, list(messages), []
    for step in range(max_cycles):
        if waiting and step % send_every == 0:
            sent.append(world.jobs.send_message(world.url, waiting.pop(0)))
        plan.apply(pool.cycle, pool)
        pool.run_cycle()
        world.clock.advance(0.2)
        if not waiting and pool.processed >= len(sent) and settled(pool):
            return sent
    raise AssertionError("the plane did not settle within the cycle budget")


def events(pool) -> list[tuple]:
    return [(e.name, e.t, e.args) for e in pool.events]


def replies_of(world) -> dict:
    replies, duplicates = world.side.collect(world.results, world.url + "-r")
    assert duplicates == 0
    return replies


def quarantines(pool) -> list[tuple]:
    return [(e.args["shard"], e.args["cause"]) for e in pool.events
            if e.name == "shard-quarantine"]


# ---------------------------------------------------------------------------
# FleetFaultPlan's shard part
# ---------------------------------------------------------------------------


def test_fault_plan_validates_shard_windows_and_refuses_admission_faults():
    with pytest.raises(ValueError, match="start < end"):
        FleetFaultPlan(shard_poisons=((5, 5, 0),))
    with pytest.raises(ValueError, match="start < end"):
        FleetFaultPlan(shard_wedges=((7, 3, 1),))
    # the admission faults are ported: windows validate as the shard ones
    with pytest.raises(ValueError, match="start < end"):
        FleetFaultPlan(admission_partitions=((4, 2, 0),))
    assert FleetFaultPlan(admission_kills=((1, 0),),
                          admission_partitions=((1, 2, 1),)
                          ).admission_shards() == {0, 1}
    plan = FleetFaultPlan(kills=((1, 0),), shard_poisons=((1, 4, 0),),
                          shard_wedges=((2, 5, 1),),
                          shard_mask_corruptions=((3, 2),))
    assert plan.shards() == {0, 1, 2} and plan.indices() == {0}


def test_fault_plan_applies_shard_faults_at_exact_cycles():
    kw = dict(shard_poisons=((2, 4, 1),), shard_wedges=((3, 6, 0),),
              shard_mask_corruptions=((5, 1),))
    calls = {}
    for side, plan in (("jax", jax_faults.FleetFaultPlan(**kw)),
                       ("port", FleetFaultPlan(**kw))):
        seen = calls[side] = []

        class Recorder:
            def poison_shard(self, shard, poisoned):
                seen.append(("poison", shard, poisoned))

            def wedge_shard(self, shard, wedged):
                seen.append(("wedge", shard, wedged))

            def corrupt_shard_mask(self, shard):
                seen.append(("mask", shard))

        for cycle in range(8):
            plan.apply(cycle, Recorder())
    # injected at start, healed at end (end-exclusive); the corruption once
    assert calls["port"] == calls["jax"] == [
        ("poison", 1, True), ("wedge", 0, True), ("poison", 1, False),
        ("mask", 1), ("wedge", 0, False)]


# ---------------------------------------------------------------------------
# The pool against the reference's pool, one fault class at a time
# ---------------------------------------------------------------------------

EPISODES = {
    # cause: (the plan's keyword, its value, the faulted shard)
    "poisoned-logits": ("shard_poisons", ((4, 9, 1),)),
    "no-progress": ("shard_wedges", ((4, 12, 1),)),
    "mask-mismatch": ("shard_mask_corruptions", ((5, 1),)),
}


@pytest.mark.parametrize("cause", list(EPISODES))
def test_pool_matches_the_reference_pool_through_one_fault(
        weights, jax_donor, cause):
    name, value = EPISODES[cause]
    messages = bodies(24, seed=31)
    worlds, sent = {}, {}
    for side in SIDES:
        worlds[side] = build(side, weights, jax_donor, url=f"chaos://{cause}",
                             min_=SHARDS, max_=SHARDS, initial=SHARDS,
                             probe_after_cycles=3, hang_grace_cycles=2)
        plan = SIDES[side].Plan(**{name: value})
        sent[side] = stream(worlds[side], messages, plan)
    port, ref = worlds["port"].pool, worlds["jax"].pool
    assert sent["port"] == sent["jax"]
    assert events(port) == events(ref)
    assert quarantines(port)[0] == (1, cause)
    assert {c for _, c in quarantines(port)} == {cause}
    assert port.readmitted_total >= 1
    assert (port.rows_evacuated_total, port.released_total) == (
        ref.rows_evacuated_total, ref.released_total)
    assert port.rows_evacuated_total > 0
    replies = replies_of(worlds["port"])
    assert set(replies) == set(sent["port"])  # exactly once
    assert replies == replies_of(worlds["jax"])
    assert port.processed == len(sent["port"])


def test_every_fault_under_the_control_loop_matches_the_reference(
        weights, jax_donor):
    # the chip smoke's chaos episode at CPU size: the loop scales a
    # one-shard plane up to three through a backlog while a poison
    # window, a wedge window and a mask corruption land on three shards
    messages = bodies(36, seed=47)
    plan_kw = dict(shard_poisons=((9, 13, 0),), shard_wedges=((16, 24, 1),),
                   shard_mask_corruptions=((24, 2),))
    out = {}
    for side, s in SIDES.items():
        world = build(side, weights, jax_donor, url="chaos://loop", min_=1,
                      max_=SHARDS, initial=1, probe_after_cycles=4,
                      hang_grace_cycles=2)
        pool = world.pool
        sent = [world.jobs.send_message(world.url, body)
                for body in messages]
        control = s.Loop(
            pool, s.Source(world.jobs, world.url,
                           ("ApproximateNumberOfMessages",)),
            s.LoopConfig(poll_interval=1.0, policy=s.Policy(
                scale_up_messages=4, scale_down_messages=1,
                scale_up_cooldown=1.0, scale_down_cooldown=2.0)),
            clock=world.clock)
        stats = s.Driver(pool, control, cycle_dt=0.5,
                         fault_plan=s.Plan(**plan_kw)).run(
            max_cycles=400,
            until=lambda pool=pool, n=len(sent): (
                pool.processed >= n and settled(pool)
                and pool.replicas == pool.min))
        out[side] = (world, sent, stats)
    (port_world, sent, stats), (ref_world, jsent, jstats) = (
        out["port"], out["jax"])
    port, ref = port_world.pool, ref_world.pool
    assert sent == jsent
    assert events(port) == events(ref)
    assert stats["replica_trajectory"] == jstats["replica_trajectory"]
    assert max(stats["replica_trajectory"]) == SHARDS
    assert sorted(quarantines(port)) == [
        (0, "poisoned-logits"), (1, "no-progress"), (2, "mask-mismatch")]
    assert port.rows_evacuated_total > 0
    assert port.readmitted_total == 3
    replies = replies_of(port_world)
    assert set(replies) == set(sent) and replies == replies_of(ref_world)


# ---------------------------------------------------------------------------
# Edges of the failure domain
# ---------------------------------------------------------------------------


def test_evacuation_without_a_free_slot_hands_rows_back(weights, jax_donor):
    out = {}
    for side in SIDES:
        world = build(side, weights, jax_donor, url="chaos://full",
                      min_=SHARDS, max_=SHARDS, initial=SHARDS,
                      probe_after_cycles=3, hang_grace_cycles=2)
        pool = world.pool
        sent = [world.jobs.send_message(world.url, body)
                for body in bodies(SHARDS * SLOTS, seed=53)]
        pool.run_cycle()  # one refill fills every shard
        assert [pool.worker.batcher.shard_busy(s)
                for s in range(SHARDS)] == [SLOTS] * SHARDS
        plan = SIDES[side].Plan(shard_poisons=((1, 6, 1),))
        for _ in range(200):
            plan.apply(pool.cycle, pool)
            pool.run_cycle()
            world.clock.advance(0.2)
            if pool.processed >= len(sent) and settled(pool):
                break
        out[side] = (world, sent)
    (world, sent), (ref_world, _) = out["port"], out["jax"]
    pool = world.pool
    assert events(pool) == events(ref_world.pool)
    assert pool.rows_evacuated_total == 0 and pool.released_total >= 1
    replies = replies_of(world)
    assert set(replies) == set(sent)  # slower, never lost
    assert replies == replies_of(ref_world)


def test_scale_up_never_resurrects_a_quarantined_shard(weights):
    world = build("port", weights, None, url="chaos://up", min_=1,
                  max_=SHARDS, initial=2, probe_after_cycles=50)
    pool, batcher = world.pool, world.pool.worker.batcher
    for body in bodies(4, seed=59):
        world.jobs.send_message(world.url, body)
    pool.poison_shard(1)
    for _ in range(6):
        pool.run_cycle()
        if pool.quarantined_total:
            break
    assert pool.shard_states[1] == QUARANTINED and pool.replicas == 1
    pool.scale_up()  # activates the inactive shard 2, not shard 1
    assert pool.shard_states[2] == SERVING and pool.replicas == 2
    pool.scale_up()  # below max, but the only shard left is quarantined
    assert pool.shard_states[1] == QUARANTINED and pool.replicas == 2
    assert batcher.shard_admitting[1] is False
    assert all(row // SLOTS != 1 for row in batcher.free_slots)


def test_stop_all_clears_the_probe_cap_and_health_codes_cover_states(
        weights):
    assert set(SHARD_HEALTH_CODES) == set(SHARD_STATE_CODES)
    assert SHARD_HEALTH_CODES[SERVING] == 0
    world = build("port", weights, None, url="chaos://stop", min_=1,
                  max_=SHARDS, initial=SHARDS)
    pool, batcher = world.pool, world.pool.worker.batcher
    registry = WorkloadMetrics()
    pool.attach_metrics(registry)
    pool.shard_states[2] = PROBING
    batcher.shard_probing[2] = True
    assert len(batcher._admission_rows_by_shard()[2]) == 1
    pool.stop_all()
    assert batcher.shard_probing == [False] * SHARDS
    assert pool.replicas == 0 and not any(batcher.shard_admitting)
    text = registry.render()
    for gauge in ("shard_health", "shard_active", "shard_active_slots",
                  "shard_tokens_per_second", "shard_quarantined_total",
                  "rows_evacuated_total"):
        assert gauge in text
    with pytest.raises(ValueError, match="allocated shards"):
        build("port", weights, None, url="chaos://max", min_=1,
              max_=SHARDS + 1, initial=1)
    with pytest.raises(ValueError, match="hang_grace_cycles"):
        build("port", weights, None, url="chaos://g", min_=1, max_=1,
              initial=1, hang_grace_cycles=1)


@pytest.mark.parametrize("args,message", [
    (["--shards", "0", "--continuous"], "--shards 0 must be >= 1"),
    (["--shards", "2"], "--shards requires --continuous"),
])
def test_binary_rejects_shards_outside_their_mode(args, message):
    with pytest.raises(SystemExit, match=message):
        binary(["--demo", "4", "--generate-tokens", "2", "--device", "cpu",
                *args])


@pytest.mark.parametrize("fleet_replicas", [0, 2], ids=["plane", "fleet"])
def test_binary_serves_a_sharded_plane_on_the_cpu(fleet_replicas):
    # with --fleet-max-replicas each replica is a plane, spun up from a
    # sharded donor's engine
    argv = ["--device", "cpu", "--demo", "8", "--seq-len", "16",
            "--generate-tokens", "4", "--continuous", "--decode-block", "2",
            "--shards", "2", "--result-queue-url", "demo://replies"]
    if fleet_replicas:
        argv += ["--fleet-max-replicas", str(fleet_replicas)]
    result = binary(argv)
    assert result["processed"] == 8 and len(result["replies"]) == 8
    assert result["duplicate_replies"] == 0
    if not fleet_replicas:
        assert result["gang_cycles"] == result["decode_dispatches"] > 0
        assert result["summary_transfers"] == result["block_settles"]
        assert result["host_transfers"] <= result["gang_cycles"] + 1
