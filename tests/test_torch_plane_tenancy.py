"""Tenancy on the port's sharded plane held against the JAX package's.

The same tiny weights (f32, the reference's ``init_params`` converted) and
the same seeded tenant traffic go through both sides' ``ShardedBatcher``
with per-shard prefix pools: after every step the rows each request
routes to, the sticky tenant homes, the pools' hits, misses, installs and
residency, the counters and the replies agree (exactly: routing is host
bookkeeping, and the f32 replies come from the same greedy trajectories).
A spill to a foreign shard pays one install and leaves the home in place;
``sticky_imbalance`` and ``sticky=False`` yield as the reference does.
The ``ContinuousWorker`` on ``shards=2`` runs the reference's flood
episodes (fair admission, the ladder) to the same replies and admission
state, the tenant homes round-trip through the admission state, and the
``ShardedWorkerPool`` with tenancy answers every request once through a
quarantine, as the reference's pool does.  The reference's
``test_admission.py`` sticky-routing tests are mirrored by name.
"""

import json

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu.fleet import ShardedWorkerPool as JaxShardedPool
from kube_sqs_autoscaler_tpu.sim import faults as jax_faults
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch.fleet import ShardedWorkerPool
from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
from kube_sqs_autoscaler_tpu_torch.workloads import shard_plane, tenancy
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary

from .test_torch_prefix_pool import jitted_reference_prefill  # noqa: F401
from .test_torch_quantize import tokens
from .test_torch_tenant_serving import (
    EPISODES, PREFIX, PROMPT, REPLIES, SIDES, TOKENS, admit, config,
    flood_schedule, send, snapshot, step_both, traffic, worker_episode,
)

SHARDS, SLOTS = 2, 2


def both_planes(family, quantized=False, block=2, **tenancy_kw):
    kw = dict(tenants=("a", "b", "c", "d"), prefix_pool=SLOTS,
              prefix_len=PREFIX)
    kw.update(tenancy_kw)
    planes = []
    for side, module in zip(SIDES, (shard_plane, jax_plane)):
        cfg, params = side.model(family)
        planes.append(module.ShardedBatcher(
            params, cfg, shards=SHARDS, shard_slots=SLOTS, prompt_len=PROMPT,
            generate_tokens=TOKENS, family=family, quantized_kv=quantized,
            decode_block=block, tenancy=side.tenancy.TenancyConfig(**kw),
            **side.device))
    return planes


@pytest.mark.parametrize("family,quantized,block", [
    ("gpt", False, 2), ("llama", False, 2), ("gpt", True, 1),
], ids=["gpt", "llama", "gpt-int8-b1"])
def test_sticky_plane_matches_the_reference_after_every_step(
        family, quantized, block):
    planes = both_planes(family, quantized, block)
    waiting = [(t, p, ids, i) for i, (t, p, ids)
               in enumerate(traffic(family, 14, seed=17))]
    results = {}
    for step in range(160):
        free = planes[0]._free_slot_count()
        if waiting and free and step % 2 == 0:
            take = waiting[:min(free, 3)]
            waiting = waiting[len(take):]
            rows = [admit(p, take) for p in planes]
            assert rows[0] == rows[1], f"step {step}"
        step_both(planes, results, f"step {step}")
        assert list(planes[0]._tenant_home.items()) == \
            list(planes[1]._tenant_home.items()), f"step {step}"
        assert planes[0].shard_tokens == planes[1].shard_tokens
        if not waiting and planes[0].active == 0:
            break
    assert sorted(results) == list(range(14))
    pool = planes[0].prefix_pool
    assert pool.hits > 0 and pool.installs >= len(planes[0]._tenant_home)
    assert planes[0].export_tenant_homes() == \
        planes[1].export_tenant_homes()


def sticky_run(module_side, sticky, imbalance, n, seed):
    """Admit ``n`` requests of one tenant, one at a time, on an empty
    2-shard plane; returns (rows, hits, installs, home)."""
    side, module = module_side
    cfg, params = side.model("gpt")
    plane = module.ShardedBatcher(
        params, cfg, shards=SHARDS, shard_slots=SLOTS, prompt_len=PROMPT,
        generate_tokens=TOKENS, decode_block=2,
        tenancy=side.tenancy.TenancyConfig(
            tenants=("a", "b"), prefix_pool=SLOTS, prefix_len=PREFIX,
            sticky=sticky, sticky_imbalance=imbalance), **side.device)
    rng = np.random.default_rng(seed)
    prefix = tokens("gpt", 1, PREFIX, seed=seed)[0]
    rows = [plane.submit_many_prefixed([
        ("a", prefix, rng.integers(1, 64, PROMPT), i)])[0]
        for i in range(n)]
    pool = plane.prefix_pool
    return ([r // SLOTS for r in rows], pool.hits, pool.installs,
            dict(plane._tenant_home))


SIDE_MODULES = list(zip(SIDES, (shard_plane, jax_plane)))


def both_sticky(sticky, imbalance, n, seed):
    port, reference = (sticky_run(sm, sticky, imbalance, n, seed)
                       for sm in SIDE_MODULES)
    assert port == reference
    return port


def test_sticky_routing_keeps_tenant_on_home_shard():
    shards, hits, installs, homes = both_sticky(True, 0, 3, seed=23)
    # home first (lowest shard), home again under the auto threshold, then
    # a spill to the freest shard when home is full: one foreign install,
    # and the home stays where it was
    assert shards == [0, 0, 1]
    assert installs == 2 and hits == 1
    assert list(homes.values()) == [0]


def test_freest_routing_scatters_and_reinstalls():
    shards, hits, installs, homes = both_sticky(False, 0, 2, seed=29)
    assert set(shards) == {0, 1}
    assert installs == 2 and hits == 0 and homes == {}


def test_sticky_imbalance_threshold_controls_yield():
    shards, _, _, _ = both_sticky(True, 1, 2, seed=31)
    assert shards == [0, 1]  # 2 free vs 1: a lead of 1 yields


def test_prefix_pool_partitions_are_per_shard():
    out = []
    for side in SIDES:
        cfg, params = side.model("gpt")
        pool = side.tenancy.PrefixPool(params, cfg, entries=1,
                                       prefix_len=PREFIX, shards=2,
                                       **side.device)
        prefix = tokens("gpt", 1, PREFIX, seed=3)[0]
        key = side.tenancy.prefix_pool_key("a", prefix)
        rows = [pool.acquire(0, key, prefix), pool.acquire(1, key, prefix)]
        out.append((rows, pool.installs, pool.stats()["resident"]))
    assert out[0] == out[1]
    rows, installs, resident = out[0]
    assert rows[0] != rows[1] and installs == 2 and resident == [1, 1]


def test_tenant_home_map_is_lru_capped_as_the_reference():
    planes = both_planes("gpt")
    keys = [(f"t{i}", i) for i in range(4100)]
    for plane in planes:
        for i, key in enumerate(keys):
            plane._route_prefixed([key])
            if i % 97 == 0:
                plane._route_prefixed([keys[0]])  # keep t0 hot
    homes = [list(p._tenant_home.items()) for p in planes]
    assert homes[0] == homes[1]
    assert len(homes[0]) == 4096 and keys[0] in dict(homes[0])


@pytest.mark.parametrize("family,episode", [
    ("gpt", "drr"), ("llama", "drr"), ("gpt", "ladder"), ("gpt", "fifo"),
])
def test_plane_worker_episode_matches_the_reference(family, episode):
    kw = dict(EPISODES[episode], prefix_pool=2, prefix_len=PREFIX)
    schedule = flood_schedule(family, 30, seed=43)
    runs = [worker_episode(side, family, kw, schedule, 80,
                           service_kw=dict(shards=SHARDS)) for side in SIDES]
    (port, trace, replies), (reference, ref_trace, ref_replies) = runs
    for cycle, (got, want) in enumerate(zip(trace, ref_trace)):
        assert got == want, f"cycle {cycle}"
    assert replies == ref_replies and None not in replies
    assert isinstance(port.batcher, shard_plane.ShardedBatcher)
    state = port.export_admission_state()
    assert state == reference.export_admission_state()
    assert port.batcher.prefix_pool.stats() == \
        reference.batcher.prefix_pool.stats()
    if episode != "fifo":
        assert state["homes"]["records"] > 0
        # the homes come back into a fresh plane worker
        fresh = worker_episode(SIDES[0], family, kw, {}, 0,
                               service_kw=dict(shards=SHARDS))[0]
        assert fresh.import_admission_state(json.loads(json.dumps(state))) \
            > 0
        assert fresh.batcher._tenant_home == port.batcher._tenant_home


def pool_run(side, pool_cls, plan_cls, schedule, cycles):
    clock = side.Clock(1000.0)
    queue, results = side.Queue(now_fn=clock.now), side.Queue(
        now_fn=clock.now)
    cfg, params = side.model("gpt")
    pool = pool_cls.serving(
        queue, params, cfg, config(side, result_queue_url=REPLIES),
        min=3, max=3, shards=3, result_queue=results, now_fn=clock.now,
        tenancy=side.tenancy.TenancyConfig(
            tenants=("v0", "v1", "flood"), prefix_pool=2, prefix_len=PREFIX),
        clock=clock, **side.device)
    plan = plan_cls(shard_poisons=((6, 9, 0),))
    sent, log = [], []
    for cycle in range(cycles):
        for tenant, ids, prefix in schedule.get(cycle, ()):
            sent.append(send(queue, tenant, ids, prefix))
        plan.apply(cycle, pool)
        pool.run_cycle()
        log.append((pool.processed, list(pool.shard_states),
                    pool.rows_evacuated_total, pool.released_total))
        clock.advance(0.25)
    replies, duplicates = side.service.collect_replies(results, REPLIES)
    return pool, sent, replies, duplicates, log


def test_sharded_pool_with_tenancy_quarantines_exactly_once():
    schedule = flood_schedule("gpt", 24, seed=47)
    (port, sent, replies, dup, log), (ref, _, ref_replies, _, ref_log) = [
        pool_run(side, pool_cls, plan_cls, schedule, 70)
        for side, pool_cls, plan_cls in (
            (SIDES[0], ShardedWorkerPool, FleetFaultPlan),
            (SIDES[1], JaxShardedPool, jax_faults.FleetFaultPlan))]
    assert log == ref_log
    assert port.quarantined_total >= 1
    assert set(replies) == set(sent) and dup == 0  # exactly once
    strip = lambda r: {m: {k: v for k, v in p.items() if k != "request_id"}
                       for m, p in r.items()}
    assert strip(replies) == strip(ref_replies)
    assert port.completed_by_tenant == ref.completed_by_tenant
    state = port.export_state()
    assert state["admission"] == ref.export_state()["admission"]
    assert state["admission"]["homes"]["records"] > 0


def test_binary_serves_tenants_on_the_plane():
    summary = binary(["--device", "cpu", "--demo", "6", "--seq-len", "8",
                      "--generate-tokens", "3", "--batch-size", "2",
                      "--continuous", "--decode-block", "2", "--tenants",
                      "a,b", "--shards", "2", "--prefix-pool", "2",
                      "--result-queue-url", "demo://replies"])
    assert summary["processed"] == 6 and len(summary["replies"]) == 6
    assert summary["completed_by_tenant"] == {"a": 6}
    assert summary["gang_cycles"] > 0
