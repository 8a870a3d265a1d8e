"""The fleet pools over a ``(data, model)`` serving mesh, held against the
JAX package's pools on its virtual 8-device CPU mesh.

2 and 4 gloo ranks (``torch_mesh_ranks.py``, the ``fleet`` and ``worker``
jobs of ``torch_serve_ranks.py``), the tiny f32 GPT of
``test_torch_quantize`` with the reference's weights.  A deterministic
episode (the real ``ControlLoop`` over ``WorkerPool.serving(mesh=)`` on a
``FakeClock``, a kill at a known cycle) answers every body once, by rank
0, with the reference's reply bytes, replica trajectory and pool events;
so do a ``ShardedWorkerPool`` and a tenant fleet gated on the SLO-weighted
backlog.  The worker binary's ``--fleet-max-replicas --model-parallel 2
--demo`` answers every body once with one process's replies, and only
world rank 0 writes the journal and serves ``/metrics``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu.core.clock import FakeClock as JaxClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as JaxLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as JaxLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as JaxPolicy
from kube_sqs_autoscaler_tpu.fleet import FleetDriver as JaxDriver
from kube_sqs_autoscaler_tpu.fleet import ShardedWorkerPool as JaxSharded
from kube_sqs_autoscaler_tpu.fleet import WorkerPool as JaxPool
from kube_sqs_autoscaler_tpu.forecast.tenants import (
    TenantAwareDepth as JaxTenantDepth,
)
from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.metrics.queue import (
    QueueMetricSource as JaxSource,
)
from kube_sqs_autoscaler_tpu.sim.faults import FleetFaultPlan as JaxPlan
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu.workloads.service import (
    ServiceConfig as JaxService,
)
from kube_sqs_autoscaler_tpu.workloads.service import (
    collect_replies as jax_collect,
)

from .test_torch_quantize import weights
from .test_torch_serve_mesh import jax_mesh
from .torch_mesh_ranks import run_ranks
from .torch_serve_ranks import (
    FLEET_QUEUE, FLEET_RESULTS, fleet_episode, worker_summary,
)

KILL = (6, 1)  # replica 1 killed at cycle 6, while it holds requests
TENANCY = dict(tenants=("a", "b"), ttft_slo_s=(0.25, 4.0))


def bodies(n: int, seed: int = 5, tenants: bool = False) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(1, 90, int(rng.integers(2, 8))).tolist()
        out.append({"tenant": ("a", "b")[i % 3 == 2], "ids": ids}
                   if tenants else ids)
    return out


# episode name -> (ranks, tp, episode knobs)
EPISODES = {
    "pool-kill-dp2-tp2": (4, 2, dict(bodies=bodies(12), kill=KILL)),
    "pool-kill-tp2": (2, 2, dict(bodies=bodies(12), kill=KILL)),
    "sharded-dp2-tp2": (4, 2, dict(bodies=bodies(12), sharded=True)),
    "tenants-dp2-tp2": (4, 2, dict(bodies=bodies(12, tenants=True),
                                   tenancy=TENANCY)),
}


def reference_episode(*, bodies, world, tp, sharded=False, tenancy=None,
                      kill=None, batch=2, seq_len=8, tokens=5, block=2,
                      shards=2):
    """The reference's counterpart of ``fleet_episode`` on its virtual
    mesh of ``world`` devices."""
    jcfg, jp, _, _ = weights("gpt")
    clock = JaxClock()
    queue = JaxQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = JaxQueue(now_fn=clock.now)
    sent = [queue.send_message(FLEET_QUEUE, json.dumps(body))
            for body in bodies]
    service = JaxService(queue_url=FLEET_QUEUE, batch_size=batch,
                         seq_len=seq_len, generate_tokens=tokens,
                         decode_block=block, result_queue_url=FLEET_RESULTS)
    if tenancy is not None:
        tenancy = jax_tenancy.TenancyConfig(**tenancy)
    common = dict(result_queue=results, min=1, clock=clock,
                  mesh=jax_mesh(tp, world), tenancy=tenancy)
    if sharded:
        pool = JaxSharded.serving(queue, jp, jcfg, service, max=shards,
                                  shards=shards, now_fn=clock.now, **common)
    else:
        pool = JaxPool.serving(queue, jp, jcfg, service, max=3,
                               drain_timeout_cycles=200, **common)
    loop = JaxLoop(
        pool,
        JaxSource(queue, FLEET_QUEUE, ("ApproximateNumberOfMessages",)),
        JaxLoopConfig(poll_interval=1.0, policy=JaxPolicy(
            scale_up_messages=4, scale_down_messages=1,
            scale_up_cooldown=1.0, scale_down_cooldown=2.0)),
        clock=clock,
        depth_policy=(JaxTenantDepth(pool.staged_by_tenant, tenancy)
                      if tenancy is not None else None),
    )
    plan = JaxPlan(kills=(kill,) if kill else ())
    stats = JaxDriver(pool, loop, cycle_dt=0.5, fault_plan=plan).run(
        max_cycles=400, until=lambda: (
            pool.processed >= len(bodies) and pool.idle
            and pool.replicas == pool.min))
    replies, duplicates = jax_collect(results, FLEET_RESULTS)
    return {"sent": sent, "replies": replies, "duplicates": duplicates,
            "processed": pool.processed,
            "trajectory": stats["replica_trajectory"],
            "events": [(e.name, e.t, e.args) for e in pool.events]}


FLEET_ARGS = ["--device", "cpu", "--demo", "12", "--seq-len", "8",
              "--generate-tokens", "3", "--batch-size", "2",
              "--continuous", "--decode-block", "2",
              "--fleet-max-replicas", "3",
              "--result-queue-url", "demo://replies"]
MESH_ARGS = ["--model-parallel", "2"]
# the binary's fleets over the mesh, in f32 (their own seeded weights)
BINARY = {
    "fleet": [],
    "fleet-tenants": ["--tenants", "a,b", "--tenant-slos", "0.25,4"],
}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


_done: dict = {}


def port(world: int, name: str):
    """Every rank's result of job ``name`` over ``world`` ranks (one rank
    call for all of a world's jobs)."""
    if world not in _done:
        _, _, tcfg, tp = weights("gpt")
        jobs, names = [], []
        for episode, (ranks, tp_size, knobs) in EPISODES.items():
            if ranks == world:
                jobs.append(dict(kind="fleet", tp=tp_size, config=tcfg,
                                 params=tp, episode=knobs))
                names.append(episode)
        if world == 4:
            import tempfile

            journal = tempfile.mktemp(prefix="fleet-mesh-", suffix=".jsonl")
            for binary, extra in BINARY.items():
                jobs.append(dict(kind="worker", f32=True, argv=[
                    *FLEET_ARGS, *MESH_ARGS, *extra,
                    "--journal-path", journal,
                    "--metrics-port", str(free_port())]))
                names.append(binary)
        results = run_ranks("serve", world, {"jobs": jobs}, timeout=400)
        _done[world] = {key: [r[i] for r in results]
                        for i, key in enumerate(names)}
    return _done[world][name]


@pytest.mark.parametrize("name", list(EPISODES))
def test_fleet_over_the_mesh_is_the_references_fleet(name):
    world, tp, knobs = EPISODES[name]
    results = port(world, name)
    want = reference_episode(world=world, tp=tp, **knobs)
    lead = results[0]
    # every body answered once, by world rank 0, with the reference's
    # bytes; the replica trajectory and every pool event (its time on
    # the FakeClock and its args) are the reference's on every rank
    assert lead["sent"] == want["sent"]
    assert len(lead["replies"]) == len(knobs["bodies"])
    assert lead["duplicates"] == 0
    assert lead["replies"] == want["replies"]
    for r in results:
        assert r["processed"] == len(knobs["bodies"])
        assert r["trajectory"] == want["trajectory"]
        assert r["events"] == want["events"]
    assert all(r["replies"] == {} for r in results[1:])
    if knobs.get("kill"):
        kills = [e for e in want["events"] if e[0] == "replica-kill"]
        assert [e[2]["cause"] for e in kills] == ["killed"]
        assert kills[0][2]["redispatched"] > 0


def test_fleet_episode_of_one_process_is_the_references():
    # the same episode without a mesh, the baseline of the ranks' runs
    world, tp, knobs = EPISODES["pool-kill-dp2-tp2"]
    _, _, tcfg, params = weights("gpt")
    got = fleet_episode(params, tcfg, **knobs)
    want = reference_episode(world=world, tp=tp, **knobs)
    assert (got["replies"], got["trajectory"], got["events"]) == (
        want["replies"], want["trajectory"], want["events"])


@pytest.mark.parametrize("binary", list(BINARY))
def test_binary_fleet_over_the_mesh_answers_once_from_rank_zero(binary):
    results = port(4, binary)
    lead = results[0]
    assert lead["mesh"] == {"data": 2, "seq": 1, "model": 2}
    assert all(r["processed"] == 12 for r in results)
    assert len(lead["replies"]) == 12 and lead["duplicate_replies"] == 0
    assert all(r["replies"] == {} for r in results[1:])
    # one journal and one /metrics server, both world rank 0's
    assert [r["journals"] for r in results] == [1, 0, 0, 0]
    assert [r["metrics_served"] for r in results] == [True, False, False,
                                                        False]
    # every rank took the same scaling decisions
    assert all(r["replica_trajectory"] == lead["replica_trajectory"]
               for r in results)
    one = worker_summary([*FLEET_ARGS, *BINARY[binary]], None, True)
    assert lead["replies"] == one["replies"]
