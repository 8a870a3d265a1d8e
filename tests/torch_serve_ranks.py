"""Rank programs of the port's serving-mesh tests (``test_torch_serve_mesh*``).

Run through ``torch_mesh_ranks.run_ranks("serve", world, payload)``: every
rank builds the meshes a job names, keeps its slices of the job's full
weights (``train.shard_params``) and runs the port's mesh serving entry
points on the job's global inputs.  Every rank returns its results, so a
test can check that the ranks agree.  This module imports torch and the
port only, never JAX.
"""

from __future__ import annotations

import torch

_MESHES: dict = {}


def mesh(tp: int, sp: int = 1):
    """The ``(data, seq, model)`` mesh of that shape over the world, built
    once per rank process (its groups are created collectively, in the
    order the jobs ask)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    key = (tp, sp)
    if key not in _MESHES:
        _MESHES[key] = distributed.make_mesh(model_parallel=tp,
                                             seq_parallel=sp, device="cpu")
    return _MESHES[key]


def _refusal(call) -> str | None:
    try:
        call()
    except ValueError as err:
        return str(err)
    return None


def generator(seed):
    return None if seed is None else torch.Generator().manual_seed(seed)


def job_generate(job):
    """The family's ``make_serving_fns``: each run of ``job["runs"]``
    (``(temperature, top_k, eos_id, seed)``) through the mesh generate,
    and the prefill and one decode step's logits."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode, llama

    m = mesh(job["tp"])
    config = job["config"]
    params = _rank_params(job, m)
    make = (llama.make_llama_serving_fns if job["family"] == "llama"
            else decode.make_serving_fns)
    prefill, step, gen = make(m, config, params,
                              quantized_cache=job.get("quantized", False),
                              prefix_cache=job.get("prefix_cache"))
    prompt, lengths = job["prompt"], job["lengths"]
    out = {"generate": [gen(params, prompt, generator(seed), lengths,
                            job["tokens"], temperature, top_k, 1.0, eos)
                        for temperature, top_k, eos, seed in job["runs"]]}
    if job.get("logits"):
        logits, cache = prefill(params, prompt)
        nxt = torch.argmax(logits, dim=-1)
        step_logits, _ = step(params, cache, nxt)
        out.update(prefill=logits, step=step_logits, next=nxt,
                   cache_heads=cache["layers"][0]["k"].shape[1],
                   cache_rows=cache["layers"][0]["k"].shape[0])
    return out


def _rank_params(job, m):
    from kube_sqs_autoscaler_tpu_torch.workloads import quantize, train

    params = job["params"]
    if job.get("int8_weights"):
        params = quantize.quantize_params(params, family=job["family"])
    return train.shard_params(params, m)


def job_refusals(job):
    """The factories' refusals: a seq axis, a prefix of the other
    layout."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode

    config, params = job["config"], job["params"]
    return {
        "seq": _refusal(lambda: decode.make_serving_fns(
            mesh(2, 2), config, params)),
        "layout": _refusal(lambda: decode.make_serving_fns(
            mesh(2), config, params, quantized_cache=True,
            prefix_cache=job["prefix_cache"])),
    }


def job_beam(job):
    from kube_sqs_autoscaler_tpu_torch.workloads import beam

    m = mesh(job["tp"])
    params = _rank_params(job, m)
    run = beam.make_beam_serving_fn(
        m, job["config"], params, beams=job["beams"],
        length_penalty=job.get("length_penalty", 0.0),
        eos_id=job.get("eos_id"), prefix_cache=job.get("prefix_cache"),
        quantized_cache=job.get("quantized", False))
    return {"tokens": run(params, job["prompt"], job["lengths"],
                          job["tokens"])}


def job_speculative(job):
    from kube_sqs_autoscaler_tpu_torch.workloads import speculative

    m = mesh(job["tp"])
    config = job["config"]
    params = _rank_params(job, m)
    draft_params, draft_config = speculative.self_draft(params, config,
                                                        job["draft_layers"])
    run = speculative.make_speculative_serving_fn(
        m, config, params, draft_config, draft_tokens=job["draft_tokens"],
        temperature=job.get("temperature", 0.0), eos_id=job.get("eos_id"),
        prefix_cache=job.get("prefix_cache"),
        quantized_cache=job.get("quantized", False))
    return {"tokens": run(params, draft_params, job["prompt"],
                          job["lengths"], generator(job.get("seed")),
                          job["tokens"])}


def job_forward(job):
    from kube_sqs_autoscaler_tpu_torch.workloads import llama, train

    m = mesh(job["tp"])
    params = _rank_params(job, m)
    fwd = train.make_forward_step(
        m, job["config"], params,
        forward_fn=llama.llama_forward if job["family"] == "llama" else None)
    return {"logits": fwd(params, job["prompt"])}


def job_batcher(job):
    """A continuous batcher (or the sharded plane with ``shards``) on the
    mesh draining ``job["requests"]``; returns each request's tokens and
    the engine's counters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import continuous, tenancy

    m = mesh(job["tp"])
    knobs = dict(job["knobs"])
    if knobs.get("tenancy") is not None:
        knobs["tenancy"] = tenancy.TenancyConfig(**knobs["tenancy"])
    params = _rank_params(job, m)
    if job.get("shards"):
        from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
            ShardedBatcher,
        )

        batcher = ShardedBatcher(params, job["config"], shards=job["shards"],
                                 shard_slots=job["slots"], mesh=m,
                                 device="cpu", **knobs)
    else:
        batcher = continuous.ContinuousBatcher(
            params, job["config"], batch_size=job["slots"], mesh=m,
            device="cpu", **knobs)
    results = drain(batcher, job["requests"], job.get("prefixes"))
    first = batcher.cache["layers"][0]
    first = first[next(iter(first))]
    return {"tokens": [results[i] for i in range(len(job["requests"]))],
            "decode_dispatches": batcher.decode_dispatches,
            "insert_dispatches": batcher.insert_dispatches,
            "cache_heads": first.shape[1], "cache_rows": first.shape[0],
            "lengths": batcher.cache["length"].shape[0]}


def drain(batcher, requests, prefixes=None):
    """Keep the slots full with ``requests`` (with ``prefixes``, the
    pooled path's ``(tenant, prefix)`` per request) and collect each
    one's tokens by index."""
    results, queue = {}, list(enumerate(requests))
    for _ in range(400):
        while queue and batcher.free_slots:
            if prefixes is None:
                idx, ids = queue.pop(0)
                batcher.submit(ids, payload=idx)
                continue
            take = min(len(queue), len(batcher.free_slots))
            batch, queue = queue[:take], queue[take:]
            batcher.submit_many_prefixed(
                [(prefixes[idx][0], prefixes[idx][1], ids, idx)
                 for idx, ids in batch])
        for idx, tokens in batcher.step():
            results[idx] = tokens
        if not queue and batcher.active == 0:
            break
    return results


def job_refused_batcher(job):
    """The batcher's and the plane's mesh refusals, the reference's
    words."""
    from kube_sqs_autoscaler_tpu_torch.workloads import continuous, tenancy
    from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
        ShardedBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.planes.engine import (
        DecodePlaneBatcher,
    )

    config, params = job["config"], job["params"]
    knobs = dict(prompt_len=4, generate_tokens=2, device="cpu")
    return {
        "rows": _refusal(lambda: continuous.ContinuousBatcher(
            params, config, batch_size=3, mesh=mesh(1), **knobs)),
        "seq": _refusal(lambda: continuous.ContinuousBatcher(
            params, config, batch_size=4, mesh=mesh(2, 2), **knobs)),
        "shards": _refusal(lambda: ShardedBatcher(
            params, config, shards=3, shard_slots=2, mesh=mesh(1), **knobs)),
        "spec_plane": _refusal(lambda: DecodePlaneBatcher(
            params, config, shards=2, shard_slots=2, spec_layers=1,
            mesh=mesh(1), **knobs)),
        "pool_heads": _refusal(lambda: continuous.ContinuousBatcher(
            job["llama_params"], job["llama_config"], batch_size=4,
            mesh=mesh(4),
            tenancy=tenancy.TenancyConfig(tenants=("a",), prefix_pool=4,
                                          prefix_len=4), **knobs)),
    }


def job_refused_pools(job):
    """The fleet pools over a mesh refuse what the mesh's engines refuse:
    slots or shards that do not divide over the data axis (4 ranks at tp
    1: data 4), with the engines' words."""
    import dataclasses

    from kube_sqs_autoscaler_tpu_torch.fleet import (
        ShardedWorkerPool, WorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    config, params = job["config"], job["params"]
    service = ServiceConfig(queue_url="q", batch_size=3, seq_len=4,
                            generate_tokens=2)
    return {
        "WorkerPool": _refusal(lambda: WorkerPool.serving(
            FakeMessageQueue(), params, config, service, min=1, max=2,
            device="cpu", mesh=mesh(1))),
        "ShardedWorkerPool": _refusal(lambda: ShardedWorkerPool.serving(
            FakeMessageQueue(), params, config,
            dataclasses.replace(service, batch_size=2), min=1, max=3,
            shards=3, device="cpu", mesh=mesh(1))),
    }


def job_worker(job):
    """The worker binary over the ranks, serving ``job["params"]`` (the
    full weights every rank starts from) in place of the built-in seeded
    ones, or its built-in models in f32 with ``job["f32"]``; every rank
    returns its summary (rank 0's holds the replies) and whether it
    started a ``/metrics`` server."""
    return worker_summary(job["argv"], job.get("params"), job.get("f32"))


def worker_summary(argv, params=None, f32=False):
    """The port's binary on ``argv`` with its weights replaced by
    ``params`` (``None``: the binary's own), its built-in models in f32
    with ``f32``: the summary's counts and replies, whether this rank
    served ``/metrics`` and how many flight journals it opened."""
    import dataclasses

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import _to_device

    from kube_sqs_autoscaler_tpu_torch import obs

    original = (binary.served_params, dict(binary.BUILTIN_CONFIGS),
                binary.serve_metrics, obs.TickJournal)
    servers, journals = [], []

    def serve_metrics(*args, **kwargs):
        server = original[2](*args, **kwargs)
        servers.append(server is not None)
        return server

    def tick_journal(*args, **kwargs):
        journals.append(args[0] if args else kwargs.get("path"))
        return original[3](*args, **kwargs)

    binary.serve_metrics = serve_metrics
    obs.TickJournal = tick_journal
    if params is not None:
        binary.served_params = (
            lambda args, config, layout, given, device: _to_device(params,
                                                                   device))
    if f32:
        for family, make in original[1].items():
            binary.BUILTIN_CONFIGS[family] = (
                lambda *a, _make=make: dataclasses.replace(
                    _make(*a), dtype=torch.float32))
    try:
        summary = binary.main(argv)
    finally:
        binary.served_params = original[0]
        binary.BUILTIN_CONFIGS.update(original[1])
        binary.serve_metrics = original[2]
        obs.TickJournal = original[3]
    return {"metrics_served": any(servers), "journals": len(journals),
            **{key: summary.get(key) for key in (
                "processed", "replies", "duplicate_replies", "mesh",
                "replica_trajectory", "completed_by_tenant")}}


FLEET_QUEUE, FLEET_RESULTS = "fleet-mesh://q", "fleet-mesh://r"


def fleet_episode(params, config, *, bodies, mesh=None, sharded=False,
                  tenancy=None, kill=None, batch=2, seq_len=8, tokens=5,
                  block=2, shards=2):
    """One deterministic fleet episode of the port: the real
    ``ControlLoop`` scaling ``WorkerPool.serving`` (``ShardedWorkerPool``
    with ``sharded``) over ``bodies`` on a ``FakeClock`` advanced half a
    second a cycle, replica ``kill[1]`` killed at cycle ``kill[0]``, the
    gates on the SLO-weighted tenant backlog with ``tenancy`` (the
    binary's wiring).  On a ``mesh`` the depth is read through
    ``RankQueue``, as the binary reads it.  Returns what a test compares:
    the sent ids, the replies (rank 0's), the trajectory and the pool's
    events."""
    import json

    from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
    from kube_sqs_autoscaler_tpu_torch.core.loop import (
        ControlLoop, LoopConfig,
    )
    from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
    from kube_sqs_autoscaler_tpu_torch.fleet import (
        FleetDriver, ShardedWorkerPool, WorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.forecast.tenants import (
        TenantAwareDepth,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.metrics.queue import QueueMetricSource
    from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
    from kube_sqs_autoscaler_tpu_torch.workloads.distributed import RankQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        ServiceConfig, collect_replies,
    )

    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    sent = [queue.send_message(FLEET_QUEUE, json.dumps(body))
            for body in bodies]
    service = ServiceConfig(queue_url=FLEET_QUEUE, batch_size=batch,
                            seq_len=seq_len, generate_tokens=tokens,
                            decode_block=block,
                            result_queue_url=FLEET_RESULTS)
    common = dict(result_queue=results, min=1, clock=clock, device="cpu",
                  mesh=mesh, tenancy=tenancy)
    if sharded:
        pool = ShardedWorkerPool.serving(queue, params, config, service,
                                         max=shards, shards=shards,
                                         now_fn=clock.now, **common)
    else:
        pool = WorkerPool.serving(queue, params, config, service, max=3,
                                  drain_timeout_cycles=200, **common)
    depth = RankQueue(queue) if mesh is not None else queue
    loop = ControlLoop(
        pool,
        QueueMetricSource(depth, FLEET_QUEUE,
                          ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=1.0, policy=PolicyConfig(
            scale_up_messages=4, scale_down_messages=1,
            scale_up_cooldown=1.0, scale_down_cooldown=2.0)),
        clock=clock,
        depth_policy=(TenantAwareDepth(pool.staged_by_tenant, tenancy)
                      if tenancy is not None else None),
    )
    plan = FleetFaultPlan(kills=(kill,) if kill else ())
    driver = FleetDriver(pool, loop, cycle_dt=0.5, fault_plan=plan)
    stats = driver.run(max_cycles=400, until=lambda: (
        pool.processed >= len(bodies) and pool.idle
        and pool.replicas == pool.min))
    replies, duplicates = collect_replies(results, FLEET_RESULTS)
    return {"sent": sent, "replies": replies, "duplicates": duplicates,
            "processed": pool.processed,
            "trajectory": stats["replica_trajectory"],
            "events": [(e.name, e.t, e.args) for e in pool.events]}


def job_fleet(job):
    """:func:`fleet_episode` on the mesh, every rank keeping its slices of
    ``job["params"]``."""
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import TenancyConfig

    m = mesh(job["tp"])
    tenancy = job["episode"].get("tenancy")
    episode = dict(job["episode"],
                   tenancy=TenancyConfig(**tenancy) if tenancy else None)
    return fleet_episode(_rank_params(job, m), job["config"], mesh=m,
                         **episode)


JOBS = {"generate": job_generate, "refusals": job_refusals,
        "beam": job_beam, "speculative": job_speculative,
        "forward": job_forward, "batcher": job_batcher,
        "refused_batcher": job_refused_batcher, "worker": job_worker,
        "fleet": job_fleet, "refused_pools": job_refused_pools}


def case_serve(payload):
    """Every job of ``payload["jobs"]`` (``{"kind": ..., ...}``) in order;
    a list of their results."""
    return [JOBS[job["kind"]](job) for job in payload["jobs"]]
