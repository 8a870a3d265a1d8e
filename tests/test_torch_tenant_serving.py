"""Multi-tenant serving in the port held against the JAX package's.

The continuous batcher with tenancy and the per-tenant prefix pool (both
families, full and int8 cache, decode blocks 1 and 4) runs the same
tenant traffic as the reference's batcher: the results, the per-tenant
kept tokens and TTFT counts, the pool's counters and the dispatch and
transfer counters agree after every step.  A degraded row that finishes
before its device budget is quiesced and kept out of admission until the
block in flight settles, as in the reference, and a request admitted into
it gets a fresh row's result.  The ``ContinuousWorker`` over
``FakeMessageQueue`` on a ``FakeClock`` (fair admission, the overload
ladder, the decode deadline, the admission-state round trip) replies,
sheds and counts as the reference worker does.  Pooled replies equal the
plain path's over the prefix-prepended prompt, and one default tenant
serves as the plain path.  The binary's tenancy flags fail with the
reference's messages, the still-unported combinations name their ROADMAP
item, the fleet evacuates staged messages and counts completions per
tenant, and the tenant gauges render.  All f32, on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.core import FakeClock as JaxClock
from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.obs.prometheus import (
    WorkloadMetrics as JaxMetrics,
)
from kube_sqs_autoscaler_tpu.workloads import __main__ as jax_binary
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch.core import FakeClock
from kube_sqs_autoscaler_tpu_torch.fleet import (
    FleetDriver, ShardedWorkerPool, WorkerPool,
)
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.obs import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.workloads import (
    continuous, service, tenancy,
)
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
    ShardedBatcher,
)

from .test_torch_prefix_pool import jitted_reference_prefill  # noqa: F401
from .test_torch_quantize import tokens, weights

torch.set_num_threads(1)

PREFIX, PROMPT, TOKENS = 8, 12, 6
URL, REPLIES = "t://q", "t://r"
TENANTS = ("a", "b", "c", "d")


class Side:
    """One side's classes: the port's or the reference's."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.tenancy = tenancy if port else jax_tenancy
        self.service = service if port else jax_service
        self.continuous = continuous if port else jax_continuous
        self.Clock = FakeClock if port else JaxClock
        self.Queue = FakeMessageQueue if port else JaxQueue
        self.device = {"device": "cpu"} if port else {}

    def model(self, family, quantized=False):
        """(config, params) of the family's test model; quantized: int8
        weights converted from the reference's."""
        jcfg, jp, tcfg, tp = weights(family, int8=quantized)
        return (tcfg, tp) if self.port else (jcfg, jp)


SIDES = (Side(True), Side(False))


def traffic(family, n: int, seed: int):
    """``n`` requests ``(tenant, prefix or None, ids)``: four tenants, one
    pool-length prefix each (one tenant sends plain bodies now and then)."""
    rng = np.random.default_rng(seed)
    prefixes = {t: tokens(family, 1, PREFIX, seed=seed + 50 + i)[0]
                for i, t in enumerate(TENANTS)}
    out = []
    for i in range(n):
        tenant = TENANTS[int(rng.integers(0, len(TENANTS)))]
        ids = tokens(family, 1, int(rng.integers(2, PROMPT + 1)),
                     seed=seed + 100 + i)[0]
        prefix = None if tenant == "d" and i % 2 else prefixes[tenant]
        out.append((tenant, prefix, ids))
    return out


def admit(batcher, requests):
    """Admit ``(tenant, prefix, ids, payload)`` as the worker does: the
    prefixed ones through the pool, the rest plainly and tagged."""
    prefixed = [r for r in requests if r[1] is not None]
    plain = [r for r in requests if r[1] is None]
    rows = batcher.submit_many_prefixed(prefixed) if prefixed else []
    if plain:
        plain_rows = batcher.submit_many([(ids, p) for _, _, ids, p in plain])
        batcher.tag_tenant(plain_rows, [t for t, _, _, _ in plain])
        rows += plain_rows
    return rows


BATCHER_COUNTERS = ("insert_dispatches", "decode_dispatches",
                    "host_transfers", "tokens_emitted", "ttft_count",
                    "tenant_tokens", "tenant_ttft_count", "free_slots")


def snapshot(batcher):
    out = {name: getattr(batcher, name) for name in BATCHER_COUNTERS}
    out["pool"] = batcher.prefix_pool.stats()
    out["tainted"] = sorted(batcher._tainted)
    return out


def step_both(batchers, results, where):
    done = [{p: np.asarray(t).tolist() for p, t in b.step()}
            for b in batchers]
    assert done[0] == done[1], where
    results.update(done[0])
    assert snapshot(batchers[0]) == snapshot(batchers[1]), where


def both_batchers(family, quantized=False, block=1, entries=3, **extra):
    knobs = dict(batch_size=3, prompt_len=PROMPT, generate_tokens=TOKENS,
                 family=family, quantized_kv=quantized, decode_block=block,
                 **extra)
    return [side.continuous.ContinuousBatcher(
        *side.model(family)[::-1], tenancy=side.tenancy.TenancyConfig(
            tenants=TENANTS, prefix_pool=entries, prefix_len=PREFIX),
        **knobs, **side.device) for side in SIDES]


@pytest.mark.parametrize("family,quantized,block", [
    ("gpt", False, 1), ("gpt", False, 4), ("llama", False, 1),
    ("llama", False, 4), ("gpt", True, 4), ("llama", True, 1),
], ids=["gpt-b1", "gpt-b4", "llama-b1", "llama-b4", "gpt-int8-b4",
        "llama-int8-b1"])
def test_pooled_batcher_matches_the_reference_after_every_step(
        family, quantized, block):
    batchers = both_batchers(family, quantized, block)
    waiting = [(t, p, ids, i) for i, (t, p, ids)
               in enumerate(traffic(family, 9, seed=7))]
    results = {}
    for step in range(120):
        free = len(batchers[0].free_slots)
        if waiting and free and step % 2 == 0:
            take = waiting[:min(free, 2)]
            waiting = waiting[len(take):]
            rows = [admit(b, take) for b in batchers]
            assert rows[0] == rows[1], f"step {step}"
        step_both(batchers, results, f"step {step}")
        if not waiting and batchers[0].active == 0:
            break
    assert sorted(results) == list(range(9))
    port = batchers[0]
    assert port.prefix_pool.evictions > 0 and port.prefix_pool.hits > 0
    assert sum(port.tenant_tokens.values()) == 9 * TOKENS
    assert port.insert_dispatches >= len(port.tenant_tokens)


def test_quiesced_rows_match_the_reference_and_serve_fresh():
    """Rows whose budget the overload ladder cut finish early on the host:
    quiesced on the device, kept out of admission until the block in
    flight settles, then reused with a fresh row's result."""
    batchers = both_batchers("gpt", block=4)
    requests = [(t, p, ids, i) for i, (t, p, ids)
                in enumerate(traffic("gpt", 6, seed=9))]
    for b in batchers:
        admit(b, requests[:3])
        for slot in b.slots:  # tier 1 cuts two requests' budgets
            if slot.payload in (0, 2):
                slot.budget = 2
                slot.degraded = True
    results, tainted_seen = {}, False
    waiting = requests[3:]
    for step in range(60):
        free = len(batchers[0].free_slots)
        if waiting and free:
            take = waiting[:free]
            waiting = waiting[free:]
            assert [admit(b, take) for b in batchers][0] is not None
        step_both(batchers, results, f"step {step}")
        tainted_seen |= bool(batchers[0]._tainted)
        if not waiting and batchers[0].active == 0 \
                and not batchers[0]._tainted:
            break
    assert tainted_seen and sorted(results) == list(range(6))
    assert len(results[0]) == len(results[2]) == 2
    for i in range(3, 6):  # the reused rows' results, against fresh rows
        fresh = both_batchers("gpt", block=4)[0]
        admit(fresh, [requests[i]])
        alone = {}
        while fresh.active:
            alone.update({p: np.asarray(t).tolist() for p, t in fresh.step()})
        assert alone[i] == results[i]


def test_batcher_checks_fail_as_the_reference():
    for side in SIDES:
        model_cfg, params = side.model("gpt")
        cfg = side.tenancy.TenancyConfig(tenants=("a",), prefix_pool=1,
                                         prefix_len=PREFIX)
        kw = dict(prompt_len=PROMPT, generate_tokens=TOKENS, **side.device)
        with pytest.raises(ValueError, match="must be >= the per-shard slot"):
            side.continuous.ContinuousBatcher(params, model_cfg, 2, tenancy=cfg,
                                              **kw)
        with pytest.raises(ValueError, match="plain continuous decode"):
            side.continuous.ContinuousBatcher(params, model_cfg, 1, tenancy=cfg,
                                              beams=2, **kw)
        with pytest.raises(ValueError, match="prefix_len must be >= 1"):
            side.continuous.ContinuousBatcher(
                params, model_cfg, 1, tenancy=dataclasses.replace(
                    cfg, prefix_len=0), **kw)
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            side.continuous.ContinuousBatcher(
                params, model_cfg, 1, tenancy=dataclasses.replace(
                    cfg, prefix_len=model_cfg.max_seq_len - PROMPT), **kw)
        plain = side.continuous.ContinuousBatcher(params, model_cfg, 1, **kw)
        with pytest.raises(ValueError, match="needs tenancy"):
            plain.submit_many_prefixed([("a", np.arange(PREFIX), [1], 0)])
    _, _, tcfg, tp = weights("gpt")
    cfg = tenancy.TenancyConfig(tenants=("a",), prefix_pool=2,
                                prefix_len=PREFIX)
    prefix = continuous.family_of(tcfg).full.prefill_prefix(
        tp, torch.arange(3), tcfg, None)
    with pytest.raises(ValueError, match="mutually exclusive"):
        continuous.ContinuousBatcher(tp, tcfg, 2, PROMPT, TOKENS,
                                     tenancy=cfg, prefix_cache=prefix,
                                     device="cpu")
    # tenancy on the sharded plane, with speculative slots (the decode
    # plane) and with admission shards is ported: each combination builds
    plane = ShardedBatcher(tp, tcfg, shards=2, shard_slots=1,
                           prompt_len=PROMPT, generate_tokens=TOKENS,
                           tenancy=cfg, device="cpu")
    assert plane.prefix_pool.stats()["resident"] == [0, 0]
    pool = ShardedWorkerPool.serving(
        FakeMessageQueue(), tp, tcfg, config(result_queue_url=""), min=1,
        max=2, tenancy=cfg, device="cpu")
    assert pool.worker.tenancy is cfg
    worker = continuous.ContinuousWorker(
        FakeMessageQueue(), tp, tcfg, config(shards=2, result_queue_url=""),
        tenancy=cfg, device="cpu")
    assert worker.batcher.shards == 2
    worker = continuous.ContinuousWorker(
        FakeMessageQueue(), tp, tcfg, config(result_queue_url=""),
        tenancy=cfg, draft_layers=1, device="cpu")
    assert type(worker.batcher).__name__ == "DecodePlaneBatcher"
    assert worker.batcher.shards == 1
    worker = continuous.ContinuousWorker(
        FakeMessageQueue(), tp, tcfg, config(result_queue_url=""),
        device="cpu", tenancy=tenancy.TenancyConfig(tenants=("a",),
                                                    admission_shards=2))
    assert type(worker._fair).__name__ == "ShardedAdmission"


# -- the worker on a FakeClock -------------------------------------------------


def config(side=SIDES[0], **overrides):
    base = dict(queue_url=URL, batch_size=2, seq_len=PROMPT,
                generate_tokens=TOKENS, decode_block=2,
                result_queue_url=REPLIES)
    base.update(overrides)
    return side.service.ServiceConfig(**base)


def send(queue, tenant, ids, prefix=None):
    payload = {"tenant": tenant, "ids": np.asarray(ids).tolist()}
    if prefix is not None:
        payload["prefix"] = np.asarray(prefix).tolist()
    return queue.send_message(URL, json.dumps(payload))


def flood_schedule(family, cycles: int, seed: int, flood_per_cycle: int = 3,
                   pooled: bool = True):
    """cycle -> sends: tenant "flood" sends ``flood_per_cycle`` a cycle over
    cycles [2, 8), "v0" and "v1" one every 3 cycles, each tenant with its
    own pool-length prefix (``pooled``)."""
    prefixes = {t: tokens(family, 1, PREFIX, seed=seed + i)[0]
                for i, t in enumerate(("flood", "v0", "v1"))}
    out, n = {}, 0
    for cycle in range(cycles):
        sends = []
        if 2 <= cycle < 8:
            sends += ["flood"] * flood_per_cycle
        sends += [v for k, v in enumerate(("v0", "v1"))
                  if cycle % 3 == k and cycle < cycles - 12]
        out[cycle] = [(t, tokens(family, 1, 3 + (n + i) % 8,
                                 seed=seed + 200 + n + i)[0],
                       prefixes[t] if pooled else None)
                      for i, t in enumerate(sends)]
        n += len(sends)
    return out


def worker_episode(side, family, tenancy_kw, schedule, cycles, dt=0.25,
                   service_kw=None, state=None):
    clock = side.Clock(1000.0)
    queue, results = side.Queue(now_fn=clock.now), side.Queue(
        now_fn=clock.now)
    cfg, params = side.model(family)
    worker = side.continuous.ContinuousWorker(
        queue, params, cfg, config(side, **(service_kw or {})),
        result_queue=results, now_fn=clock.now, family=family,
        tenancy=side.tenancy.TenancyConfig(**tenancy_kw), **side.device)
    if state is not None:
        worker.import_admission_state(state)
    sent, trace = [], []
    for cycle in range(cycles):
        for tenant, ids, prefix in schedule.get(cycle, ()):
            sent.append(send(queue, tenant, ids, prefix))
        done = worker.run_once()
        trace.append((done, worker.staged, dict(worker.shed_by_reason),
                      worker.ladder.tier if worker.ladder else None,
                      sorted(worker._degrade_tenants),
                      [(s.tenant, s.budget) for s in worker.batcher.slots
                       if s.busy],
                      worker.batcher.insert_dispatches,
                      worker.batcher.decode_dispatches,
                      worker.batcher.host_transfers))
        clock.advance(dt)
    replies, duplicates = side.service.collect_replies(results, REPLIES)
    assert duplicates == 0
    answered = [{k: v for k, v in replies[mid].items() if k != "request_id"}
                if mid in replies else None for mid in sent]
    return worker, trace, answered


EPISODES = {
    "drr": dict(tenants=("v0", "v1", "flood")),
    "weighted-edf": dict(tenants=("v0", "v1", "flood"),
                         weights=(2.0, 2.0, 1.0), ttft_slo_s=(0.5, 0.5, 0.0),
                         urgency_window_s=0.5),
    "fifo": dict(tenants=("v0", "v1", "flood"), fair=False),
    "ladder": dict(tenants=("v0", "v1", "flood"), shed_tiers=3),
    "ladder-tier1": dict(tenants=("v0", "v1", "flood"), shed_tiers=1),
    "decode-deadline": dict(tenants=("v0", "v1", "flood"),
                            decode_slo_s=0.04),
}


@pytest.mark.parametrize("family,episode", [
    ("gpt", "drr"), ("llama", "drr"), ("gpt", "weighted-edf"),
    ("gpt", "fifo"), ("gpt", "ladder"), ("llama", "ladder-tier1"),
    ("gpt", "decode-deadline"),
])
def test_worker_episode_matches_the_reference(family, episode):
    kw = dict(EPISODES[episode], prefix_pool=2, prefix_len=PREFIX)
    schedule = flood_schedule(family, 40, seed=31)
    runs = [worker_episode(side, family, kw, schedule, 90) for side in SIDES]
    (port, trace, replies), (reference, ref_trace, ref_replies) = runs
    for cycle, (got, want) in enumerate(zip(trace, ref_trace)):
        assert got == want, f"cycle {cycle}"
    assert replies == ref_replies
    assert None not in replies  # every request answered once
    assert port.shed_by_reason == reference.shed_by_reason
    assert port.completed_by_tenant == reference.completed_by_tenant
    assert port.processed == reference.processed
    assert port.export_admission_state() == reference.export_admission_state()
    assert port.batcher.prefix_pool.stats() == \
        reference.batcher.prefix_pool.stats()
    sent = sum(len(v) for v in schedule.values())
    errors = [r for r in replies if "error" in r]
    assert sum(port.completed_by_tenant.values()) + len(errors) == sent
    assert all(r["tenant"] in ("v0", "v1", "flood") for r in replies)
    if episode == "ladder":
        assert port.shed_by_reason["pressure"] > 0
        assert port.shed_by_reason["degraded"] > 0
        assert not any(r["tenant"] != "flood" for r in errors)
    if episode == "decode-deadline":
        assert port.shed_by_reason["decode_deadline"] > 0


def test_worker_admission_state_round_trip_matches_the_reference():
    kw = dict(EPISODES["weighted-edf"], shed_tiers=2)
    schedule = flood_schedule("gpt", 12, seed=41, pooled=False)
    first = [worker_episode(side, "gpt", kw, schedule, 12)[0]
             for side in SIDES]
    state = json.loads(json.dumps(first[1].export_admission_state()))
    assert first[0].export_admission_state() == state
    assert state["records"] > 0 and "ladder" in state
    later = flood_schedule("gpt", 16, seed=42, pooled=False)
    runs = [worker_episode(side, "gpt", kw, later, 16, state=state)
            for side in SIDES]
    assert runs[0][1] == runs[1][1] and runs[0][2] == runs[1][2]
    assert runs[0][0].export_admission_state() == \
        runs[1][0].export_admission_state()


def test_pooled_replies_equal_the_prefix_prepended_plain_path():
    schedule = flood_schedule("gpt", 14, seed=51)
    worker, _, pooled = worker_episode(
        SIDES[0], "gpt", dict(tenants=("v0", "v1", "flood"), prefix_pool=2,
                              prefix_len=PREFIX), schedule, 70)
    assert worker.batcher.prefix_pool.hits > 0 and None not in pooled
    queue, results = FakeMessageQueue(), FakeMessageQueue()
    cfg, params = SIDES[0].model("gpt")
    plain = continuous.ContinuousWorker(
        queue, params, cfg, config(seq_len=PREFIX + PROMPT),
        result_queue=results, device="cpu")
    sent = [queue.send_message(URL, json.dumps(
        np.concatenate([prefix, ids]).tolist()))
        for cycle in sorted(schedule) for _, ids, prefix in schedule[cycle]]
    plain.drain(total=len(sent))
    replies, _ = service.collect_replies(results, REPLIES)
    assert [r["tokens"] for r in pooled] == \
        [replies[mid]["tokens"] for mid in sent]


def test_one_default_tenant_serves_as_the_plain_path():
    rng = np.random.default_rng(61)
    bodies = [json.dumps(rng.integers(1, 96, int(n)).tolist())
              for n in rng.integers(2, PROMPT + 1, 7)]
    runs = {}
    cfg, params = SIDES[0].model("gpt")
    for label, tenancy_cfg in (
            ("off", None),
            ("default", tenancy.TenancyConfig(tenants=("default",)))):
        queue, results = FakeMessageQueue(), FakeMessageQueue()
        sent = [queue.send_message(URL, b) for b in bodies]
        worker = continuous.ContinuousWorker(
            queue, params, cfg, config(), result_queue=results,
            tenancy=tenancy_cfg, device="cpu")
        worker.drain(total=len(bodies))
        replies, _ = service.collect_replies(results, REPLIES)
        runs[label] = ([replies[mid]["tokens"] for mid in sent],
                       worker.batcher.insert_dispatches,
                       worker.batcher.decode_dispatches,
                       worker.batcher.host_transfers)
    assert runs["off"] == runs["default"]


def test_off_bucket_and_oversize_prefixes_as_the_reference():
    """A prefix off the pool's bucket is prepended to the prompt; one that
    no longer fits the prompt bucket is answered with an error."""
    sends = [("a", tokens("gpt", 1, 4, seed=71)[0],
              tokens("gpt", 1, 3, seed=72)[0]),
             ("b", tokens("gpt", 1, 10, seed=73)[0],
              tokens("gpt", 1, 5, seed=74)[0])]
    out = []
    for side in SIDES:
        _, _, answered = worker_episode(
            side, "gpt", dict(tenants=("a", "b"), prefix_pool=2,
                              prefix_len=PREFIX),
            {0: sends}, 12)
        out.append(answered)
    assert out[0] == out[1]
    assert "tokens" in out[0][0] and "prefix + prompt" in out[0][1]["error"]


# -- the binary, the metrics and the fleet -------------------------------------


@pytest.mark.parametrize("args,message", [
    (["--tenants", "a"], "--tenants requires --continuous"),
    (["--tenants", "a", "--continuous", "--beams", "2"],
     r"--tenants applies to the plain continuous decode path \(not --beams"),
    (["--tenants", " , ", "--continuous"], "--tenants is empty"),
    (["--tenants", "a,b", "--continuous", "--tenant-weights", "1"],
     "counts must match"),
    (["--tenants", "a", "--continuous", "--tenant-weights", "x"],
     "--tenant-weights must be floats"),
    (["--tenants", "a", "--continuous", "--tenant-slos", "x"],
     "--tenant-slos must be floats"),
    (["--tenants", "a", "--continuous", "--urgency-window", "-1"],
     "--urgency-window -1.0 must be >= 0"),
    (["--tenants", "a", "--continuous", "--urgency-window", "1"],
     "needs at least one positive --tenant-slos"),
    (["--tenants", "a", "--continuous", "--shed-tiers", "4"],
     r"--shed-tiers 4 must be in \[0, 3\]"),
    (["--tenants", "a", "--continuous", "--admission-shards", "0"],
     "--admission-shards 0 must be >= 1"),
    (["--tenants", "a", "--continuous", "--decode-slo-budget", "-1"],
     "--decode-slo-budget -1.0 must be >= 0"),
    (["--tenants", "a", "--continuous", "--prefix-pool", "-1"],
     "--prefix-pool -1 must be >= 0"),
    (["--tenants", "a", "--continuous", "--prefix-pool", "2",
      "--prefix-ids", "1,2"], "mutually exclusive"),
    (["--tenants", "a", "--continuous", "--prefix-pool", "1",
      "--batch-size", "2"], "--prefix-pool 1 must be >= --batch-size 2"),
    (["--tenants", "a", "--continuous", "--tenant-weights", "0.001"],
     "tenant weights must be >= 0.01"),
    (["--tenant-weights", "1"], "--tenant-weights requires --tenants"),
    (["--tenant-slos", "1"], "--tenant-slos requires --tenants"),
    (["--urgency-window", "1"], "--urgency-window requires --tenants"),
    (["--shed-tiers", "1"], "--shed-tiers requires --tenants"),
    (["--admission-shards", "2"], "--admission-shards requires --tenants"),
    (["--decode-slo-budget", "1"], "--decode-slo-budget requires --tenants"),
    (["--prefix-pool", "2"], "--prefix-pool requires --tenants"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_binary_tenancy_flag_checks_fail_as_the_reference(args, message):
    argv = ["--demo", "2", "--generate-tokens", "4", *args]
    for main, extra in ((jax_binary.main, []), (binary, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=message):
            main([*argv, *extra])


@pytest.mark.parametrize("args,message,both", [
    # ported combinations: the reference's argument checks, both binaries
    (["--tenants", "a", "--shards", "2"], "--shards requires --continuous",
     True),
    (["--tenants", "a", "--admission-shards", "2"],
     "--tenants requires --continuous", True),
    (["--tenants", "a", "--continuous", "--speculative-draft-layers", "1",
      "--model-parallel", "2"], "single-chip decode plane", True),
    # the serving orchestration: the reference's argument checks
    (["--continuous", "--scheduler"], "requires --fleet-max-replicas", True),
    (["--continuous", "--knobs", "prefix_pool"], "requires --scheduler",
     True),
    (["--topology", "ring"], "--topology requires --continuous", True),
    (["--journal-path", "j.jsonl"], "records the fleet control loop", True),
    (["--continuous", "--knobs", "warp"], "unknown knob", True),
    (["--continuous", "--scheduler", "--fleet-max-replicas", "2", "--knobs",
      "prefix-pool"], "requires --prefix-pool", True),
    # --tokenizer is ported; the port loads tokenizers from a local
    # directory only and refuses a path that is none before any model is
    # built (a reference given a hub id would try to download it)
    (["--tokenizer", "some/dir"], "is not a directory", False),
    # --model-parallel is ported: what is left to refuse is the
    # reference's own check, speculative on the decode plane over a mesh
    (["--model-parallel", "2", "--continuous", "--shards", "2",
      "--speculative-draft-layers", "1"],
     "runs on the single-chip decode plane", True),
], ids=["shards", "admission-shards", "speculative", "scheduler", "knobs",
        "topology", "journal-path", "unknown-knob", "knob-without-pool",
        "tokenizer", "model-parallel"])
def test_binary_unported_combinations_name_their_roadmap_item(args, message,
                                                              both):
    argv = ["--demo", "2", "--generate-tokens", "4", *args]
    mains = [(binary, ["--device", "cpu"])]
    if both:
        mains.append((jax_binary.main, []))
    for main, extra in mains:
        with pytest.raises(SystemExit, match=message):
            main([*argv, *extra])


def test_binary_tenants_demo_serves_with_the_pool():
    summary = binary(["--device", "cpu", "--demo", "4", "--seq-len", "8",
                      "--generate-tokens", "3", "--batch-size", "2",
                      "--continuous", "--decode-block", "2", "--tenants",
                      "a,b", "--tenant-weights", "1.0,3.0", "--prefix-pool",
                      "2", "--shed-tiers", "2", "--result-queue-url",
                      "demo://replies"])
    assert summary["processed"] == 4 and len(summary["replies"]) == 4
    # plain demo bodies land on the first tenant; the pool holds no prefix
    assert summary["completed_by_tenant"] == {"a": 4}
    assert {r["tenant"] for r in summary["replies"].values()} == {"a"}
    assert summary["prefix_pool"]["prefix_len"] == 8
    assert summary["prefix_pool"]["installs"] == 0
    assert summary["shed_by_reason"]["ttl"] == 0


def test_tenant_gauges_and_counters_render_as_the_reference():
    schedule = flood_schedule("gpt", 12, seed=81)
    families = []
    for side, metrics_cls in zip(SIDES, (WorkloadMetrics, JaxMetrics)):
        worker, _, _ = worker_episode(
            side, "gpt", dict(EPISODES["ladder"], prefix_pool=2,
                              prefix_len=PREFIX), schedule, 12)
        metrics = metrics_cls()
        worker.attach_metrics(metrics)
        text = metrics.render()
        families.append(sorted({line.split("{")[0].split(" ")[0]
                                for line in text.splitlines()
                                if line and not line.startswith("#")
                                and "ttft" not in line
                                and "tokens_per_second" not in line}))
        for name in ("tenant_queue_depth", "tenant_ttft_seconds",
                     "tenant_tokens_per_second", "prefix_cache_hits_total",
                     "prefix_cache_misses_total", "overload_tier",
                     'requests_shed_total{reason="pressure"}',
                     "tenant_time_to_first_token_seconds_bucket"):
            assert name in text, name
        assert 'tenant="flood"' in text
    assert families[0] == families[1]


def fleet(tenancy_cfg, clock, queue, results, **kw):
    cfg, params = SIDES[0].model("gpt")
    return WorkerPool.serving(
        queue, params, cfg, config(), min=1, max=2, clock=clock,
        result_queue=results, tenancy=tenancy_cfg, device="cpu", **kw)


def test_fleet_evacuates_staged_messages_and_counts_per_tenant():
    clock = FakeClock(1000.0)
    queue, results = FakeMessageQueue(now_fn=clock.now), FakeMessageQueue()
    cfg = tenancy.TenancyConfig(tenants=("v0", "flood"), prefix_pool=2,
                                prefix_len=PREFIX)
    pool = fleet(cfg, clock, queue, results)
    pool.scale_up()
    sent = 0
    for cycle, sends in flood_schedule("gpt", 10, seed=91).items():
        for tenant, ids, prefix in sends:
            send(queue, tenant, ids, prefix)
            sent += 1
    while not any(r.worker.staged for r in pool.members):
        pool.run_cycle()
    staged = pool.staged_by_tenant()
    victim = next(r for r in pool.members if r.worker.staged)
    assert sum(staged.values()) > 0
    pool.kill_worker(victim.index)
    stats = FleetDriver(pool, cycle_dt=0.25).run(
        until=lambda: pool.processed >= sent and pool.idle)
    assert stats["cycles"] > 0
    replies, duplicates = service.collect_replies(results, REPLIES)
    assert len(replies) == sent
    assert pool.redispatched_total > 0
    assert pool.completed_by_tenant == service.tenant_completions(replies)
    assert sum(pool.completed_by_tenant.values()) == sent
    assert not any(pool.staged_by_tenant().values())
    # the retired replica's counts survive its pruning
    before = pool.completed_by_tenant
    pool.retired_keep = 0
    pool._prune_retired()
    assert pool.completed_by_tenant == before


def test_pooled_insert_constructs_no_tensor_and_gelu_holds_no_constant(
        monkeypatch):
    """The pooled insert, the GPT's GELU and a decode step build no tensor
    from a Python value (on the card each would be a host-to-device copy
    that waits for the stream)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode, model

    cfg, params = SIDES[0].model("gpt")
    batcher = both_batchers("gpt", block=2)[0]
    requests = [(t, p, ids, i) for i, (t, p, ids)
                in enumerate(traffic("gpt", 3, seed=5)) if p is not None]
    admit(batcher, requests[:1])  # installs the entry
    built = []
    real = torch.tensor

    def counting(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    x = torch.randn(3, 8)
    cache = decode.init_cache(cfg, 2, "cpu")
    monkeypatch.setattr(torch, "tensor", counting)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        model._gelu(x.to(dtype))
    assert built == []
    with torch.inference_mode():
        decode.decode_step(params, cache, torch.zeros(2, dtype=torch.long),
                           cfg)
    batcher.submit_many_prefixed([requests[0][:3] + ("again",)])
    assert built == []
