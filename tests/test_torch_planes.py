"""The port's disaggregated planes held against the JAX package's.

On the CPU, f32, with the reference's tiny weights converted:

- ``DecodePlaneBatcher``: greedy replies, plain and drafted, equal the
  reference plane's for both families up to the first position whose
  reference top-two margin is under ``BF16_GUARD`` (the port's and the
  reference's accept counts agree with them), and equal the port's plain
  sharded plane exactly (greedy draft-and-verify is exact);
- the KV handoff is a bitwise copy of the donor's rows, every cache entry
  (bf16 k/v or int8 codes and scales) and the draft cache's first layers,
  and the adopted rows decode as the fused plane does;
- ``DisaggregatedPool``: every request answered once through the shuttle,
  through a prefill kill mid-handoff and through a redelivery racing a row
  the decode plane holds; its state, gauges and refusals.

The reference's ``tests/test_planes.py`` is mirrored by name, except the
two bench tests.  The pool's orchestration hooks (request-lifecycle
tracing, the collective scheduler, the knob actuator and the scheduled
control loop) attach and serve.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.planes import engine as jax_engine
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.obs import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.planes import (
    DecodePlaneBatcher, DisaggregatedPool, PrefillWorker,
)
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, model
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
    ContinuousBatcher,
)
from kube_sqs_autoscaler_tpu_torch.workloads.service import (
    ServiceConfig, collect_replies,
)
from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
    ShardedBatcher,
)
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import TenancyConfig

from .test_torch_quantize import (
    BF16_GUARD, assert_tokens_upto_ties, ref, reference_rollout, tokens,
    weights,
)

torch.set_num_threads(1)

PROMPT, TOKENS, BLOCK, SPEC = 8, 8, 2, 3


@pytest.fixture(scope="module")
def tiny():
    _, _, tcfg, tp = weights("gpt")
    return tp, tcfg


def make_decode_plane(tiny, *, draft_enabled=None, quantized=False,
                      **kw):
    params, config = tiny
    return DecodePlaneBatcher(
        params, config, shards=2, shard_slots=2, prompt_len=PROMPT,
        generate_tokens=TOKENS, decode_block=BLOCK, spec_layers=1,
        spec_tokens=SPEC, draft_enabled=draft_enabled,
        quantized_kv=quantized, device="cpu", **kw)


def prompts_for(n, seed=7, family="gpt"):
    rng = np.random.default_rng(seed)
    return [tokens(family, 1, int(rng.integers(2, PROMPT + 1)),
                   seed=seed + i)[0] for i in range(n)]


def drain(plane, max_steps=300):
    out = {}
    for _ in range(max_steps):
        for payload, toks in plane.step():
            out[payload] = [int(t) for t in toks]
        if plane.active == 0:
            break
    return out


@pytest.fixture(scope="module")
def expected(tiny):
    """The port's plain sharded gang on ``prompts_for(4)``: the target
    every decode-plane mode must match exactly."""
    params, config = tiny
    control = ShardedBatcher(params, config, shards=2, shard_slots=2,
                             prompt_len=PROMPT, generate_tokens=TOKENS,
                             decode_block=BLOCK, device="cpu")
    control.submit_many([(ids, f"p{i}") for i, ids in
                         enumerate(prompts_for(4))])
    return drain(control)


# ---------------------------------------------------------------------------
# Against the reference plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,drafted", [
    ("gpt", False), ("gpt", True), ("llama", False), ("llama", True),
], ids=["gpt-plain", "gpt-spec", "llama-plain", "llama-spec"])
def test_plane_replies_match_the_reference_plane(family, drafted):
    jcfg, jp, tcfg, tp = weights(family)
    requests = prompts_for(6, seed=11, family=family)
    outs, planes = [], []
    for params, cfg, cls, kw in (
            (tp, tcfg, DecodePlaneBatcher, {"device": "cpu"}),
            (jp, jcfg, jax_engine.DecodePlaneBatcher, {})):
        plane = cls(params, cfg, shards=2, shard_slots=2, prompt_len=PROMPT,
                    generate_tokens=TOKENS, decode_block=BLOCK,
                    spec_layers=1, spec_tokens=SPEC, draft_enabled=drafted,
                    family=family, **kw)
        waiting, out = list(enumerate(requests)), {}
        for step in range(200):
            free = len(plane.free_slots)
            if waiting and free and step % 2 == 0:
                n = min(free, 3)
                take, waiting = waiting[:n], waiting[n:]
                rows = plane.submit_many([(ids, i) for i, ids in take])
                plane.tag_tenant(rows, ["ab"[i % 2] for i, _ in take])
            out.update({p: np.asarray(t) for p, t in plane.step()})
            if not waiting and plane.active == 0:
                break
        outs.append(np.stack([out[i] for i in range(len(requests))]))
        planes.append(plane)
    ids = np.zeros((len(requests), PROMPT), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = jnp.asarray([len(p) for p in requests], jnp.int32)
    _, margins = reference_rollout(
        lambda: ref(family, "prefill")(jp, jnp.asarray(ids), config=jcfg,
                                       lengths=lengths),
        lambda cache, token: ref(family, "decode_step")(jp, cache, token,
                                                        config=jcfg),
        TOKENS)
    assert_tokens_upto_ties(outs[0], outs[1], margins, BF16_GUARD[family])
    port, reference = planes
    if drafted and margins.min() > BF16_GUARD[family]:
        assert port.spec_rounds == reference.spec_rounds > 0
        assert port.spec_accepted == reference.spec_accepted
        for tenant in ("a", "b"):
            assert port.accept_rate(tenant) == reference.accept_rate(tenant)
    assert port.spec_rounds == 0 or drafted


# ---------------------------------------------------------------------------
# The decode-plane engine
# ---------------------------------------------------------------------------


def test_plane_plain_parity(tiny, expected):
    plane = make_decode_plane(tiny, draft_enabled=False)
    plane.submit_many([(ids, f"p{i}") for i, ids in
                       enumerate(prompts_for(4))])
    assert drain(plane) == expected
    assert plane.spec_rounds == 0


def test_plane_spec_parity_and_accept_accounting(tiny, expected):
    plane = make_decode_plane(tiny)
    assert plane.draft_enabled and plane.accept_rate() is None
    rows = plane.submit_many([(ids, f"p{i}") for i, ids in
                              enumerate(prompts_for(4))])
    plane.tag_tenant(rows, ["a", "a", "b", "b"])
    assert drain(plane) == expected
    assert plane.spec_rounds > 0
    assert 0.0 < plane.accept_rate() <= 1.0
    assert plane.recent_accept_rate() is not None
    for tenant in ("a", "b"):
        rate = plane.accept_rate(tenant)
        assert rate is not None and 0.0 <= rate <= 1.0
    assert plane.accept_rate("never-seen") is None


def test_drain_to_plain_flip_mid_flight(tiny, expected):
    plane = make_decode_plane(tiny)
    prompts = prompts_for(4)
    plane.submit_many([(ids, f"q{i}") for i, ids in enumerate(prompts[:2])])
    plane.step()
    plane.set_speculative(False)
    plane.submit_many([(ids, f"r{i}") for i, ids in enumerate(prompts[2:])])
    assert plane._slot_spec.count(True) == 2
    assert drain(plane) == {
        **{f"q{i}": expected[f"p{i}"] for i in range(2)},
        **{f"r{i}": expected[f"p{i + 2}"] for i in range(2)},
    }
    assert plane.spec_flips == 1
    plane.set_speculative(False)
    assert plane.spec_flips == 1
    plane.set_speculative(True)
    assert plane.spec_flips == 2


def test_plane_validates(tiny):
    params, config = tiny
    with pytest.raises(ValueError, match="max_seq_len"):
        DecodePlaneBatcher(
            params, config, shards=2, shard_slots=2, prompt_len=PROMPT,
            generate_tokens=config.max_seq_len - PROMPT - 2 * SPEC + 1,
            decode_block=BLOCK, spec_layers=1, spec_tokens=SPEC,
            device="cpu")
    with pytest.raises(ValueError, match="decode-plane donor"):
        make_decode_plane(tiny).adopt_engine(ShardedBatcher(
            params, config, shards=2, shard_slots=2, prompt_len=PROMPT,
            generate_tokens=TOKENS, decode_block=BLOCK, device="cpu"))
    with pytest.raises(ValueError, match="spec_layers=2"):
        make_decode_plane(tiny).__class__(
            params, config, shards=1, shard_slots=1, prompt_len=PROMPT,
            generate_tokens=TOKENS, spec_layers=2, device="cpu")
    plain = DecodePlaneBatcher(params, config, shards=1, shard_slots=1,
                               prompt_len=PROMPT, generate_tokens=TOKENS,
                               device="cpu")
    with pytest.raises(ValueError, match="spec_layers > 0"):
        plain.set_speculative(True)


def handoff_records(donor):
    return [(row, slot.payload, list(slot.produced), slot.budget,
             slot.submitted_at, slot.tenant)
            for row, slot in enumerate(donor.slots)
            if slot.busy and slot.produced and not slot.done
            and len(slot.produced) < slot.budget]


@pytest.mark.parametrize("family,quantized,drafted", [
    ("gpt", False, False), ("gpt", False, True), ("llama", False, True),
    ("gpt", True, True),
], ids=["gpt-plain", "gpt-spec", "llama-spec", "gpt-int8-spec"])
def test_handoff_adopts_prefill_rows(family, quantized, drafted):
    _, _, tcfg, tp = weights(family)
    tiny = (tp, tcfg)
    donor = ContinuousBatcher(tp, tcfg, 3, PROMPT, TOKENS,
                              decode_block=BLOCK, quantized_kv=quantized,
                              device="cpu")
    prompts = prompts_for(4, family=family)
    donor.submit_many([(ids, f"p{i}") for i, ids in enumerate(prompts[:3])])
    donor._settle_pending_firsts()  # first tokens only, no decode step
    records = handoff_records(donor)[1:]  # rows 1, 2: off the identity map
    assert len(records) == 2
    plane = make_decode_plane(tiny, draft_enabled=drafted,
                              quantized=quantized)
    rows = plane.submit_handoff(donor, records)
    assert plane.kv_transfers == 2 and plane.insert_dispatches == 1
    src = torch.tensor([rec[0] for rec in records])
    dst = torch.tensor(rows)
    # a bitwise copy of whole rows, every entry of every layer
    for layer, donor_layer in zip(plane.cache["layers"],
                                  donor.cache["layers"]):
        assert layer.keys() == donor_layer.keys()
        for name, buf in layer.items():
            assert torch.equal(buf[dst], donor_layer[name][src]), name
    assert torch.equal(plane.cache["length"][dst], donor.cache["length"][src])
    if drafted:
        assert len(plane.draft_cache["layers"]) == 1
        for name, buf in plane.draft_cache["layers"][0].items():
            assert torch.equal(buf[dst], donor.cache["layers"][0][name][src])
    for row in rows:
        assert plane.slots[row].ttft_done
        assert plane._slot_spec[row] is drafted
    for row, *_ in records:
        donor.slots[row] = continuous._Slot()
    control = ShardedBatcher(tp, tcfg, shards=2, shard_slots=2,
                             prompt_len=PROMPT, generate_tokens=TOKENS,
                             decode_block=BLOCK, quantized_kv=quantized,
                             device="cpu")
    control.submit_many([(ids, f"p{i}") for i, ids in
                         enumerate(prompts[1:3], start=1)])
    assert drain(plane) == drain(control)
    assert plane.spec_rounds > 0 if drafted else plane.spec_rounds == 0


def test_handoff_validates(tiny):
    params, config = tiny
    plane = make_decode_plane(tiny)
    donor = ContinuousBatcher(params, config, 2, PROMPT, TOKENS,
                              decode_block=BLOCK, device="cpu")
    finished = [(0, "p", list(range(TOKENS)), TOKENS, 0.0, None)]
    with pytest.raises(ValueError, match="started, unfinished"):
        plane.submit_handoff(donor, finished)
    too_many = [(0, f"p{i}", [1], TOKENS, 0.0, None)
                for i in range(len(plane.slots) + 1)]
    with pytest.raises(RuntimeError, match="no free slot"):
        plane.submit_handoff(donor, too_many)
    other_config = model.ModelConfig(**{**config.__dict__})
    other = ContinuousBatcher(params, other_config, 2, PROMPT, TOKENS,
                              decode_block=BLOCK, device="cpu")
    with pytest.raises(ValueError, match="layout-identical"):
        plane.submit_handoff(other, [(0, "p", [1], TOKENS, 0.0, None)])
    assert plane.kv_transfers == 0


# ---------------------------------------------------------------------------
# The worker: speculative on the plane, and with tenancy at S = 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards,tenants", [(2, None), (1, ("t",))],
                         ids=["shards", "tenancy-s1"])
def test_worker_runs_speculative_slots_on_the_decode_plane(tiny, shards,
                                                           tenants):
    params, config = tiny
    replies = []
    for draft in (1, 0):
        queue, results = FakeMessageQueue(), FakeMessageQueue()
        sent = [queue.send_message("w://q", json.dumps(
            {"tenant": "t", "ids": ids.tolist()} if tenants
            else ids.tolist())) for ids in prompts_for(6, seed=13)]
        worker = continuous.ContinuousWorker(
            queue, params, config, ServiceConfig(
                queue_url="w://q", batch_size=2, seq_len=PROMPT,
                generate_tokens=TOKENS, decode_block=BLOCK, shards=shards,
                result_queue_url="w://r"),
            result_queue=results, draft_layers=draft, draft_tokens=SPEC,
            tenancy=TenancyConfig(tenants=tenants) if tenants else None,
            device="cpu")
        worker.drain(total=len(sent), max_cycles=500)
        got, _ = collect_replies(results, "w://r")
        replies.append([got[m]["tokens"] for m in sent])
        if draft:
            assert isinstance(worker.batcher, DecodePlaneBatcher)
            assert worker.batcher.shards == shards
            assert worker.batcher.spec_rounds > 0
    assert replies[0] == replies[1]


def test_binary_serves_speculative_on_the_plane():
    base = ["--device", "cpu", "--demo", "4", "--seq-len", "8",
            "--generate-tokens", "4", "--batch-size", "2", "--continuous",
            "--decode-block", "2", "--result-queue-url", "demo://replies"]
    plain = binary([*base, "--shards", "2"])
    spec = binary([*base, "--shards", "2", "--speculative-draft-layers",
                   "1", "--speculative-draft-tokens", "3"])
    tenants = binary([*base, "--tenants", "a", "--speculative-draft-layers",
                      "1"])
    tokens_of = lambda s: sorted(r["tokens"] for r in s["replies"].values())
    assert tokens_of(spec) == tokens_of(plain) == tokens_of(tenants)
    assert spec["spec_rounds"] > 0 and tenants["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# The disaggregated pool
# ---------------------------------------------------------------------------


def make_disagg(tiny, *, queue_url, visibility=30.0, draft_enabled=None,
                tenants=("t",), min=2, max=2, **pool_kwargs):
    params, config = tiny
    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=visibility, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    service = ServiceConfig(
        queue_url=queue_url, batch_size=2, seq_len=PROMPT,
        generate_tokens=TOKENS, decode_block=BLOCK, shards=2,
        result_queue_url=f"{queue_url}-r")
    pool = DisaggregatedPool.serving(
        queue, params, config, service, result_queue=results, min=min,
        max=max, decode_shards=2, spec_layers=1, spec_tokens=SPEC,
        draft_enabled=draft_enabled, tenancy=TenancyConfig(tenants=tenants),
        clock=clock, now_fn=clock.now, device="cpu", **pool_kwargs)
    return pool, clock, queue, results, service


def send(queue, queue_url, ids, tenant="t"):
    return queue.send_message(queue_url, json.dumps(
        {"tenant": tenant, "ids": [int(i) for i in ids]}))


def drive(pool, clock, *, until, max_cycles=200, on_cycle=None):
    for cycle in range(max_cycles):
        if on_cycle is not None:
            on_cycle(cycle)
        pool.run_cycle()
        clock.advance(0.2)
        if until():
            return cycle + 1
    raise AssertionError(f"pool did not converge: processed="
                         f"{pool.processed} idle={pool.idle}")


def test_pool_exactly_once_through_the_shuttle(tiny):
    pool, clock, queue, results, service = make_disagg(
        tiny, queue_url="disagg://e2e")
    to_send, sent = prompts_for(12, seed=31), []

    def on_cycle(_):
        if to_send:
            sent.append(send(queue, "disagg://e2e", to_send.pop(0)))

    drive(pool, clock, on_cycle=on_cycle,
          until=lambda: not to_send and pool.processed >= 12 and pool.idle)
    replies, duplicates = collect_replies(results, service.result_queue_url)
    assert set(replies) == set(sent) and duplicates == 0
    assert pool.kv_handoffs_total >= 12
    assert pool.decode.batcher.kv_transfers == pool.kv_handoffs_total
    assert all(isinstance(r.worker, PrefillWorker) for r in pool.members)
    assert all(r.worker.batcher.decode_dispatches == 0
               for r in pool.members)  # the prefill plane never decodes
    ttfts = [t for r in pool.members
             for t in r.worker.batcher.tenant_ttft.get("t", ())]
    assert ttfts and all(t >= 0.0 for t in ttfts)


def test_decode_cadence_decouples_from_poll_cadence(tiny):
    cycles = {}
    for cadence in (1, 2):
        url = f"disagg://cad{cadence}"
        pool, clock, queue, results, _ = make_disagg(
            tiny, queue_url=url, draft_enabled=False,
            decode_steps_per_cycle=cadence)
        sent = [send(queue, url, ids) for ids in prompts_for(16, seed=33)]
        cycles[cadence] = drive(
            pool, clock, until=lambda: pool.processed >= 16 and pool.idle)
        replies, duplicates = collect_replies(results, f"{url}-r")
        assert set(replies) == set(sent) and duplicates == 0
    assert cycles[2] < cycles[1]
    with pytest.raises(ValueError, match="decode_steps_per_cycle"):
        make_disagg(tiny, queue_url="disagg://cad0",
                    decode_steps_per_cycle=0)


def test_prefill_kill_mid_handoff_redispatches(tiny):
    pool, clock, queue, results, service = make_disagg(
        tiny, queue_url="disagg://kill", draft_enabled=False,
        decode_steps_per_cycle=1)
    to_send, sent, state = prompts_for(14, seed=35), [], {"killed": None}

    def on_cycle(_):
        for _ in range(2):
            if to_send:
                sent.append(send(queue, "disagg://kill", to_send.pop(0)))
        if state["killed"] is None:
            victims = [r for r in pool.members if r.state == "serving"
                       and r.worker.batcher.active > 0]
            if victims:
                state["killed"] = victims[-1].index
                victims[-1].worker.kill()

    drive(pool, clock, on_cycle=on_cycle,
          until=lambda: not to_send and pool.processed >= 14 and pool.idle)
    assert state["killed"] is not None
    replies, duplicates = collect_replies(results, service.result_queue_url)
    assert set(replies) == set(sent) and duplicates == 0
    assert pool.redispatched_total > 0


def test_redelivery_racing_decode_owned_row_stays_exactly_once(tiny):
    pool, clock, queue, results, service = make_disagg(
        tiny, queue_url="disagg://race", draft_enabled=False)
    sent = [send(queue, "disagg://race", ids)
            for ids in prompts_for(6, seed=37)]
    state = {"redelivered": False}

    def on_cycle(_):
        decode = pool.decode.batcher
        if not state["redelivered"] and decode.active > 0:
            state["redelivered"] = True
            for slot in decode.slots:
                if slot.busy and slot.payload:
                    queue.change_message_visibility(
                        "disagg://race", slot.payload["ReceiptHandle"], 0)

    def queue_drained():
        attrs = queue.get_queue_attributes("disagg://race", ["All"])
        return (attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0")

    drive(pool, clock, on_cycle=on_cycle,
          until=lambda: pool.processed >= 6 and pool.idle
          and queue_drained())
    assert state["redelivered"] and pool.duplicates_suppressed > 0
    replies, duplicates = collect_replies(results, service.result_queue_url)
    assert set(replies) == set(sent) and duplicates == 0


def test_export_import_carries_plane_state(tiny):
    pool, clock, queue, results, _ = make_disagg(tiny,
                                                 queue_url="disagg://dur")
    sent = [send(queue, "disagg://dur", ids)
            for ids in prompts_for(4, seed=39)]
    drive(pool, clock, until=lambda: pool.processed >= 4 and pool.idle)
    pool.decode.batcher.set_speculative(False)
    state = pool.export_state()
    assert state["kv_handoffs_total"] == pool.kv_handoffs_total > 0
    assert state["draft_enabled"] is False
    fresh, _, _, _, _ = make_disagg(tiny, queue_url="disagg://dur2")
    assert fresh.decode.batcher.draft_enabled
    flips = fresh.decode.batcher.spec_flips
    fresh.import_state(json.loads(json.dumps(state)))
    assert fresh.kv_handoffs_total == pool.kv_handoffs_total
    assert fresh.decode.batcher.draft_enabled is False
    assert fresh.decode.batcher.spec_flips == flips
    assert all(fresh.already_replied(m) for m in sent)


def test_plane_gauges_exported(tiny):
    pool, clock, queue, results, _ = make_disagg(
        tiny, queue_url="disagg://obs", tenants=("a", "b"))
    metrics = WorkloadMetrics()
    pool.attach_metrics(metrics)
    pool.decode.attach_metrics(metrics)
    to_send, sent = prompts_for(8, seed=41), []

    def on_cycle(cycle):
        if to_send:
            sent.append(send(queue, "disagg://obs", to_send.pop(0),
                             tenant="ab"[cycle % 2]))

    drive(pool, clock, on_cycle=on_cycle,
          until=lambda: not to_send and pool.processed >= 8 and pool.idle)
    text = metrics.render()
    assert "plane_prefill_replicas 2.0" in text
    assert "plane_decode_shards 2.0" in text
    assert "plane_kv_transfers_total" in text
    assert 'speculative_accept_rate{tenant="a"}' in text
    assert 'speculative_accept_rate{tenant="b"}' in text


def test_serving_requires_a_drafted_decode_plane(tiny):
    params, config = tiny
    with pytest.raises(ValueError, match="draft_enabled=False"):
        DisaggregatedPool.serving(
            FakeMessageQueue(), params, config, ServiceConfig(
                queue_url="q", batch_size=2, seq_len=PROMPT,
                generate_tokens=TOKENS, shards=2),
            min=1, max=1, decode_shards=2, spec_layers=0, device="cpu")


def test_orchestration_hooks_name_their_roadmap_item(tiny):
    """The three hooks the pool refused until item 3b now attach and
    serve: a traced, comms-attached pool answers every request once with
    a valid chain carrying its handoff, and the control loop runs on the
    event scheduler.  The learned knob policy walks a knob's ladder on the
    pool."""
    from kube_sqs_autoscaler_tpu_torch.comms import (
        HANDOFF_KV, CollectiveScheduler, topology_from_geometry,
    )
    from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
        LifecycleRegistry, validate_chain,
    )
    from kube_sqs_autoscaler_tpu_torch.sched.knobs import LearnedKnobPolicy

    pool, clock, queue, _, _ = make_disagg(tiny, queue_url="disagg://hooks",
                                           min=1, max=1)
    registry = LifecycleRegistry()
    pool.attach_lifecycle(registry)
    comms = CollectiveScheduler(
        lifecycle=registry, topology=topology_from_geometry("ring", shards=2))
    pool.attach_comms(comms)
    assert pool.decode.batcher.comms is comms
    assert {"prefill", "decode-plane"} <= set(comms.topology.nodes)
    to_send = prompts_for(4, seed=43)

    def on_cycle(_):
        if to_send:
            send(queue, "disagg://hooks", to_send.pop(0))

    drive(pool, clock, on_cycle=on_cycle,
          until=lambda: not to_send and pool.processed >= 4 and pool.idle)
    assert registry.replies == 4 and pool.processed == 4
    for trace in registry.done_traces():
        assert validate_chain(trace, require_handoff=bool(
            trace.notes.get("handed_off"))) == [], trace.rid
    assert comms.counters()["by_kind"][HANDOFF_KV] >= 1
    loop = ControlLoop(pool, type("Depth", (), {
        "num_messages": staticmethod(lambda: 0)})(), clock=clock)
    loop.run(2, scheduler=True)
    assert loop.ticks == 2
    # the learned knob policy is ported: on this pool's actuator it walks
    # the decode-block ladder by its brain's deltas, consumed once
    from kube_sqs_autoscaler_tpu_torch.sched.knobs import KnobActuator

    actuator = KnobActuator(pool, armed=("decode_block",))

    class _Brain:
        delta = 1

        def take_knob_delta(self):
            delta, self.delta = self.delta, None
            return delta

    knob = LearnedKnobPolicy(actuator, _Brain(), ladder=(2, 4, 8))
    before = actuator._read("decode_block")
    knob.evaluate()
    knob.evaluate()  # consumed: no second step
    assert actuator.pending == {"decode_block": {2: 4, 4: 8, 8: 8}[
        before]}


def test_knobs_route_to_the_right_plane(tiny):
    from kube_sqs_autoscaler_tpu_torch.sched.knobs import (
        KNOB_PLANE_RATIO, KNOB_SPECULATIVE, KnobActuator, KnobError,
    )

    pool, clock, _, _, _ = make_disagg(tiny, queue_url="disagg://knob",
                                       min=1, max=3)
    actuator = KnobActuator(pool, armed=(KNOB_SPECULATIVE, KNOB_PLANE_RATIO),
                            clock=clock)
    # speculative routes to the one decode-plane worker
    assert actuator.set(KNOB_SPECULATIVE, False)
    (change,) = actuator.apply()
    assert change["knob"] == KNOB_SPECULATIVE
    assert pool.decode.batcher.draft_enabled is False
    assert pool.decode.batcher.spec_flips == 1
    # plane_ratio walks the prefill plane through its own Scaler
    assert actuator.set(KNOB_PLANE_RATIO, 3)
    (change,) = actuator.apply()
    assert change["knob"] == KNOB_PLANE_RATIO and change["value"] == 3
    assert pool.replicas == 3
    assert pool.decode_pool.replicas == 2  # the decode plane unmoved
    with pytest.raises(KnobError, match="plane_ratio"):
        actuator.set(KNOB_PLANE_RATIO, 7)  # outside [min, max]
