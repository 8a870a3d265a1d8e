"""The port's fleet and control loop held against the JAX package.

- **Seam parity.** The port's ``WorkerPool`` (stub replicas) and
  ``ShardedWorkerPool`` (a stub plane) and the JAX package's
  ``PodAutoScaler`` over a ``FakeDeploymentAPI`` go through the
  JAX ``ControlLoop`` and the port's, on one scripted depth trace with one
  actuation failure: every tick record and replica count is equal.
- **Loop parity.** The canonical cooldown episode (3 -> 4 replicas at
  t = 15) through both loops, record for record, and ``plan_tick`` on a
  grid of inputs.
- **The demo episode.** ``python -m kube_sqs_autoscaler_tpu_torch.fleet``
  exits 0 on the CPU; run in f32 on the reference's weights, its events
  and replies equal the JAX ``fleet/__main__._demo_episode``'s.
- **Exactly once** through a visibility-timeout redelivery, a drain
  timeout and a hang caught by each watchdog.
- ``adopt_engine``'s refusals, the binary's fleet flag checks, and the two
  repaired faults: the batcher's dispatch and host-transfer counters equal
  the JAX batcher's after every step with refills mid-stream, and
  ``attention_fn_for`` keeps the kernels' head-dim contract.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.core.clock import FakeClock as JaxClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as JaxLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as JaxLoopConfig
from kube_sqs_autoscaler_tpu.core import policy as jax_policy
from kube_sqs_autoscaler_tpu.fleet import __main__ as jax_fleet_main
from kube_sqs_autoscaler_tpu.scale import FakeDeploymentAPI, PodAutoScaler
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu_torch.core import policy
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop, LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.types import ScaleError, Scaler
from kube_sqs_autoscaler_tpu_torch.fleet import (
    DEAD,
    DRAINING,
    STOPPED,
    FleetDriver,
    ShardedWorkerPool,
    WorkerPool,
)
from kube_sqs_autoscaler_tpu_torch.fleet import __main__ as fleet_main
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, flash
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig,
    _dense_attention,
    init_params,
)
from kube_sqs_autoscaler_tpu_torch.workloads.service import (
    ServiceConfig,
    collect_replies,
)

from .test_torch_model import both_params


# ---------------------------------------------------------------------------
# Seam and loop parity (stub replicas: the scaling lives in the pool)
# ---------------------------------------------------------------------------


class _StubBatcher:
    def __init__(self):
        self.active = 0
        self.free_slots = []
        self.tokens_emitted = 0


class _StubWorker:
    """The replica surface the pool needs, with no serving engine."""

    def __init__(self):
        self.admitting = True
        self.killed = False
        self.hung = False
        self.processed = 0
        self.batcher = _StubBatcher()

    def run_once(self):
        return 0

    def stop(self):
        pass

    def kill(self):
        self.killed = True

    def hang(self):
        self.hung = True

    def take_inflight(self):
        return []

    def release_inflight(self):
        return 0

    def _admit(self, messages):
        return len(messages)


class _StubShardedBatcher(_StubBatcher):
    """The plane surface ShardedWorkerPool needs, with no serving engine."""

    def __init__(self, shards):
        super().__init__()
        self.shards = shards
        self.shard_admitting = [True] * shards
        self.shard_probing = [False] * shards

    def set_shard_active(self, shard, active):
        self.shard_admitting[shard] = bool(active)

    def shard_busy(self, shard):
        return 0


class _StubShardedWorker(_StubWorker):
    def __init__(self, shards):
        super().__init__()
        self.batcher = _StubShardedBatcher(shards)


def make_pod(initial, min_, max_):
    api = FakeDeploymentAPI.with_deployments("ns", initial, "deploy")
    scaler = PodAutoScaler(
        client=api, max=max_, min=min_, scale_up_pods=1, scale_down_pods=1,
        deployment="deploy", namespace="ns",
    )

    def fail_next_up(err):
        api.fail_next_update = err  # -> ScaleError("Failed to scale up")

    return scaler, (lambda: api.replicas("deploy")), fail_next_up


def make_pool(initial, min_, max_):
    pool = WorkerPool(lambda p: _StubWorker(), min=min_, max=max_,
                      initial=initial)

    def fail_next_up(err):
        pool.fail_next_up = err

    return pool, (lambda: pool.replicas), fail_next_up


def make_sharded_pool(initial, min_, max_):
    pool = ShardedWorkerPool(lambda p: _StubShardedWorker(max_), min=min_,
                             max=max_, initial=initial)

    def fail_next_up(err):
        pool.fail_next_up = err

    return pool, (lambda: pool.replicas), fail_next_up


LOOPS = {
    "jax-loop": (JaxLoop, JaxLoopConfig, jax_policy.PolicyConfig, JaxClock),
    "port-loop": (ControlLoop, LoopConfig, policy.PolicyConfig, FakeClock),
}


class _Scripted:
    """Deterministic depth sequence (repeats the last value)."""

    def __init__(self, depths):
        self.depths, self.i = list(depths), 0

    def num_messages(self):
        depth = self.depths[min(self.i, len(self.depths) - 1)]
        self.i += 1
        return depth


def drive_loop(loop_name, make, depths, *, initial, cooldowns,
               fail_up_at=None, up_at=100, down_at=10):
    """Run one loop over one scaler for ``len(depths)`` ticks; returns the
    per-tick ``(record dict, replicas after)`` rows."""
    loop_cls, config_cls, policy_cls, clock_cls = LOOPS[loop_name]
    scaler, replicas, fail_next_up = make(initial, 1, 5)
    rows = []

    class Recorder:
        def on_tick(self, record):
            rows.append((record.to_dict(), replicas()))

    loop = loop_cls(
        scaler, _Scripted(depths),
        config_cls(poll_interval=5.0, policy=policy_cls(
            scale_up_messages=up_at, scale_down_messages=down_at,
            scale_up_cooldown=cooldowns[0],
            scale_down_cooldown=cooldowns[1])),
        clock=clock_cls(), observer=Recorder(),
    )
    if fail_up_at is not None:
        original = loop.tick

        def tick(state):
            if len(rows) == fail_up_at:
                fail_next_up(ConnectionError("injected"))
            return original(state)

        loop.tick = tick
    loop.run(max_ticks=len(depths))
    return rows


SCRIPT = [150, 150, 150, 150, 150, 150, 5, 5, 5, 5, 5, 5, 5, 150, 150]


def test_pool_and_pod_scaler_identical_through_both_loops():
    runs = {
        (loop, name): drive_loop(loop, make, SCRIPT, initial=2,
                                 cooldowns=(10.0, 20.0), fail_up_at=2)
        for loop in LOOPS for name, make in (
            ("pod", make_pod), ("pool", make_pool),
            ("sharded-pool", make_sharded_pool))
    }
    want = runs[("jax-loop", "pod")]
    for key, rows in runs.items():
        assert rows == want, key
    gates = [row[0].get("up") for row in want]
    assert "fire" in gates and "cooling" in gates
    assert any("up_error" in row[0] for row in want)
    assert isinstance(make_pool(1, 1, 2)[0], Scaler)
    assert isinstance(make_sharded_pool(1, 1, 2)[0], Scaler)


def test_canonical_cooldown_episode_through_both_loops():
    # poll 5 s, cooldowns 10 s, depth 300 at the up threshold, 3 replicas:
    # cooling at t=5, fire at t=10, cooling at t=15 -> 4 replicas
    runs = [drive_loop(loop, make_pod, [300] * 3, initial=3,
                       cooldowns=(10.0, 10.0), up_at=300)
            for loop in LOOPS]
    assert runs[0] == runs[1]
    assert [row[0]["up"] for row in runs[1]] == ["cooling", "fire", "cooling"]
    assert [row[1] for row in runs[1]] == [3, 4, 4]
    assert [row[0]["start"] for row in runs[1]] == [5.0, 10.0, 15.0]
    state = policy.initial_state(0.0)
    for now, depth in ((5.0, 300), (10.0, 300), (10.0, 5), (40.0, 5)):
        for (up_s, down_s) in ((0.0, 0.0), (9.0, 2.0)):
            state = policy.PolicyState(up_s, down_s)
            cfg = policy.PolicyConfig(scale_up_messages=300,
                                      scale_down_cooldown=30.0)
            got = policy.plan_tick(depth, now, cfg, state)
            want = jax_policy.plan_tick(
                depth, now, jax_policy.PolicyConfig(
                    scale_up_messages=300, scale_down_cooldown=30.0),
                jax_policy.PolicyState(up_s, down_s))
            assert (got.up.value, got.down.value) == \
                (want.up.value, want.down.value)


def test_pool_failure_seam_and_bounds():
    pool, replicas, fail_next_up = make_pool(3, 1, 5)
    fail_next_up(ConnectionError("backend down"))
    with pytest.raises(ScaleError):
        pool.scale_up()
    assert replicas() == 3
    pool.scale_down()
    assert replicas() == 2
    assert [r.state for r in pool.members].count(DRAINING) == 1
    with pytest.raises(ValueError, match="hang_grace_cycles"):
        WorkerPool(lambda p: _StubWorker(), min=1, max=2, hang_grace_cycles=1)
    with pytest.raises(ValueError, match="not yet ported"):
        FleetFaultPlan(admission_kills=((1, 0),))
    with pytest.raises(ValueError, match="not yet ported"):
        ControlLoop(pool, _Scripted([1]), resilience=object())


def test_reply_registry_is_bounded_and_survives_export_import():
    pool = WorkerPool(lambda p: _StubWorker(), min=1, max=2,
                      replied_capacity=3)
    for rid in ("m1", "m2", "m3", "m4"):
        pool.mark_replied(rid)
    pool.note_duplicate("m4")
    assert not pool.already_replied("m1")  # evicted past the capacity
    state = pool.export_state()
    assert state == {"records": 3, "replied": ["m2", "m3", "m4"],
                     "duplicates_suppressed": 1}
    restarted = WorkerPool(lambda p: _StubWorker(), min=1, max=2)
    assert restarted.import_state(state) == 3
    assert restarted.already_replied("m4") and not restarted.already_replied(
        "m1")
    assert restarted.duplicates_suppressed == 1


# ---------------------------------------------------------------------------
# The demo episode against the reference's
# ---------------------------------------------------------------------------


def test_fleet_demo_exits_zero_on_the_cpu(capsys):
    assert fleet_main.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["replies"] == 12 and out["device"] == "cpu"


def test_fleet_demo_matches_the_reference_episode(monkeypatch):
    # both episodes in f32 (the reference's demo model is bf16, whose
    # rounding differs between the frameworks), on the reference's weights
    monkeypatch.setattr(jax_model, "ModelConfig", functools.partial(
        jax_model.ModelConfig, dtype=jnp.float32))
    want = jax_fleet_main._demo_episode()
    jpool, jparams, jstats, jsent, jreplies, _ = want
    model = dataclasses.replace(fleet_main.demo_model(), dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model, "cpu")
    pool, _, stats, sent, replies, duplicates = fleet_main._demo_episode(
        "cpu", params=params, model=model)
    assert fleet_main._check_demo(pool, params, stats, sent, replies,
                                  duplicates) == []
    # every event, its time on the FakeClock and its args are the
    # reference's: the engines settle, kill, re-dispatch and drain on the
    # same cycles
    assert [(e.name, e.t, e.args) for e in pool.events] == \
        [(e.name, e.t, e.args) for e in jpool.events]
    assert stats["replica_trajectory"] == jstats["replica_trajectory"]
    assert sent == jsent
    assert replies == jreplies
    assert pool.trace_events() == jpool.trace_events()


# ---------------------------------------------------------------------------
# Exactly once on real replicas (tiny f32 model, CPU)
# ---------------------------------------------------------------------------

BATCH, PROMPT, TOKENS, BLOCK = 2, 4, 8, 2


@pytest.fixture(scope="module")
def tiny():
    model = ModelConfig(vocab_size=64, d_model=16, n_heads=2, n_layers=2,
                        d_ff=32, max_seq_len=PROMPT + TOKENS,
                        dtype=torch.float32)
    return model, init_params(model, torch.Generator().manual_seed(0), "cpu")


def make_fleet(tiny, *, messages, initial, clock=None, visibility=30.0,
               **pool_kwargs):
    model, params = tiny
    now_fn = clock.now if clock is not None else None
    queue = FakeMessageQueue(visibility_timeout=visibility, now_fn=now_fn)
    results = FakeMessageQueue(now_fn=now_fn)
    rng = np.random.default_rng(3)
    sent = [queue.send_message("t://q", json.dumps(
        rng.integers(1, 64, 3).tolist())) for _ in range(messages)]
    config = ServiceConfig(queue_url="t://q", batch_size=BATCH,
                           seq_len=PROMPT, generate_tokens=TOKENS,
                           decode_block=BLOCK, result_queue_url="t://r")
    pool = WorkerPool.serving(queue, params, model, config,
                              result_queue=results, min=1, max=2,
                              initial=initial, clock=clock, device="cpu",
                              **pool_kwargs)
    return pool, queue, results, sent


def drive(pool, until, max_cycles=400):
    for _ in range(max_cycles):
        pool.run_cycle()
        if until():
            return
    raise AssertionError("fleet did not converge within the cycle budget")


@pytest.mark.parametrize("scenario", [
    "redelivery", "drain-timeout", "hang-busy", "hang-idle"])
def test_every_request_answered_exactly_once(tiny, scenario):
    clock = FakeClock() if scenario == "redelivery" else None
    messages = {"redelivery": 1, "hang-idle": 1}.get(scenario, 6)
    pool, queue, results, sent = make_fleet(
        tiny, messages=messages, initial=1 if clock else 2, clock=clock,
        visibility=0.5 if clock else 30.0,
        drain_timeout_cycles=1 if scenario == "drain-timeout" else None,
    )
    pool.run_cycle()  # admit: both replicas, or one holding the request
    if scenario == "redelivery":
        clock.advance(1.0)  # the in-flight copy's visibility lapses
    elif scenario == "drain-timeout":
        pool.scale_down()  # replica 1 drains and times out a cycle later
    elif scenario == "hang-busy":
        assert pool.members[1].worker.batcher.active > 0
        pool.hang_worker(1)
    else:
        assert pool.members[1].worker.batcher.active == 0
        pool.hang_worker(1)
    drive(pool, lambda: pool.processed >= len(sent) and pool.idle and (
        queue.get_queue_attributes("t://q", [])
        ["ApproximateNumberOfMessages"] == "0"))
    replies, duplicates = collect_replies(results, "t://r")
    assert set(replies) == set(sent) and duplicates == 0
    assert pool.processed == len(sent)
    kills = [e.args for e in pool.events if e.name == "replica-kill"]
    if scenario == "redelivery":
        assert pool.duplicates_suppressed >= 1
    elif scenario == "drain-timeout":
        assert pool.released_total > 0
        assert pool.members[1].state == STOPPED
    else:
        cause = "hung" if scenario == "hang-busy" else "hung-idle"
        assert [k["cause"] for k in kills] == [cause]
        assert pool.members[1].state == DEAD
        assert pool.members[1].worker.batcher.active == 0


def test_fault_plan_kill_redispatches_and_params_are_shared(tiny):
    pool, _, results, sent = make_fleet(tiny, messages=6, initial=2)
    driver = FleetDriver(pool, fault_plan=FleetFaultPlan(kills=((1, 1),)))
    driver.run(until_processed=len(sent), max_cycles=400)
    assert pool.members[1].state == DEAD and pool.redispatched_total > 0
    replies, duplicates = collect_replies(results, "t://r")
    assert set(replies) == set(sent) and duplicates == 0
    batchers = [r.worker.batcher for r in pool.members]
    assert all(b.params is tiny[1] for b in batchers)
    assert all(b._block_fn is batchers[0]._block_fn for b in batchers)
    assert len({id(b.cache["length"]) for b in batchers}) == 2


def test_adopt_engine_refuses_another_engine_or_other_params(tiny):
    model, params = tiny
    donor = continuous.ContinuousBatcher(params, model, BATCH, PROMPT,
                                         TOKENS, decode_block=BLOCK,
                                         device="cpu")
    other = continuous.ContinuousBatcher(params, model, BATCH, PROMPT,
                                         TOKENS - 1, decode_block=BLOCK,
                                         device="cpu")
    with pytest.raises(ValueError, match="engine mismatch"):
        other.adopt_engine(donor)
    copied = {**params}
    stranger = continuous.ContinuousBatcher(copied, model, BATCH, PROMPT,
                                            TOKENS, decode_block=BLOCK,
                                            device="cpu")
    with pytest.raises(ValueError, match="exact params/config"):
        stranger.adopt_engine(donor)


@pytest.mark.parametrize("args,message", [
    (["--demo", "4"], "requires --continuous"),
    (["--continuous", "--generate-tokens", "2"], "requires --demo"),
    (["--demo", "4", "--continuous", "--generate-tokens", "2",
      "--fleet-min-replicas", "3"], "need 1 <= --fleet-min-replicas"),
])
def test_binary_rejects_fleet_flags_outside_their_mode(args, message):
    with pytest.raises(SystemExit, match=message):
        binary(["--fleet-max-replicas", "2", "--device", "cpu", *args])


@pytest.mark.parametrize("entry", ["pool", "sharded-pool", "fleet-demo",
                                   "fleet-flag", "sqs"])
def test_new_entry_points_default_to_cuda_and_raise_without_a_card(
        tiny, entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    if entry in ("pool", "sharded-pool"):
        model, params = tiny
        pool_cls = WorkerPool if entry == "pool" else ShardedWorkerPool
        with pytest.raises(RuntimeError, match="no usable CUDA card"):
            pool_cls.serving(
                FakeMessageQueue(), params, model,
                ServiceConfig(queue_url="t://q", batch_size=BATCH,
                              seq_len=PROMPT, generate_tokens=TOKENS),
                min=1, max=2)
        return
    argv = {
        "fleet-demo": None,
        "fleet-flag": ["--demo", "4", "--continuous", "--generate-tokens",
                       "2", "--fleet-max-replicas", "2"],
        "sqs": ["--sqs-queue-url", "http://127.0.0.1:1/000000000000/q",
                "--aws-region", "us-east-1"],
    }[entry]
    with pytest.raises(SystemExit, match="no usable CUDA card"):
        if argv is None:
            fleet_main.main([])
        else:
            binary(argv)


# ---------------------------------------------------------------------------
# The two repaired faults
# ---------------------------------------------------------------------------


def counters(batcher) -> tuple[int, int, int]:
    return (batcher.insert_dispatches, batcher.decode_dispatches,
            batcher.host_transfers)


@pytest.mark.parametrize("decode_block", [1, 3])
def test_counters_equal_the_reference_batcher_with_mid_stream_refills(
        decode_block):
    jcfg, jp, tcfg, tp = both_params()
    rng = np.random.default_rng(9)
    requests = [rng.integers(1, 96, rng.integers(2, 13)).astype(np.int32)
                for _ in range(9)]
    budgets = dict(batch_size=3, prompt_len=12, generate_tokens=5,
                   decode_block=decode_block)
    port = continuous.ContinuousBatcher(tp, tcfg, device="cpu", **budgets)
    ref = jax_continuous.ContinuousBatcher(jp, jcfg, **budgets)
    waiting, refills = list(enumerate(requests)), 0
    for step in range(200):
        free = len(port.free_slots)
        assert free == len(ref.free_slots)
        if waiting and free and step % 2 == 0:
            take = min(free, 2)  # refills of 1-2 while other slots decode
            for batcher in (port, ref):
                batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
            refills += port.active > take
        port.step()
        ref.step()
        assert counters(port) == counters(ref), f"step {step}"
        if not waiting and port.active == 0:
            break
    assert refills > 0 and port.active == 0 and not waiting


def test_attention_fn_for_keeps_the_kernel_head_dims():
    assert flash.attention_fn_for(64, "cuda", 16) is _dense_attention
    assert flash.attention_fn_for(64, "cuda", 64) is flash.flash_attention
    assert flash.attention_fn_for(64, torch.device("cuda"), 128) is \
        flash.flash_attention
    assert flash.attention_fn_for(64, "cpu", 64) is _dense_attention
