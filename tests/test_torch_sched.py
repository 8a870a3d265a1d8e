"""The port's event scheduler and live engine knobs held against the JAX
package's.

Host code is compared exactly: the event scheduler's firing orders,
``drive_loop``'s tick records against ``ControlLoop.run``'s (and against
the reference's on the same scripted episode), ``ScheduledFleetDriver``
against ``FleetDriver`` on the stub fleet, ``parse_knob_names``.  The
knobs run on the CPU at the tiny GPT of ``test_torch_quantize`` (2
layers, d_model 64, f32): greedy replies across a live ``decode_block``
swap equal the no-swap run's exactly and the reference's greedy tokens up
to the first position whose reference top-two margin is under
``BF16_GUARD``.

The reference's ``tests/test_sched.py`` is mirrored by name, except its
two bench tests; the learned knob head's tests (the network, the
checkpoint and ``LearnedKnobPolicy``) are mirrored in
``tests/test_torch_learn.py``.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu import sched as jax_sched
from kube_sqs_autoscaler_tpu.core.clock import FakeClock as JaxClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as JaxLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as JaxLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as JaxPolicy
from kube_sqs_autoscaler_tpu.sched import knobs as jax_knobs
from kube_sqs_autoscaler_tpu_torch import sched
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.durable import ControllerCrash
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop, LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
from kube_sqs_autoscaler_tpu_torch.fleet import FleetDriver, WorkerPool
from kube_sqs_autoscaler_tpu_torch.fleet.sharded import ShardedWorkerPool
from kube_sqs_autoscaler_tpu_torch.fleet.worker import FleetWorker
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.obs import TickJournal, WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.obs.journal import read_journal_events
from kube_sqs_autoscaler_tpu_torch.sched import (
    EventScheduler, ScheduledFleetDriver, drive_loop,
)
from kube_sqs_autoscaler_tpu_torch.sched.knobs import (
    KNOB_DECODE_BLOCK, KNOB_SLOT_LIMIT, KnobActuator, KnobError,
    ReactiveKnobPolicy, parse_knob_names,
)
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
    ContinuousWorker,
)
from kube_sqs_autoscaler_tpu_torch.workloads.service import (
    ServiceConfig, collect_replies,
)
from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
    ShardedBatcher,
)
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import PrefixPool

from .test_torch_quantize import (
    BF16_GUARD, assert_tokens_upto_ties, ref, reference_rollout, tokens,
    weights,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# EventScheduler: deterministic ordering, anchors, cancellation
# ---------------------------------------------------------------------------


def build_trace_run(module, clock_cls):
    clock = clock_cls()
    s = module.EventScheduler(clock)
    seen = []
    s.every("a", 1.0, lambda: seen.append("a"))
    s.every("b", 1.0, lambda: seen.append("b"))  # ties with a
    s.every("hi", 2.0, lambda: seen.append("hi"),
            priority=module.PRIORITY_CONTROL)  # outranks a/b at t=2, 4, ...
    s.at("once", 2.5, lambda: seen.append("once"))
    s.after("later", 3.25, lambda: seen.append("later"),
            priority=module.PRIORITY_KNOB)
    s.run(max_events=24)
    return list(s.trace), seen, s.events_run, s.pending


def test_scheduler_order_is_deterministic_across_runs():
    first = build_trace_run(sched, FakeClock)
    assert first == build_trace_run(sched, FakeClock)
    # the reference's firing order, event for event
    assert first == build_trace_run(jax_sched, JaxClock)
    trace = first[0]
    assert trace[0] == (1.0, "a") and trace[1] == (1.0, "b")
    assert [n for due, n in trace if due == 2.0] == ["hi", "a", "b"]
    assert (2.5, "once") in trace and (3.25, "later") in trace
    assert (sched.PRIORITY_CONTROL, sched.PRIORITY_KNOB,
            sched.PRIORITY_CYCLE, sched.PRIORITY_TIMER) == (
        jax_sched.PRIORITY_CONTROL, jax_sched.PRIORITY_KNOB,
        jax_sched.PRIORITY_CYCLE, jax_sched.PRIORITY_TIMER)


def test_scheduler_anchors_grid_vs_after():
    out = []
    for module, clock_cls in ((sched, FakeClock), (jax_sched, JaxClock)):
        clock = clock_cls()
        s = module.EventScheduler(clock)
        fired = []

        def slow_after(clock=clock, fired=fired):
            fired.append(("after", clock.now()))
            clock.advance(0.6)  # the body consumes clock time

        s.every("grid", 1.0, lambda c=clock, f=fired: f.append(
            ("grid", c.now())), anchor="grid")
        s.every("after", 1.0, slow_after, anchor="after")
        s.run(max_events=6)
        out.append(fired)
    assert out[0] == out[1]
    grid = [t for kind, t in out[0] if kind == "grid"]
    after = [t for kind, t in out[0] if kind == "after"]
    assert grid[:2] == [1.0, 2.0]
    assert after[0] == 1.0 and after[1] == pytest.approx(2.6)


def test_scheduler_cancel_and_one_shots():
    clock = FakeClock()
    s = EventScheduler(clock)
    seen = []
    ev = s.every("rec", 1.0, lambda: seen.append("rec"))
    s.after("shot", 2.5, lambda: seen.append("shot"))
    s.run(max_events=2)
    s.cancel(ev)
    s.run()
    assert seen == ["rec", "rec", "shot"]
    assert s.pending == 0
    s.every("again", 1.0, lambda: s.stop())
    assert s.run() == 1  # a stop ends the run after the current event
    s.reset_stop()
    assert s.run(max_events=1) == 1


@pytest.mark.parametrize("kwargs,match", [
    (dict(anchor="sideways"), "anchor"),
    (dict(period=-1.0), "period"),
], ids=["anchor", "period"])
def test_scheduler_rejects_bad_event_args(kwargs, match):
    s = EventScheduler(FakeClock())
    period = kwargs.pop("period", 1.0)
    with pytest.raises(ValueError, match=match):
        s.every("x", period, lambda: None, **kwargs)
    with pytest.raises(ValueError, match=match):
        jax_sched.EventScheduler(JaxClock()).every("x", period, lambda: None,
                                                   **kwargs)


# ---------------------------------------------------------------------------
# drive_loop: ControlLoop.run as a registered event, byte-identical
# ---------------------------------------------------------------------------


class ScriptedSource:
    """Queue depth as a function of the observation index."""

    def __init__(self, depths):
        self.depths = list(depths)
        self.calls = 0

    def num_messages(self) -> int:
        depth = self.depths[min(self.calls, len(self.depths) - 1)]
        self.calls += 1
        return depth


class RecordingScaler:
    def __init__(self):
        self.calls = []

    def scale_up(self):
        self.calls.append("up")

    def scale_down(self):
        self.calls.append("down")


class Collector:
    def __init__(self):
        self.records = []

    def on_tick(self, record):
        self.records.append(record)


DEPTHS = [0, 50, 150, 200, 150, 40, 5, 5, 0, 0, 120, 130, 5, 5]


def loop_setup(port: bool = True):
    clock = FakeClock() if port else JaxClock()
    loop_cls, config_cls, policy_cls = (
        (ControlLoop, LoopConfig, PolicyConfig) if port
        else (JaxLoop, JaxLoopConfig, JaxPolicy))
    scaler, collector = RecordingScaler(), Collector()
    loop = loop_cls(
        scaler, ScriptedSource(DEPTHS),
        config_cls(poll_interval=5.0, policy=policy_cls(
            scale_up_messages=100, scale_down_messages=10,
            scale_up_cooldown=10.0, scale_down_cooldown=20.0)),
        clock=clock, observer=collector)
    return loop, scaler, collector


def test_drive_loop_matches_run_byte_for_byte():
    loop_a, scaler_a, col_a = loop_setup()
    state_a = loop_a.run(max_ticks=len(DEPTHS))
    loop_b, scaler_b, col_b = loop_setup()
    state_b = drive_loop(loop_b, max_ticks=len(DEPTHS))
    assert col_a.records == col_b.records
    assert scaler_a.calls == scaler_b.calls
    assert state_a == state_b and loop_b.ticks == len(DEPTHS)
    # the reference's scheduled loop on the same script
    loop_r, scaler_r, col_r = loop_setup(port=False)
    jax_sched.drive_loop(loop_r, max_ticks=len(DEPTHS))
    assert [r.to_dict() for r in col_b.records] == [
        r.to_dict() for r in col_r.records]
    assert scaler_b.calls == scaler_r.calls


def test_control_loop_run_delegates_to_scheduler():
    loop_a, scaler_a, col_a = loop_setup()
    loop_a.run(max_ticks=6)
    for scheduler in (True, "own"):
        loop_b, scaler_b, col_b = loop_setup()
        loop_b.run(max_ticks=6, scheduler=(
            EventScheduler(loop_b.clock) if scheduler == "own"
            else scheduler))
        assert col_a.records == col_b.records
        assert scaler_a.calls == scaler_b.calls
    loop_c, _, col_c = loop_setup()
    loop_c.run(max_ticks=2, scheduler=False)  # False: the plain loop
    assert col_c.records == col_a.records[:2]


def test_drive_loop_sticky_stop_and_mid_sleep_stop():
    loop, _, col = loop_setup()
    loop.stop()  # a pre-start stop is sticky, as in run()
    drive_loop(loop, max_ticks=4)
    assert col.records == []
    loop.reset()
    # a stop mid-sleep (before the third tick): that tick is skipped
    loop.clock.at(12.0, loop.stop)
    drive_loop(loop, max_ticks=10)
    assert len(col.records) == 2
    assert drive_loop(loop_setup()[0], max_ticks=0) is not None


def test_drive_loop_fresh_episode_on_shared_scheduler():
    loop, _, col = loop_setup()
    s = EventScheduler(loop.clock)
    drive_loop(loop, max_ticks=3, scheduler=s)
    assert len(col.records) == 3
    drive_loop(loop, max_ticks=2, scheduler=s)
    assert len(col.records) == 5


# ---------------------------------------------------------------------------
# ScheduledFleetDriver against FleetDriver on a stub fleet
# ---------------------------------------------------------------------------


class CycleStubBatcher:
    def __init__(self):
        self.active = 0
        self.free_slots = []
        self.tokens_emitted = 0
        self.decode_block = 1
        # the knob surface the actuator reads and writes
        self.slots = [None, None]
        self.slot_limit = None
        self.spec_overlap = True
        self._block_engine = False

    def set_slot_limit(self, limit):
        self.slot_limit = limit


class CycleStubWorker:
    """A stub replica that serves one request a cycle."""

    def __init__(self, pool):
        self.admitting = True
        self.killed = False
        self.hung = False
        self.processed = 0
        self.batcher = CycleStubBatcher()
        self._pool = pool

    def run_once(self):
        if self.killed or self.hung or not self.admitting:
            return 0
        self.processed += 1
        self.batcher.tokens_emitted += 3
        return 1

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


def stub_fleet(driver_cls, depths, max_cycles=60, **driver_kwargs):
    clock = FakeClock()
    pool = WorkerPool(CycleStubWorker, min=1, max=4, initial=1, clock=clock)
    collector = Collector()
    loop = ControlLoop(
        pool, ScriptedSource(depths),
        LoopConfig(poll_interval=0.1, policy=PolicyConfig(
            scale_up_messages=20, scale_down_messages=2,
            scale_up_cooldown=0.2, scale_down_cooldown=0.4)),
        clock=clock, observer=collector)
    driver = driver_cls(pool, loop, cycle_dt=0.05, **driver_kwargs)
    stats = driver.run(max_cycles=max_cycles)
    return stats, collector.records, [e.name for e in pool.events], pool


def test_scheduled_fleet_driver_matches_fleet_driver():
    depths = [40, 60, 80, 60, 40, 1, 1, 1, 1, 0, 0, 0, 50, 60, 1, 1]
    ref_stats, ref_records, ref_events, _ = stub_fleet(FleetDriver, depths)
    stats, records, events, _ = stub_fleet(ScheduledFleetDriver, depths)
    assert records == ref_records
    assert events == ref_events
    assert stats == ref_stats
    assert ref_stats["replica_trajectory"]  # the episode scaled


def test_scheduled_fleet_driver_until_predicate_position():
    depths = [40, 60, 80, 60, 40, 1, 1]
    results = []
    for cls in (FleetDriver, ScheduledFleetDriver):
        stats, records, events, pool = stub_fleet(cls, depths)
        results.append((stats["cycles"], len(records), events))
        # a predicate stop lands at the same position too
        seen = {"n": 0}

        def until(pool=pool, seen=seen):
            seen["n"] += 1
            return seen["n"] >= 7
        stats2 = cls(pool, None, cycle_dt=0.05).run(until=until)
        results.append(stats2)
    assert results[0] == results[2] and results[1] == results[3]


def test_scheduled_fleet_driver_crash_restart():
    def run(driver_cls):
        clock = FakeClock()

        def build():
            pool = WorkerPool(CycleStubWorker, min=1, max=3, initial=1,
                              clock=clock)
            loop = ControlLoop(
                pool, ScriptedSource([50] * 30),
                LoopConfig(poll_interval=0.1, policy=PolicyConfig(
                    scale_up_messages=20, scale_down_messages=2,
                    scale_up_cooldown=0.2, scale_down_cooldown=0.4)),
                clock=clock)
            return pool, loop

        pool, loop = build()
        ticks = {"n": 0}
        real_tick = loop.tick

        def crashing_tick(state):
            ticks["n"] += 1
            if ticks["n"] == 3:
                raise ControllerCrash("boom")
            return real_tick(state)

        loop.tick = crashing_tick
        driver = driver_cls(pool, loop, cycle_dt=0.05, restart=build,
                            downtime_s=0.3)
        stats = driver.run(max_cycles=30)
        return stats["crashes"], stats["restarts"], stats["cycles"]

    assert run(FleetDriver) == run(ScheduledFleetDriver)
    crashes, restarts, _ = run(ScheduledFleetDriver)
    assert crashes == 1 and restarts == 1


# ---------------------------------------------------------------------------
# Knob parsing, the prune-skip audit, the refused learned policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("csv", [
    "decode-block, slot-limit", "shards,prefix_pool,plane-ratio",
    "speculative", "decode-block,warp-factor", "shards,shards", " , ",
])
def test_parse_knob_names(csv):
    try:
        want = jax_knobs.parse_knob_names(csv)
    except jax_knobs.KnobError as err:
        with pytest.raises(KnobError) as got:
            parse_knob_names(csv)
        assert str(got.value) == str(err)
        return
    assert parse_knob_names(csv) == want
    assert sched.ALL_KNOBS == jax_knobs.ALL_KNOBS
    assert sched.CLI_KNOB_NAMES == jax_knobs.CLI_KNOB_NAMES


def test_learned_knob_policy_names_its_roadmap_item():
    # ported (learn/): exported as the reference exports it, with the
    # reference's ladder check
    from kube_sqs_autoscaler_tpu_torch.sched.knobs import LearnedKnobPolicy

    assert sched.LearnedKnobPolicy is LearnedKnobPolicy
    assert "LearnedKnobPolicy" in sched.__all__
    assert sorted(sched.__all__) == sorted(jax_sched.__all__)
    for ladder in ((), (4, 2), (2, 2, 4)):
        with pytest.raises(KnobError) as got:
            LearnedKnobPolicy(None, None, ladder=ladder)
        with pytest.raises(jax_knobs.KnobError) as want:
            jax_knobs.LearnedKnobPolicy(None, None, ladder=ladder)
        assert str(got.value) == str(want.value)


def test_prune_skips_members_scan_while_under_keep():
    class CountingList(list):
        def __init__(self, items=()):
            super().__init__(items)
            self.iterations = 0

        def __iter__(self):
            self.iterations += 1
            return super().__iter__()

    pool = WorkerPool(lambda p: CycleStubWorker(p), min=1, max=8, initial=2)
    counting = CountingList(pool.members)
    pool.members = counting
    pool.run_cycle()
    healthy_cost = counting.iterations
    pool.scale_up()
    victim = max((r for r in pool.members if r.state == "serving"),
                 key=lambda r: r.index)
    pool.kill_worker(victim.index)
    pool.run_cycle()
    counting.iterations = 0
    pool.run_cycle()
    assert counting.iterations <= healthy_cost
    assert pool._retired_members == 1


# ---------------------------------------------------------------------------
# Real-engine knob mechanics (tiny model, CPU)
# ---------------------------------------------------------------------------

BATCH, PROMPT, TOKENS = 2, 4, 12


@pytest.fixture(scope="module")
def model():
    _, _, tcfg, tp = weights("gpt")
    return tcfg, tp


def make_worker(model, *, decode_block=4, batch=BATCH, url="sched://q",
                **kw):
    config, params = model
    queue, results = FakeMessageQueue(), FakeMessageQueue()
    service = ServiceConfig(
        queue_url=url, batch_size=batch, seq_len=PROMPT,
        generate_tokens=TOKENS, decode_block=decode_block,
        result_queue_url=url + "-r")
    worker = ContinuousWorker(queue, params, config, service,
                              result_queue=results, device="cpu", **kw)
    return worker, queue, results


def prompt_rows(n, seed=0):
    return tokens("gpt", n, PROMPT, seed)


def send_prompts(queue, url, rows):
    return [queue.send_message(url, json.dumps(row.tolist()))
            for row in rows]


def swap_run(model, swaps, rows):
    """Serve ``rows`` at block 4, applying ``swaps`` (cycle -> block) as
    live knob changes; replies by message order."""
    worker, queue, results = make_worker(model)
    ids = send_prompts(queue, "sched://q", rows)
    cycles = 0
    while worker.processed < len(rows):
        worker.run_once()
        cycles += 1
        if cycles in swaps:
            worker.batcher.request_decode_block(swaps[cycles])
    replies, _ = collect_replies(results, "sched://q-r")
    return np.stack([replies[i]["tokens"] for i in ids]), worker


def test_decode_block_swap_mid_stream_greedy_parity(model):
    rows = prompt_rows(6)
    still, _ = swap_run(model, {}, rows)
    swapped, live = swap_run(model, {2: 8, 6: 1}, rows)
    # the block engine's results are block-size independent
    np.testing.assert_array_equal(swapped, still)
    assert live.batcher.decode_block == 1
    assert live.batcher._pending_decode_block is None
    # against the reference's greedy tokens, up to the first near-tie
    jcfg, jp, _, _ = weights("gpt")
    want, margins = reference_rollout(
        lambda: ref("gpt", "prefill")(jp, jnp.asarray(rows), config=jcfg),
        lambda cache, token: ref("gpt", "decode_step")(jp, cache, token,
                                                       config=jcfg),
        TOKENS)
    assert_tokens_upto_ties(swapped, want, margins, BF16_GUARD["gpt"])


def test_decode_block_swap_applies_at_redispatch_boundary(model):
    worker, queue, _ = make_worker(model)
    send_prompts(queue, "sched://q", prompt_rows(2))
    worker.run_once()  # admit, dispatch a block of 4
    assert worker.batcher._pending_block is not None
    dispatches = worker.batcher.decode_dispatches
    worker.batcher.request_decode_block(8)
    assert worker.batcher.decode_block == 4  # staged, not applied
    worker.run_once()  # settles the block in flight, skips the dispatch
    assert worker.batcher.decode_dispatches == dispatches
    assert worker.batcher.decode_block == 8  # landed at the boundary
    assert worker.batcher._pending_block is None
    worker.run_once()  # the next dispatch runs at the new size
    assert worker.batcher.decode_dispatches == dispatches + 1
    while worker.processed < 2:
        worker.run_once()


def test_decode_block_swap_on_idle_engine_is_immediate(model):
    worker, _, _ = make_worker(model)
    assert worker.batcher.request_decode_block(16)
    assert worker.batcher.decode_block == 16
    assert worker.batcher.request_decode_block(16) is False


def test_decode_block_knob_needs_block_engine(model):
    worker, _, _ = make_worker(model, decode_block=1)
    with pytest.raises(ValueError, match="block/gang"):
        worker.batcher.request_decode_block(4)


def test_slot_limit_caps_admission_and_drains(model):
    worker, queue, _ = make_worker(model)
    worker.batcher.set_slot_limit(1)
    send_prompts(queue, "sched://q", prompt_rows(4))
    worker.run_once()
    assert worker.batcher.active == 1  # capped below batch_size 2
    worker.batcher.set_slot_limit(None)
    worker.run_once()
    assert worker.batcher.active == 2
    with pytest.raises(ValueError, match="slot_limit"):
        worker.batcher.set_slot_limit(99)
    while worker.processed < 4:
        worker.run_once()


def test_sharded_slot_limit_caps_per_shard(model):
    config, params = model
    batcher = ShardedBatcher(params, config, shards=2, shard_slots=2,
                             prompt_len=PROMPT, generate_tokens=TOKENS,
                             decode_block=2, device="cpu")
    batcher.set_slot_limit(1)
    assert batcher._free_slot_count() == 2  # one a shard
    rows = batcher.submit_many([(row, {"i": i}) for i, row in
                                enumerate(prompt_rows(2))])
    assert sorted(r // 2 for r in rows) == [0, 1]
    assert batcher._free_slot_count() == 0
    batcher.set_slot_limit(2)
    assert batcher._free_slot_count() == 2


def test_refill_uses_cheap_capacity_not_routed_ordering(model):
    config, params = model
    queue = FakeMessageQueue()
    service = ServiceConfig(queue_url="sched://s", batch_size=2,
                            seq_len=PROMPT, generate_tokens=TOKENS,
                            decode_block=2, shards=2)
    worker = ContinuousWorker(queue, params, config, service, device="cpu")
    assert isinstance(worker.batcher, ShardedBatcher)
    send_prompts(queue, "sched://s", prompt_rows(4))
    before = worker.batcher.free_slot_scans
    worker.run_once()  # admits 4: one routed ordering
    assert worker.batcher.free_slot_scans - before == 1
    before = worker.batcher.free_slot_scans
    worker.run_once()  # slots full: no routed ordering
    assert worker.batcher.free_slot_scans == before
    while worker.processed < 4:
        worker.run_once()


def test_spec_overlap_toggle_parity(model):
    def run(overlap):
        worker, queue, results = make_worker(
            model, decode_block=1, url="sched://sp", draft_layers=1,
            draft_tokens=2)
        worker.batcher.set_speculative(overlap)
        send_prompts(queue, "sched://sp", prompt_rows(3, seed=2))
        while worker.processed < 3:
            worker.run_once()
        replies, _ = collect_replies(results, "sched://sp-r")
        return sorted(p["tokens"] for p in replies.values())

    assert run(True) == run(False)  # overlap is scheduling, not results


def test_speculative_knob_needs_draft_engine(model):
    worker, _, _ = make_worker(model)
    with pytest.raises(ValueError, match="draft"):
        worker.batcher.set_speculative(False)


def test_prefix_pool_capacity_knob(model):
    config, params = model
    pool = PrefixPool(params, config, entries=4, prefix_len=PROMPT,
                      device="cpu")
    rng = np.random.default_rng(1)

    def acquire(tag):
        return pool.acquire(0, ("t", tag), rng.integers(0, 96, PROMPT))

    for tag in range(4):
        acquire(tag)
    assert len(pool._lru[0]) == 4
    assert pool.set_capacity(2) == 2 and pool.capacity == 2
    assert len(pool._lru[0]) == 2
    acquire(9)  # an install at the ceiling evicts the LRU victim
    assert len(pool._lru[0]) == 2
    pool.set_capacity(4)  # growing evicts nothing
    acquire(10)
    assert len(pool._lru[0]) == 3
    with pytest.raises(ValueError, match="capacity"):
        pool.set_capacity(5)


def test_knob_actuator_end_to_end(model, tmp_path):
    worker, _, _ = make_worker(model)
    path = str(tmp_path / "knobs.jsonl")
    journal = TickJournal(path, meta={"s": 1})
    metrics = WorkloadMetrics()
    clock = FakeClock(7.0)
    actuator = KnobActuator(worker, armed=(KNOB_DECODE_BLOCK,
                                           KNOB_SLOT_LIMIT),
                            journal=journal, metrics=metrics, clock=clock)
    assert actuator.set(KNOB_DECODE_BLOCK, 8)
    assert actuator.set(KNOB_SLOT_LIMIT, 1)
    applied = actuator.apply()
    assert [c["knob"] for c in applied] == [KNOB_DECODE_BLOCK,
                                            KNOB_SLOT_LIMIT]
    assert applied[0] == {"knob": KNOB_DECODE_BLOCK, "value": 8,
                          "previous": 4, "t": 7.0}
    assert worker.batcher.decode_block == 8
    assert worker.batcher.slot_limit == 1
    assert actuator.set(KNOB_DECODE_BLOCK, 8) is False
    assert actuator.apply() == []
    journal.close()
    events = read_journal_events(path, "knob")
    assert [(e["knob"], e["value"]) for e in events] == [
        (KNOB_DECODE_BLOCK, 8), (KNOB_SLOT_LIMIT, 1)]
    rendered = metrics.render()
    assert 'engine_knob{knob="decode_block"} 8' in rendered
    assert 'engine_knob{knob="slot_limit"} 1' in rendered
    assert "engine_knob_changes_total 2" in rendered
    trace = actuator.trace_events()
    assert trace and all(e["cat"] == "knob" for e in trace)
    assert worker.config.decode_block == 8
    state = actuator.export_state()
    assert state == {"records": 2, "changes_total": 2,
                     "knobs": {KNOB_DECODE_BLOCK: 8, KNOB_SLOT_LIMIT: 1}}
    worker2, _, _ = make_worker(model, decode_block=8)
    worker2.batcher.adopt_engine(worker.batcher)
    actuator2 = KnobActuator(worker2, armed=(KNOB_DECODE_BLOCK,
                                             KNOB_SLOT_LIMIT))
    assert actuator2.import_state(state) == 2
    actuator2.apply()
    assert worker2.batcher.decode_block == 8
    assert worker2.batcher.slot_limit == 1


@pytest.mark.parametrize("armed,decode_block,match", [
    (("decode_block",), 1, "block/gang"),
    (("shards",), 4, "sharded"),
    (("speculative",), 4, "draft-and-verify"),
    (("prefix_pool",), 4, "prefix pool"),
    (("plane_ratio",), 4, "disaggregated pool"),
    (("warp",), 4, "unknown knob"),
], ids=["decode-block", "shards", "speculative", "prefix-pool",
        "plane-ratio", "unknown"])
def test_knob_actuator_arm_time_validation(model, armed, decode_block,
                                           match):
    worker, _, _ = make_worker(model, decode_block=decode_block)
    with pytest.raises(KnobError, match=match):
        KnobActuator(worker, armed=armed)


def sharded_pool(model, *, initial, url, **kw):
    config, params = model
    queue = FakeMessageQueue()
    service = ServiceConfig(queue_url=url, batch_size=2, seq_len=PROMPT,
                            generate_tokens=TOKENS, decode_block=2,
                            shards=3)
    return ShardedWorkerPool(
        lambda p: FleetWorker(queue, params, config, service, pool=p,
                              device="cpu"),
        min=1, max=3, initial=initial, **kw)


def test_shards_knob_through_sharded_pool(model):
    pool = sharded_pool(model, initial=3, url="sched://sh")
    actuator = KnobActuator(pool, armed=("shards",))
    actuator.set("shards", 1)
    actuator.apply()
    assert pool.replicas == 1
    assert pool.worker.batcher.shard_admitting == [True, False, False]
    actuator.set("shards", 3)
    actuator.apply()
    assert pool.replicas == 3
    with pytest.raises(KnobError, match="shards must be in"):
        actuator.set("shards", 4)


def test_shards_knob_converges_with_multi_pod_scale_steps(model):
    pool = sharded_pool(model, initial=1, url="sched://sh2",
                        scale_up_pods=2, scale_down_pods=2)
    actuator = KnobActuator(pool, armed=("shards",))
    actuator.set("shards", 2)
    actuator.apply()
    assert pool.replicas == 2  # exactly, not 1 or 3
    assert (pool.scale_up_pods, pool.scale_down_pods) == (2, 2)


def test_shards_knob_on_a_bare_plane_flips_masks(model):
    config, params = model
    queue = FakeMessageQueue()
    service = ServiceConfig(queue_url="sched://bp", batch_size=2,
                            seq_len=PROMPT, generate_tokens=TOKENS,
                            decode_block=2, shards=3)
    worker = ContinuousWorker(queue, params, config, service, device="cpu")
    actuator = KnobActuator(worker, armed=("shards",))
    actuator.set("shards", 1)
    actuator.apply()
    assert worker.batcher.shard_admitting == [True, False, False]
    actuator.set("shards", 2)
    actuator.apply()
    assert worker.batcher.shard_admitting == [True, True, False]


def test_reactive_knob_policy_hysteresis(model):
    worker, _, _ = make_worker(model)
    actuator = KnobActuator(worker, armed=(KNOB_DECODE_BLOCK,))
    depth = {"v": 0}
    policy = ReactiveKnobPolicy(actuator, lambda: depth["v"], high=10,
                                low=2, block_high=16, block_low=2)
    for value, want in ((50, 16), (5, 16), (1, 2)):
        depth["v"] = value
        policy.evaluate()
        actuator.apply()
        assert worker.batcher.decode_block == want
    with pytest.raises(KnobError):
        ReactiveKnobPolicy(actuator, lambda: 0, high=1, low=2)


# ---------------------------------------------------------------------------
# The binary's arming rejections (args-only: no model is built)
# ---------------------------------------------------------------------------

BASE = ["--continuous", "--generate-tokens", "4"]
FLEET = BASE + ["--scheduler", "--fleet-max-replicas", "2", "--demo", "1",
                "--decode-block", "4"]


@pytest.mark.parametrize("argv,match", [
    (BASE + ["--scheduler"], "requires --fleet-max-replicas"),
    (["--knobs", "decode-block"], "requires --continuous"),
    (BASE + ["--knobs", "decode-block"], "requires --scheduler"),
    (FLEET + ["--knobs", "warp-factor"], "unknown knob"),
    (BASE + ["--scheduler", "--fleet-max-replicas", "2", "--demo", "1",
             "--beams", "2", "--knobs", "speculative"],
     "does not combine with --beams"),
    (FLEET + ["--knobs", "speculative"],
     "requires --speculative-draft-layers"),
    (BASE + ["--scheduler", "--fleet-max-replicas", "2", "--demo", "1",
             "--knobs", "decode-block"], "block/gang decode"),
    (FLEET + ["--knobs", "decode-block", "--speculative-draft-layers", "1"],
     "plain continuous decode path"),
    (FLEET + ["--knobs", "shards"], "sharded plane"),
    (FLEET + ["--knobs", "prefix-pool"], "requires --prefix-pool"),
    (["--journal-path", "j.jsonl"], "records the fleet control loop"),
    (["--topology", "ring"], "--topology requires --continuous"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_cli_scheduler_and_knob_rejections(argv, match):
    from kube_sqs_autoscaler_tpu.workloads.__main__ import main as jax_main

    for main, extra in ((binary, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit, match=match):
            main(argv + extra)


def test_binary_scheduler_knobs_journal_serve_the_fleet(tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    argv = ["--device", "cpu", "--demo", "6", "--seq-len", "8",
            "--generate-tokens", "3", "--batch-size", "2", "--continuous",
            "--decode-block", "2", "--fleet-max-replicas", "2",
            "--result-queue-url", "demo://replies", "--journal-path", path]
    plain = binary(argv[:-2])
    summary = binary(argv + ["--scheduler", "--knobs",
                             "decode-block,slot-limit"])
    assert summary["processed"] == plain["processed"] == 6
    assert len(summary["replies"]) == 6 and summary["duplicate_replies"] == 0
    assert {k: v["tokens"] for k, v in summary["replies"].items()} == {
        k: v["tokens"] for k, v in plain["replies"].items()}
    header = json.loads(open(path).readline())
    assert header["meta"]["sched"] == {
        "scheduler": True, "knobs": ["decode_block", "slot_limit"]}
    knob_lines = read_journal_events(path, "knob")
    assert [e["knob"] for e in knob_lines] == [
        c["knob"] for c in summary["knob_changes"]]


def test_binary_topology_attaches_a_routed_scheduler():
    summary = binary(["--device", "cpu", "--demo", "4", "--seq-len", "8",
                      "--generate-tokens", "3", "--batch-size", "2",
                      "--continuous", "--decode-block", "2", "--shards", "2",
                      "--topology", "torus"])
    assert summary["processed"] == 4
    cc = summary["comms"]
    assert cc["routing"]["routed_ops"] > 0
    assert cc["by_kind"]["settle_pull"] > 0 and cc["pending"] == 0


# ---------------------------------------------------------------------------
# Whole-fleet outages, restarts and spawns
# ---------------------------------------------------------------------------


def test_knob_actuator_survives_whole_fleet_outage():
    pool = WorkerPool(lambda p: CycleStubWorker(p), min=1, max=2, initial=1)
    actuator = KnobActuator(pool, armed=(KNOB_SLOT_LIMIT,))
    depth = {"v": 0}
    policy = ReactiveKnobPolicy(actuator, lambda: depth["v"], high=10, low=2)
    actuator.set(KNOB_SLOT_LIMIT, 1)
    pool.kill_worker(0)
    pool.run_cycle()  # declares the only replica dead
    assert actuator.apply() == []  # kept, not raised, not dropped
    assert actuator.pending == {KNOB_SLOT_LIMIT: 1}
    policy.evaluate()  # skipped, not fatal
    with pytest.raises(KnobError, match="no live workers"):
        actuator.set(KNOB_SLOT_LIMIT, 2)
    pool.scale_up()
    applied = actuator.apply()
    assert [c["knob"] for c in applied] == [KNOB_SLOT_LIMIT]
    assert pool.members[-1].worker.batcher.slot_limit == 1


def test_knob_actuator_retargets_after_crash_restart(model):
    worker_a, _, _ = make_worker(model)
    worker_b, _, _ = make_worker(model, decode_block=4)
    worker_b.batcher.adopt_engine(worker_a.batcher)
    actuator = KnobActuator(worker_a, armed=(KNOB_DECODE_BLOCK,))
    actuator.set(KNOB_DECODE_BLOCK, 8)
    actuator.retarget(worker_b)
    actuator.apply()
    assert worker_b.batcher.decode_block == 8
    assert worker_a.batcher.decode_block == 4  # the corpse untouched


def test_knob_reconcile_covers_replicas_spawned_after_change():
    pool = WorkerPool(lambda p: CycleStubWorker(p), min=1, max=3, initial=1)
    actuator = KnobActuator(pool, armed=(KNOB_SLOT_LIMIT,))
    actuator.set(KNOB_SLOT_LIMIT, 1)
    actuator.apply()
    pool.scale_up()  # a fresh replica at the default
    fresh = pool.members[-1].worker.batcher
    assert fresh.slot_limit is None
    assert actuator.apply() == []  # no new change, reconcile only
    assert fresh.slot_limit == 1
    assert actuator.changes_total == 1


def test_scheduled_fleet_driver_knobs_land_between_cycles():
    """The knob safe point: a change staged mid-episode applies at the
    next cycle boundary, and the driver retargets after a restart."""
    clock = FakeClock()
    pools = []

    def build():
        pool = WorkerPool(CycleStubWorker, min=1, max=3, initial=1,
                          clock=clock)
        pools.append(pool)
        loop = ControlLoop(
            pool, ScriptedSource([50] * 40),
            LoopConfig(poll_interval=0.1, policy=PolicyConfig(
                scale_up_messages=20, scale_down_messages=2,
                scale_up_cooldown=0.2, scale_down_cooldown=0.4)),
            clock=clock)
        return pool, loop

    pool, loop = build()
    actuator = KnobActuator(pool, armed=(KNOB_SLOT_LIMIT,), clock=clock)
    ticks = {"n": 0}
    real_tick = loop.tick

    def tick(state):
        ticks["n"] += 1
        if ticks["n"] == 2:
            actuator.set(KNOB_SLOT_LIMIT, 1)
        if ticks["n"] == 4:
            raise ControllerCrash("boom")
        return real_tick(state)

    loop.tick = tick
    driver = ScheduledFleetDriver(pool, loop, cycle_dt=0.05, knobs=actuator,
                                  restart=build, downtime_s=0.1)
    stats = driver.run(max_cycles=30)
    assert stats["restarts"] == 1 and actuator.changes_total == 1
    assert actuator._target is pools[-1]
    assert all(r.worker.batcher.slot_limit == 1 for r in pools[-1].members)


def test_replicas_spawned_after_a_decode_block_change_serve_at_it(model):
    """A replica spawned after a live decode_block change adopts the
    donor's engine and serves at the actuated size.  (The reference's
    spawn builds from its base service config at the old size, so the
    donor's engine key no longer matches and the spawn fails; the port's
    pool is told the actuated size.)"""
    config, params = model
    queue, results = FakeMessageQueue(), FakeMessageQueue()
    service = ServiceConfig(queue_url="sched://sp2", batch_size=2,
                            seq_len=PROMPT, generate_tokens=TOKENS,
                            decode_block=4, result_queue_url="sched://sp2-r")
    pool = WorkerPool.serving(queue, params, config, service,
                              result_queue=results, min=1, max=3,
                              device="cpu")
    assert pool.spawn_decode_block is None
    actuator = KnobActuator(pool, armed=(KNOB_DECODE_BLOCK,))
    actuator.set(KNOB_DECODE_BLOCK, 2)
    actuator.apply()
    assert pool.spawn_decode_block == 2
    ids = send_prompts(queue, "sched://sp2", prompt_rows(6, seed=4))
    pool.scale_up()
    pool.scale_up()
    assert pool.replicas == 3
    assert [r.worker.batcher.decode_block for r in pool.members] == [2, 2, 2]
    assert all(r.worker.config.decode_block == 2 for r in pool.members)
    for _ in range(200):
        pool.run_cycle()
        if pool.processed >= 6 and pool.idle:
            break
    replies, duplicates = collect_replies(results, "sched://sp2-r")
    assert sorted(replies) == sorted(ids) and duplicates == 0
    still, _ = swap_run(model, {}, prompt_rows(6, seed=4))
    np.testing.assert_array_equal(
        np.stack([replies[i]["tokens"] for i in ids]), still)
