"""The port's span recorder and the serving worker's phase spans and
counters, on the CPU at a tiny width; and the benchmark's reduction of
those spans against a device trace (``portbench/phases.py``) on synthetic
records."""

import json

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.obs.prometheus import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.utils.profiling import (
    SPAN_RING,
    Span,
    SpanTimer,
)
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, service
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig,
    init_params,
)
from portbench import phases

URL, REPLIES = "fake://jobs", "fake://replies"
SLOTS, BUCKET, TOKENS = 3, 16, 5
PHASES = {"cycle", "receive", "insert", "insert.stage", "insert.launch",
          "step", "block.launch", "wait.first", "wait.block", "emit",
          "reply"}


class _Clock:
    """A monotonic clock that advances one second per read, with the
    epoch clock 1000 s ahead of it."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        self.now += 1.0
        return self.now

    def time(self):
        return self.now + 1000.0


# -- SpanTimer ------------------------------------------------------------------


def test_span_timer_ring_stays_bounded_and_summary_keeps_its_keys():
    timer = SpanTimer(clock=_Clock())
    n = SPAN_RING + 5
    for _ in range(n):
        with timer.span("tick"):
            pass
    spans = timer.spans()
    assert len(spans) == SPAN_RING and len(timer._ring) == SPAN_RING
    # the oldest fell out; times come back on the epoch clock
    assert spans[0].id == 5 and spans[-1].id == n - 1
    assert spans[-1].end - spans[-1].start == 1.0
    assert abs(spans[-1].end - (2.0 * n + 1000.0)) <= 1.0
    summary = timer.summary()["tick"]
    assert set(summary) == {"count", "total_s", "mean_s", "p50_s", "p99_s",
                            "max_s"}
    # count and total over the timer's life, quantiles over the ring
    assert summary["count"] == n and summary["total_s"] == float(n)
    assert summary["mean_s"] == summary["p50_s"] == summary["max_s"] == 1.0
    timer.reset()
    assert timer.summary() == {} and timer.spans() == []


def test_span_timer_records_parents_links_and_drops_abandoned_children():
    timer = SpanTimer(clock=_Clock())
    with timer.span("outer") as outer:
        assert timer.current() == outer
        with timer.span("inner", link=41) as inner:
            assert timer.current() == inner
        timer.begin("left open")  # an exception would leave it so
    assert timer.current() is None
    got = {s.name: s for s in timer.spans()}
    assert set(got) == {"outer", "inner"}
    assert got["inner"].parent == outer and got["outer"].parent is None
    assert got["inner"].link == 41
    assert got["outer"].start < got["inner"].start < got["inner"].end \
        < got["outer"].end


def test_metrics_port_renders_cycle_quantiles_past_the_ring():
    timer = SpanTimer(clock=_Clock())
    n = SPAN_RING + 10
    for _ in range(n):
        with timer.span("cycle"):
            pass
    metrics = WorkloadMetrics()
    metrics.attach_timer("worker", timer)
    text = metrics.render()
    base = "kube_sqs_autoscaler_workload_worker_cycle_seconds"
    assert f'{base}{{quantile="0.5"}} 1.0' in text
    assert f'{base}{{quantile="0.99"}} 1.0' in text
    assert f"{base}_count {n}" in text and f"{base}_sum {float(n)}" in text


# -- the worker's phase spans and counters ------------------------------------------


def _worker(decode_block: int, bodies: list[str]):
    config = ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1,
                         d_ff=64, max_seq_len=BUCKET + TOKENS,
                         dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0), "cpu")
    jobs, replies = FakeMessageQueue(), FakeMessageQueue()
    for body in bodies:
        jobs.send_message(URL, body)
    svc = service.ServiceConfig(
        queue_url=URL, result_queue_url=REPLIES, batch_size=SLOTS,
        seq_len=BUCKET, generate_tokens=TOKENS, decode_block=decode_block)
    worker = continuous.ContinuousWorker(jobs, params, config, svc,
                                         result_queue=replies, device="cpu")
    return worker, replies


def _bodies(n: int = 8) -> list[str]:
    rng = np.random.default_rng(3)
    # one prompt longer than the bucket: it is cut to it
    lengths = [int(x) for x in rng.integers(1, BUCKET, n - 1)] + [BUCKET + 4]
    return [json.dumps([int(t) for t in rng.integers(1, 64, k)])
            for k in lengths]


def _serve(decode_block: int, record: bool):
    """Drain :func:`_bodies` cycle by cycle; returns (replies by id,
    worker, timer or None, cycles run, counters before the first cycle)."""
    worker, replies = _worker(decode_block, _bodies())
    timer = None
    if record:
        timer = SpanTimer()
        worker.attach_spans(timer)
    before = phases.counters(worker.batcher)
    cycles = 0
    while worker.processed < len(_bodies()) and cycles < 200:
        worker.run_once()
        cycles += 1
    raw = {json.loads(m["Body"])["request_id"]: m["Body"]
           for m in replies.receive_messages(REPLIES, max_messages=100)}
    return raw, worker, timer, cycles, before


@pytest.mark.parametrize("decode_block", [1, 3])
def test_recording_leaves_replies_equal_and_off_records_nothing(
        decode_block):
    off, worker, _, _, _ = _serve(decode_block, record=False)
    on, _, timer, _, _ = _serve(decode_block, record=True)
    assert len(off) == len(_bodies()) and on == off
    assert worker.spans is None and worker.batcher.spans is None
    assert worker.timer.summary() == {}
    assert {s.name for s in timer.spans()} <= PHASES
    # detached again, a cycle records nothing more
    worker.attach_spans(timer)
    worker.attach_spans(None)
    count = len(timer.spans())
    worker.run_once()
    assert len(timer.spans()) == count


@pytest.mark.parametrize("decode_block", [1, 3])
def test_phase_spans_nest_and_count_as_the_engine_does(decode_block):
    _, worker, timer, cycles, before = _serve(decode_block, record=True)
    spans = timer.spans()
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert names.count("cycle") == cycles
    assert {"receive", "insert", "insert.stage", "insert.launch", "step",
            "block.launch", "wait.first", "wait.block", "emit",
            "reply"} <= set(names)
    for s in spans:
        if s.name == "cycle":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.start <= s.start <= s.end <= parent.end
        expected = {"insert.stage": "insert", "insert.launch": "insert",
                    "block.launch": "step", "wait.first": "step",
                    "wait.block": "step", "emit": "step"}
        assert parent.name == expected.get(s.name, "cycle")
    after = phases.counters(worker.batcher)
    change = phases.delta(before, after)
    # the plain path without comms: one wait per host transfer, one
    # insert launch per insert dispatch, one block launch per dispatch
    waits = [s for s in spans if s.name.startswith("wait.")]
    assert len(waits) == change["host_transfers"]
    assert names.count("insert.launch") == change["insert_dispatches"]
    assert names.count("block.launch") == change["decode_dispatches"]
    for wait in waits:
        launch = by_id[wait.link]
        assert launch.name == ("insert.launch" if wait.name == "wait.first"
                               else "block.launch")
        assert launch.end <= wait.start


@pytest.mark.parametrize("decode_block", [1, 3])
def test_counters_match_the_inputs(decode_block):
    _, worker, _, _, before = _serve(decode_block, record=False)
    change = phases.delta(before, phases.counters(worker.batcher))
    lengths = [min(len(json.loads(b)), BUCKET) for b in _bodies()]
    assert change["insert_rows"] == len(lengths)
    assert change["insert_prompt_tokens"] == sum(lengths)
    assert change["insert_padded_tokens"] == len(lengths) * BUCKET
    if decode_block > 1:
        assert change["decode_steps"] == (decode_block
                                          * change["decode_dispatches"])
        # rows are counted as a block settles; the last block dispatched
        # (every row frozen) is still in flight when the queue is drained
        assert change["decode_row_steps"] == (
            SLOTS * decode_block * change["block_settles"])
        assert change["block_settles"] == change["decode_dispatches"] - 1
    else:
        assert change["decode_steps"] == change["decode_dispatches"]
        assert change["decode_row_steps"] == SLOTS * change["decode_steps"]
    # every token after the first comes out of a decode step
    assert change["block_tokens"] == len(lengths) * (TOKENS - 1)
    record = {"program": {"counters": change, "device_s": {}}}
    assert 0 < phases.slot_occupancy(record) <= 100.0
    assert change["tokens_emitted"] == len(lengths) * TOKENS


def test_attach_spans_refuses_the_worker_timer():
    worker, _ = _worker(2, [])
    with pytest.raises(ValueError, match="of its own"):
        worker.attach_spans(worker.timer)


# -- the benchmark's reduction ---------------------------------------------------


def _span(id, name, start, end, parent=None, link=None):
    """A span with times given in microseconds."""
    return Span(id, name, start / 1e6, end / 1e6, parent, link)


SPANS = [
    _span(0, "cycle", 0, 100),
    _span(1, "insert", 10, 40, parent=0),
    _span(2, "insert.launch", 20, 40, parent=1),
    _span(3, "step", 50, 90, parent=0),
    _span(4, "block.launch", 50, 60, parent=3),
    _span(5, "wait.block", 70, 80, parent=3, link=4),
    _span(6, "cycle", 200, 300),
]
# (name, start, end, correlation); launches by correlation
OPS = [("gemm", 25, 45, 1), ("Memcpy DtoH (Device -> Pinned)", 45, 46, 2),
       ("step", 60, 70, 3), ("Memcpy DtoH (Device -> Pinned)", 70, 72, 4),
       ("lost", 150, 160, 5), ("late", 290, 350, 6)]
LAUNCHES = {1: 25.0, 2: 30.0, 3: 55.0, 4: 58.0, 5: 150.0, 6: 250.0}


def test_attribute_puts_device_time_down_to_the_launching_span():
    found = phases.attribute(OPS, LAUNCHES, SPANS, (0.0, 300.0))
    seconds = {k: round(v * 1e6, 6) for k, v in found["device_s"].items()}
    # each op's launcher and its ancestors; "late" is clipped at 300
    assert seconds == {"insert.launch": 21.0, "insert": 21.0,
                       "block.launch": 12.0, "step": 12.0, "cycle": 43.0}
    assert round(found["self_s"][phases.OUTSIDE] * 1e6, 6) == 10.0
    assert found["attributed_share"] == pytest.approx(100 * 43 / 53)
    assert found["busy_s"] == pytest.approx(53e-6)
    idle = {k: round(v * 1e6, 6) for k, v in found["idle_by_span"].items()}
    # gaps begin at 46 (between insert and step: in cycle),
    # 72 (in wait.block) and 160 (outside every span)
    assert idle == {"cycle": 14.0, "wait.block": 78.0, phases.OUTSIDE: 130.0}
    assert phases.attribute([], {}, SPANS, (0.0, 1.0))[
        "attributed_share"] is None


def test_wait_lags_and_sync_offsets_compare_the_clocks():
    found = phases.attribute(OPS, LAUNCHES, SPANS, (0.0, 300.0))
    # the wait ends at 80, its block's copy at 72
    assert phases.wait_lags_us(OPS, found["launcher"], SPANS) == [8.0]
    runtime = [("cudaEventSynchronize", 71.0, 77.0),
               ("cudaLaunchKernel", 20.0, 30.0)]
    assert phases.sync_offsets_us(runtime, SPANS) == [(1.0, 3.0)]
    by_span = phases.runtime_by_span(runtime, SPANS)
    assert set(by_span) == {"wait.block", "insert.launch"}


def test_host_ms_by_phase_splits_total_and_self_time():
    got = phases.host_ms_by_phase(SPANS, (0.0, 300.0))
    # two cycles in the bounds: per cycle, ms
    assert got["cycle"]["total_ms"] == pytest.approx(0.1)
    assert got["cycle"]["self_ms"] == pytest.approx((200 - 70) / 2e3)
    assert got["step"]["self_ms"] == pytest.approx(20 / 2e3)


@pytest.mark.parametrize("name", sorted(phases.READERS))
def test_phase_readers_read_nothing_from_an_empty_record(name):
    read = phases.READERS[name]
    assert read({}) is None and read(None) is None
    empty = {"program": {"counters": dict.fromkeys(phases.COUNTERS, 0),
                         "device_s": {}}}
    assert read(empty) is None


def test_phase_readers_read_a_synthetic_record():
    counters = dict.fromkeys(phases.COUNTERS, 0)
    counters.update(insert_rows=10, insert_prompt_tokens=400,
                    insert_padded_tokens=1000, decode_steps=16,
                    decode_row_steps=160, block_tokens=40)
    record = {"program": {"counters": counters,
                          "device_s": {"insert": 2.0, "block.launch": 0.8}}}
    assert phases.prefill_ms_per_row(record) == pytest.approx(200.0)
    assert phases.decode_ms_per_step(record) == pytest.approx(50.0)
    assert phases.slot_occupancy(record) == pytest.approx(25.0)
    assert phases.prompt_fill(record) == pytest.approx(40.0)
    # no device time found for a phase: no reading
    record["program"]["device_s"] = {}
    assert phases.prefill_ms_per_row(record) is None
    assert phases.decode_ms_per_step(record) is None
