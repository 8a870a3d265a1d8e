"""Queue-fed serving: the port's ``ContinuousWorker`` drains the mix.

The mix's ``arrivals`` picks the loop:

- ``backlog``: a closed backlog, the autoscaler's own regime.  The queue
  never runs dry (it is topped up to ``backlog_depth`` visible messages
  before every cycle).  Set-up fills the slots ``stagger`` a cycle, so
  that they finish a few at a time, every block, as slots of requests of
  mixed lengths would, rather than all in one cohort; then it runs until
  ``warmup_answers`` messages are answered, so every insert and block
  shape is built, and the window opens on the next cycle, in the drain's
  steady state.
- ``rate``: an open loop.  Messages become visible when they are due
  (:func:`..traffic.arrivals`), whether or not the worker keeps up.
  Set-up is ``warmup_periods`` whole periods of the same load; the window
  follows without a break.  Each request is timed from when it was due,
  and how late the generator made it visible is recorded.  After the
  window the load goes on until every request due in it is answered, or
  ``tail_s`` passes.

The window drives ``ContinuousWorker.run_once`` and nothing else of the
program.  Once it has closed, and the program's state is freed, a seeded
sample of the answered requests (the longest prompt among them) goes to
the plain reference, which reads each prompt with its served tokens.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import correct, models, sqs, traffic

CLOCK = time.perf_counter
# how long before the window opens the traced run starts the profiler
TRACE_LEAD_S = 8.0


class _Backlog:
    def __init__(self, queue, prompts, depth: int) -> None:
        self.queue, self.prompts, self.depth = queue, prompts, depth
        self.ids: dict[str, np.ndarray] = {}

    def feed(self, now: float, depth: int | None = None) -> float:
        """Top the queue up to ``depth`` visible messages (default the
        mix's); returns how late the feed ran (always 0)."""
        missing = (self.depth if depth is None else depth) - self.queue.depth()
        if missing > 0:
            for ids in self.prompts.take(missing):
                mid = f"m{len(self.ids)}"
                self.ids[mid] = ids
                self.queue.send(mid, traffic.body(ids), now)
        return 0.0

    def next_due(self) -> float | None:
        return None


class _Rate:
    def __init__(self, queue, prompts, dues: list[float]) -> None:
        self.queue, self.dues = queue, dues
        self.bodies = prompts.take(len(dues))
        self.ids: dict[str, np.ndarray] = {}
        self._next = 0

    def feed(self, now: float) -> float:
        """Make every message due by ``now`` visible; returns how late the
        earliest of them became visible (seconds)."""
        late = 0.0
        while self._next < len(self.dues) and self.dues[self._next] <= now:
            i = self._next
            mid = f"m{i}"
            self.ids[mid] = self.bodies[i]
            self.queue.send(mid, traffic.body(self.bodies[i]), self.dues[i])
            late = max(late, now - self.dues[i])
            self._next += 1
        return late

    def next_due(self) -> float | None:
        return self.dues[self._next] if self._next < len(self.dues) else None


def _spans(worker, spans: list, inserts: list) -> None:
    """The traced run's host spans around the worker's calls into the
    engine (``(start_ns, end_ns, name)`` on the epoch clock the profiler
    uses), and a log of each insert's real prompt lengths."""

    def wrap(obj, name, label, log=None):
        inner = getattr(obj, name)

        def wrapped(*args, **kwargs):
            if log is not None:
                log.append([len(ids) for ids, _ in args[0]])
            start = time.time_ns()
            try:
                return inner(*args, **kwargs)
            finally:
                spans.append((start, time.time_ns(), label))

        setattr(obj, name, wrapped)

    wrap(worker, "_refill", "worker.refill")
    wrap(worker, "_settle", "worker.settle")
    wrap(worker.batcher, "submit_many", "engine.insert", inserts)
    wrap(worker.batcher, "step", "engine.step")


class _GcPauses:
    """Python's collector in the window: how often it ran and for how
    long (a pause the host's clock would charge to the program)."""

    def __init__(self) -> None:
        self.runs, self.seconds, self._start = 0, 0.0, None
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = CLOCK()
        elif self._start is not None:
            self.runs += 1
            self.seconds += CLOCK() - self._start
            self._start = None

    def close(self) -> dict:
        gc.callbacks.remove(self._note)
        return {"gc_runs": self.runs, "gc_s": self.seconds}


def run(ctx) -> dict:
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    mix = ctx.cell.traffic
    sizes = ctx.sizes
    stacked = models.stacked_weights(sizes, ctx.seed, ctx.device)
    replies = sqs.Replies()
    queue = sqs.Queue(replies, CLOCK)
    service = ServiceConfig(
        queue_url="in", result_queue_url="out", batch_size=mix["slots"],
        seq_len=mix["bucket"], generate_tokens=mix["generate_tokens"],
        decode_block=mix["decode_block"], receive_wait_s=0)
    worker = ContinuousWorker(
        queue, models.port_params(stacked), models.port_config(sizes),
        service, result_queue=replies, now_fn=CLOCK, device=ctx.device)
    prompts = traffic.Prompts(mix["prompt"], ctx.seed, sizes.vocab)
    seconds = ctx.seconds

    lifecycle = window = None
    inserts: list[list[int]] = []
    if ctx.trace:
        from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
            LifecycleRegistry,
        )
        from portbench.trace import Window

        lifecycle = LifecycleRegistry(capacity=1 << 16, now_fn=CLOCK,
                                      keep_done=1 << 16)
        worker.attach_lifecycle(lifecycle)
        spans: list[tuple[int, int, str]] = []
        _spans(worker, spans, inserts)
        window = Window(spans)
    rate = mix["arrivals"] == "rate"
    if rate:
        period = float(mix["rate"]["period_s"])
        warmup = period * mix["warmup_periods"]
        origin = CLOCK() + 0.05
        dues = [origin + a for a in traffic.arrivals(
            mix["rate"], ctx.seed, 0.0, warmup + seconds + mix["tail_s"])]
        feed = _Rate(queue, prompts, dues)
        t0 = origin + warmup
        # the profiler takes seconds to start: it starts before the
        # window opens, under the warm-up's load, and is read from t0
        while CLOCK() < t0 - (0.0 if window is None else TRACE_LEAD_S):
            _cycle(worker, queue, feed, t0)
        if window is not None:
            window.start()
        while CLOCK() < t0:
            _cycle(worker, queue, feed, t0)
    else:
        feed = _Backlog(queue, prompts, mix["backlog_depth"])
        while len(queue.answered) < mix["warmup_answers"]:
            filling = worker.batcher.active < mix["slots"]
            feed.feed(CLOCK(), mix["stagger"] if filling else None)
            worker.run_once()
        if window is not None:
            window.start()
        t0 = CLOCK()
    if window is not None:
        window.mark()
        inserts.clear()
    setup_s = t0 - ctx.process_start
    close = t0 + seconds
    tokens_at_start = worker.batcher.tokens_emitted
    lateness = []
    pauses = _GcPauses()
    while CLOCK() < close:
        lateness.append(_cycle(worker, queue, feed, close))
    if not rate:
        # on to the end of the next cycle that answers (at most a minute)
        answers, limit = len(queue.answered), close + 60.0
        while len(queue.answered) == answers and CLOCK() < limit:
            lateness.append(_cycle(worker, queue, feed, limit))
        close = CLOCK()
    host = pauses.close()
    if window is not None:
        # the window closes here; the profiler stops (and spends seconds
        # on its records) only once nothing of the window waits on it
        window.close()
        tokens_traced = worker.batcher.tokens_emitted - tokens_at_start
        inserts_traced = list(inserts)

    due = {f"m{i}": d for i, d in enumerate(feed.dues)} if rate else {}
    due_in_window = [m for m, d in due.items() if t0 <= d < close]
    if rate:
        wait_end = close + mix["tail_s"]
        while CLOCK() < wait_end and any(
                m not in queue.answered for m in due_in_window):
            _cycle(worker, queue, feed, wait_end)
    if window is not None:
        window.stop()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated(ctx.device)
    else:
        memory_peak = 0

    answered = {m: t for m, t in queue.answered.items() if t0 <= t <= close}
    end_to_end = {"msgs_per_s": len(answered) / (close - t0),
                  "setup_s": setup_s}
    latencies = [queue.answered.get(m, CLOCK()) - due[m]
                 for m in due_in_window]
    if rate:
        end_to_end["reply_p95_ms"] = 1e3 * _p95(latencies)
        judged = due_in_window
    else:
        judged = list(answered)
    unanswered = [m for m in judged if m not in queue.answered]

    record = None
    if ctx.trace:
        record = {
            "sizes": sizes, "seconds": close - t0,
            "summary": window.summarize(),
            "tokens_traced": tokens_traced,
            "inserts_traced": inserts_traced,
            "answered": [(len(feed.ids[m]), len(replies.tokens[m]))
                         for m in answered],
            "first_token_ms": _first_token_ms(lifecycle, due,
                                              due_in_window),
        }

    # the program's state goes before the reference runs
    sample_ids = {m: feed.ids[m] for m in judged if m in replies.tokens}
    served = {m: replies.tokens[m] for m in sample_ids}
    del worker, stacked, queue, replies, feed
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    checks, program_gaps, control_gaps = correct.serving_checks(
        ctx, sample_ids, served, unanswered, mix["generate_tokens"])
    return {
        "program_gaps": program_gaps,
        "control_gaps": control_gaps,
        "latencies_s": latencies,
        "attempted": len(judged),
        "failed": len(unanswered),
        "end_to_end": end_to_end,
        "record": record,
        "checks": checks,
        "memory_peak_bytes": memory_peak,
        "generator_late_ms_max": 1e3 * max(lateness, default=0.0),
        "host": host,
    }


def _cycle(worker, queue, feed, until: float) -> float:
    """One engine cycle after the feed; when the engine and the queue are
    both empty, wait for the next due message instead (at most until
    ``until``).  Returns how late the feed ran."""
    now = CLOCK()
    late = feed.feed(now)
    if worker.batcher.active == 0 and queue.depth() == 0:
        due = feed.next_due()
        if due is not None:
            time.sleep(max(0.0, min(due, until) - now))
        return late
    worker.run_once()
    return late


def _p95(values: list[float]) -> float:
    return float(np.percentile(np.asarray(values), 95)) if values else 0.0


def _first_token_ms(lifecycle, due: dict, due_in_window: list) -> list[float]:
    """Due to the lifecycle registry's ``first_token`` stamp, in ms, for
    each request due in the window that has one."""
    if lifecycle is None:
        return []
    firsts = {}
    for trace in lifecycle.done_traces() + lifecycle.open_traces():
        t = trace.first("first_token")
        if t is not None:
            firsts[trace.rid] = t
    return [1e3 * (firsts[m] - due[m]) for m in due_in_window if m in firsts]
