"""The program's own phase spans and counters against the device trace.

The port records its phases when a worker's span recording is on
(``ContinuousWorker.attach_spans``): ``cycle`` around ``receive``,
``insert`` (``insert.stage``, ``insert.launch``), ``step``
(``block.launch``, ``wait.first`` / ``wait.block``, ``emit``) and
``reply``, on the epoch clock ``torch.profiler`` stamps its events on.
Its engine counts its work in plain integers, always on.

:func:`program_record` puts each device operation of a traced window down
to the program span that launched it: the runtime call that launched the
operation (a CUDA runtime event in the same kineto record, joined by its
correlation id) gives the host time of the launch, and the innermost span
open then is the launcher.  With the counters' deltas over the window it
gives the record that the four readers below read from
``record["program"]``:

- :func:`prefill_ms_per_row`: device time launched inside ``insert`` over
  the rows inserted;
- :func:`decode_ms_per_step`: device time launched inside
  ``block.launch`` over the decode steps dispatched;
- :func:`slot_occupancy`: tokens kept over the slot rows stepped;
- :func:`prompt_fill`: real prompt tokens over padded prompt tokens.

The benchmark's serving loop (``drivers/serve.py``) does not record the
program's spans yet, so no run of ``python -m portbench`` reads them.
Until it does, this file run as a module runs a cell's traced window
through that loop, unchanged, with the program's recording on (or off,
to price it), and prints the readings above, the device time and idle
time by program span, and the lag of each host read behind the copy it
waited for:

    python3 -m portbench.phases --workload <cell> --seed <n> --seconds <s>

That entry point (:class:`_Study`, :func:`study`, :func:`main`) is
temporary: it swaps the module globals ``ContinuousWorker`` and
``trace.Window`` for subclasses and reads the window's private fields.
The change to ``drivers/serve.py`` that switches recording on in the
traced run and adds ``record["program"]`` deletes it; the reduction and
the readers stay.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
import weakref

import torch

from portbench.trace import _union

# the engine's counters the window's deltas are taken of
COUNTERS = ("insert_rows", "insert_prompt_tokens", "insert_padded_tokens",
            "decode_steps", "decode_row_steps", "block_tokens",
            "tokens_emitted", "insert_dispatches", "decode_dispatches",
            "host_transfers", "block_settles")
OUTSIDE = "host: outside the spans"
# a device-to-host copy in the trace (the runtime names it so), and the
# runtime call a host read's wait makes
DTOH = "Memcpy DtoH"
SYNC = "cudaEventSynchronize"
# how far outside a wait span its runtime call is looked for (us)
SYNC_SLACK_US = 1000.0


def counters(batcher) -> dict:
    """The engine's counters now (0 for one a program lacks)."""
    return {name: getattr(batcher, name, 0) for name in COUNTERS}


def delta(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


# -- the readers -------------------------------------------------------------


def _program(record):
    return (record or {}).get("program") or None


def prefill_ms_per_row(record):
    program = _program(record)
    if program is None or not program["counters"].get("insert_rows"):
        return None
    seconds = program["device_s"].get("insert")
    if seconds is None:
        return None
    return 1e3 * seconds / program["counters"]["insert_rows"]


def decode_ms_per_step(record):
    program = _program(record)
    if program is None or not program["counters"].get("decode_steps"):
        return None
    seconds = program["device_s"].get("block.launch")
    if seconds is None:
        return None
    return 1e3 * seconds / program["counters"]["decode_steps"]


def slot_occupancy(record):
    program = _program(record)
    if program is None or not program["counters"].get("decode_row_steps"):
        return None
    c = program["counters"]
    return 100.0 * c["block_tokens"] / c["decode_row_steps"]


def prompt_fill(record):
    program = _program(record)
    if program is None or not program["counters"].get(
            "insert_padded_tokens"):
        return None
    c = program["counters"]
    return 100.0 * c["insert_prompt_tokens"] / c["insert_padded_tokens"]


READERS = {"prefill_ms_per_row.drain": prefill_ms_per_row,
           "decode_ms_per_step.drain": decode_ms_per_step,
           "slot_occupancy.drain": slot_occupancy,
           "prompt_fill.drain": prompt_fill}


# -- the reduction -------------------------------------------------------------


class Spans:
    """The program's spans (``utils.profiling.Span`` records, times in
    epoch seconds) in epoch microseconds, with the innermost span open at
    a time."""

    def __init__(self, spans) -> None:
        self.by_id = {s.id: s for s in spans}
        self.sorted = sorted(spans, key=lambda s: (s.start, s.id))
        self.starts = [1e6 * s.start for s in self.sorted]

    def innermost(self, t_us: float):
        """The latest-starting span open at ``t_us``, or None.  Spans of
        one thread nest, and roots follow one another, so the search
        stops at the first root that does not hold ``t_us``."""
        i = bisect.bisect_right(self.starts, t_us) - 1
        while i >= 0:
            s = self.sorted[i]
            if t_us < 1e6 * s.end:
                return s
            if s.parent is None:
                return None
            i -= 1
        return None

    def path(self, span) -> list[str]:
        """``span``'s name and its ancestors' names, innermost first."""
        names = []
        while span is not None:
            names.append(span.name)
            span = self.by_id.get(span.parent)
        return names


def _as_spans(spans) -> Spans:
    return spans if isinstance(spans, Spans) else Spans(spans)


def attribute(ops, launch_us: dict, spans, bounds) -> dict:
    """Device operations ``(name, start_us, end_us, correlation)`` put
    down to the program span open at each one's launch
    (``launch_us[correlation]``), clipped to ``bounds`` (epoch
    microseconds).

    Returns ``device_s`` (seconds launched inside each span name, its
    children's included), ``self_s`` (by innermost span name),
    ``attributed_share`` (percent of the window's device time launched
    inside some span; None when nothing ran), ``idle_by_span`` (idle
    seconds by the innermost span open when each gap began), ``busy_s``
    and the per-operation launchers (``launcher``: correlation -> span
    id) the clock check reads."""
    spans = _as_spans(spans)
    lo, hi = bounds
    device_s: dict[str, float] = {}
    self_s: dict[str, float] = {}
    launcher: dict = {}
    total = attributed = 0.0
    intervals = []
    for _, start, end, corr in ops:
        launched = launch_us.get(corr)
        span = spans.innermost(launched) if launched is not None else None
        if span is not None:
            launcher[corr] = span.id
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        seconds = (end - start) / 1e6
        intervals.append((start, end))
        total += seconds
        if span is None:
            self_s[OUTSIDE] = self_s.get(OUTSIDE, 0.0) + seconds
            continue
        attributed += seconds
        self_s[span.name] = self_s.get(span.name, 0.0) + seconds
        for name in set(spans.path(span)):
            device_s[name] = device_s.get(name, 0.0) + seconds
    busy = _union(intervals)
    idle: dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        span = spans.innermost(end)
        label = span.name if span is not None else OUTSIDE
        idle[label] = idle.get(label, 0.0) + (start - end) / 1e6
    return {
        "device_s": device_s, "self_s": self_s,
        "attributed_share": (100.0 * attributed / total) if total else None,
        "idle_by_span": idle,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "launcher": launcher,
    }


def wait_lags_us(ops, launcher: dict, spans) -> list[float]:
    """For each ``wait.*`` span linked to the launch that issued its
    copy: its end minus the end of the last device-to-host copy launched
    inside that launch span (microseconds).  A read cannot return before
    its copy has landed, so on one clock none is negative."""
    spans = _as_spans(spans)
    copy_end: dict[int, float] = {}
    for name, _, end, corr in ops:
        span_id = launcher.get(corr)
        if span_id is not None and name.startswith(DTOH):
            copy_end[span_id] = max(copy_end.get(span_id, end), end)
    return [1e6 * s.end - copy_end[s.link]
            for s in spans.sorted
            if s.name.startswith("wait.") and s.link in copy_end]


def sync_offsets_us(runtime, spans) -> list[tuple[float, float]]:
    """The two host clocks against each other: for each ``wait.*`` span,
    the ``cudaEventSynchronize`` call the runtime recorded inside it,
    as ``(call start - span start, span end - call end)`` in
    microseconds.  The span is taken on the program's clock, the call on
    the profiler's: where they agree both are small and neither is
    negative."""
    spans = _as_spans(spans)
    syncs = sorted((start, end) for name, start, end in runtime
                   if name == SYNC)
    starts = [start for start, _ in syncs]
    offsets = []
    for s in spans.sorted:
        if not s.name.startswith("wait."):
            continue
        lo, hi = 1e6 * s.start, 1e6 * s.end
        i = bisect.bisect_left(starts, lo - SYNC_SLACK_US)
        near = [c for c in syncs[i:i + 4] if c[0] <= hi + SYNC_SLACK_US]
        if near:
            start, end = min(near, key=lambda c: abs(c[0] - lo))
            offsets.append((start - lo, hi - end))
    return offsets


def runtime_by_span(runtime, spans, top: int = 4) -> dict:
    """Host seconds in runtime calls, by the innermost span open when
    each began and the call's name (the ``top`` longest of each span):
    a launch that blocks on a full queue, an allocation that waits."""
    spans = _as_spans(spans)
    found: dict[str, dict[str, float]] = {}
    for name, start, end in runtime:
        span = spans.innermost(start)
        calls = found.setdefault(span.name if span else OUTSIDE, {})
        calls[name] = calls.get(name, 0.0) + (end - start) / 1e6
    return {label: dict(sorted(calls.items(), key=lambda c: -c[1])[:top])
            for label, calls in found.items()}


def host_ms_by_phase(spans, bounds) -> dict:
    """Each span name's host time (ms a cycle) inside ``bounds``: its
    total, and its self time (less its children's)."""
    lo, hi = bounds
    inside = [s for s in spans if lo <= 1e6 * s.start and 1e6 * s.end <= hi]
    cycles = sum(1 for s in inside if s.name == "cycle") or 1
    total: dict[str, float] = {}
    children: dict[int, float] = {}
    for s in inside:
        total[s.name] = total.get(s.name, 0.0) + (s.end - s.start)
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + (s.end
                                                                - s.start)
    own: dict[str, float] = {}
    for s in inside:
        own[s.name] = own.get(s.name, 0.0) + (s.end - s.start
                                              - children.get(s.id, 0.0))
    return {name: {"total_ms": 1e3 * total[name] / cycles,
                   "self_ms": 1e3 * own[name] / cycles} for name in total}


def kineto_ops(prof):
    """``(ops, launch_us, runtime)`` of a ``torch.profiler`` run: every
    device operation as ``(name, start_us, end_us, correlation)``
    (annotations left out), the host time of each runtime call by
    correlation id (the launch of the operations that share it), and the
    runtime calls as ``(name, start_us, end_us)``."""
    ops, launch_us, runtime = [], {}, []
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), start, end, corr))
        elif corr:
            launch_us[corr] = start
            runtime.append((e.name(), start, end))
    return ops, launch_us, runtime


def program_record(prof, spans, before: dict, after: dict,
                   bounds) -> dict:
    """``record["program"]`` of a traced window: the counters' deltas and
    the device time by program span (see :func:`attribute`)."""
    ops, launch_us, runtime = kineto_ops(prof)
    spans = Spans(spans)
    found = attribute(ops, launch_us, spans, bounds)
    lo, hi = bounds
    runtime = [call for call in runtime if lo <= call[1] < hi]
    return {"counters": delta(before, after),
            "device_s": found["device_s"], "self_s": found["self_s"],
            "attributed_share": found["attributed_share"],
            "idle_by_span": found["idle_by_span"],
            "busy_s": found["busy_s"],
            "launches_found": len(launch_us),
            "runtime_by_span": runtime_by_span(runtime, spans),
            "sync_offsets_us": sync_offsets_us(runtime, spans),
            "wait_lags_us": wait_lags_us(ops, found["launcher"], spans)}


# -- the study: a cell's traced window with the program's recording -------------


class _Study:
    """Hooks one run of the serving loop: the worker it builds gets span
    recording (or not), and its profiler window snapshots the engine's
    counters when it opens and closes.  Holds the worker weakly, so the
    loop still frees the program's state before its reference runs."""

    def __init__(self, record_spans: bool) -> None:
        self.record_spans = record_spans
        self.timer = self.window = self.worker = None
        self.before = self.after = None

    def __enter__(self):
        from kube_sqs_autoscaler_tpu_torch.utils.profiling import SpanTimer
        from kube_sqs_autoscaler_tpu_torch.workloads import continuous

        from portbench import trace

        study = self
        base_worker, base_window = continuous.ContinuousWorker, trace.Window

        class Worker(base_worker):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                study.worker = weakref.ref(self)
                if study.record_spans:
                    study.timer = SpanTimer()
                    self.attach_spans(study.timer)

        class Window(base_window):
            def __init__(self, host_spans):
                super().__init__(host_spans)
                study.window = self

            def mark(self):
                super().mark()
                study.before = counters(study.worker().batcher)

            def close(self):
                super().close()
                study.after = counters(study.worker().batcher)

        self._restore = ((continuous, "ContinuousWorker", base_worker),
                         (trace, "Window", base_window))
        continuous.ContinuousWorker, trace.Window = Worker, Window
        return self

    def __exit__(self, *exc):
        for module, name, value in self._restore:
            setattr(module, name, value)


def study(cell_name: str, seed: int, seconds: float,
          record_spans: bool) -> dict:
    """One traced window of ``cell_name`` on the card with the program's
    span recording on or off: the cell's own per-layer readings and its
    end-to-end ones, and with recording on the phase readings, the device
    and idle time by span, the host time a cycle by phase and the wait
    lags."""
    from portbench import models, run, spec

    if not torch.cuda.is_available():
        raise SystemExit("portbench.phases needs a CUDA card")
    run._fixed_caches(spec.ROOT)
    cell = spec.cell(cell_name)
    mix = cell.traffic
    ctx = run.Context(
        cell=cell, seed=seed, seconds=seconds, trace=True,
        sizes=models.sizes(cell.config,
                           mix["bucket"] + mix["generate_tokens"]),
        device=torch.device("cuda", 0), process_start=run.PROCESS_START)
    return _study(ctx, record_spans)


def _study(ctx, record_spans: bool) -> dict:
    from kube_sqs_autoscaler_tpu_torch.utils.profiling import (
        SPAN_RING,
        SpanTimer,
    )

    from portbench import correct, spec

    cell = ctx.cell
    with _Study(record_spans) as hooks:
        out = spec.driver(cell.traffic["driver"]).run(ctx)
    record = out["record"]
    result = {
        "cell": cell.name, "seed": ctx.seed, "spans": record_spans,
        "device": (torch.cuda.get_device_name(ctx.device)
                   if ctx.device.type == "cuda" else "cpu"),
        "correct": correct.passed(out["checks"]),
        "end_to_end": out["end_to_end"],
        "per_layer": {m["name"]: spec.metric_reader(m["name"])(record)
                      for m in cell.per_layer},
        "counters": delta(hooks.before, hooks.after),
    }
    if hooks.timer is not None:
        window = hooks.window
        bounds = (window._ns0 / 1e3, window._ns1 / 1e3)
        spans = hooks.timer.spans()
        if len(spans) == SPAN_RING and 1e6 * spans[0].start > bounds[0]:
            raise RuntimeError("the span ring dropped spans of the window")
        program = program_record(window._prof, spans, hooks.before,
                                 hooks.after, bounds)
        lags = sorted(program.pop("wait_lags_us"))
        offsets = program.pop("sync_offsets_us")
        record["program"] = program
        result["phases"] = {name: read(record)
                            for name, read in READERS.items()}
        result["program"] = program
        result["wait_lag_us"] = _quantiles(lags)
        result["sync_lead_us"] = _quantiles(sorted(a for a, _ in offsets))
        result["sync_lag_us"] = _quantiles(sorted(b for _, b in offsets))
        result["host_ms_a_cycle"] = host_ms_by_phase(spans, bounds)
        result["span_cost_us"] = span_cost_us(SpanTimer)
    return result


def _quantiles(values: list[float]) -> dict:
    if not values:
        return {"n": 0}
    return {"n": len(values), "min": values[0],
            "median": statistics.median(values),
            "p95": values[min(len(values) - 1, (95 * len(values)) // 100)],
            "max": values[-1]}


def span_cost_us(timer_class, n: int = 20000) -> float:
    """Host time of one recorded span (a begin and an end), µs."""
    timer = timer_class()
    start = time.perf_counter()
    for _ in range(n):
        timer.end(timer.begin("x"))
    return 1e6 * (time.perf_counter() - start) / n


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.phases")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    result = study(args.workload, args.seed, args.seconds, bool(args.spans))
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
