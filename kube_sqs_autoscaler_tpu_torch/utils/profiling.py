"""Opt-in profiling: device traces and wall-clock span timing.

The port's copy of ``kube_sqs_autoscaler_tpu/utils/profiling.py``:

- :func:`maybe_trace` — a context manager that records a region with
  ``torch.profiler`` (the card's kernels and copies when the device is a
  CUDA card, the host's operators always) and writes it as a Chrome trace
  under a directory, and is a free no-op without one.  Workers enable it
  with ``ServiceConfig(profile_dir=...)``.
- :class:`SpanTimer` — named, nested wall-clock spans on the epoch clock
  in a bounded ring, with summary percentiles, dependency-free.

``maybe_trace`` imports torch inside the context manager, so importing
this module imports no torch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from collections.abc import Iterator
from dataclasses import dataclass, field
from typing import NamedTuple


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, device=None):
    """``with maybe_trace(dir, device):`` — a ``torch.profiler`` trace of
    the block when ``dir`` is set, written when the block exits as
    ``dir/trace-<pid>-<ms>.json`` (open it in ``chrome://tracing`` or
    Perfetto).  CUDA activity is recorded when ``device`` is a CUDA
    device.  ``None``/empty disables tracing with zero overhead."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"
    ))


class Span(NamedTuple):
    """One recorded span: ``start`` and ``end`` in epoch seconds as
    :meth:`SpanTimer.spans` gives them (the clock ``torch.profiler``
    stamps its events on), ``parent`` the ``id`` of the span open around
    it on the same thread (None for a root), ``link`` the ``id`` of a span
    it waits on (a host read's wait names the launch that issued the
    copy)."""

    id: int
    name: str
    start: float
    end: float
    parent: int | None
    link: int | None


# the closed spans a SpanTimer keeps; a serve cycle records about a dozen
SPAN_RING = 4096


@dataclass
class SpanTimer:
    """Thread-safe wall-clock spans, dependency-free.
    :class:`~..workloads.service.QueueWorker` records each serve cycle
    under ``"cycle"``; reusable for any span.

    Every closed span goes into a ring of the last :data:`SPAN_RING`
    (:meth:`spans`), with its parent: the span open around it on the same
    thread.  :meth:`summary` keeps per-name totals for the process's life
    and takes its quantiles from the ring, so memory and a scrape's cost
    stay bounded however long the timer runs.  Durations come from
    ``clock.monotonic()``; :meth:`spans` moves them onto the epoch clock
    (``clock.time()``), which device traces share.

    >>> timer = SpanTimer()
    >>> with timer.span("tick"):
    ...     pass
    >>> timer.summary()["tick"]["count"]
    1
    """

    clock: object = time  # injectable: needs .monotonic() and .time()
    _ring: deque = field(default_factory=lambda: deque(maxlen=SPAN_RING))
    # name -> [count, total_s, max_s] over the timer's life
    _totals: dict = field(default_factory=dict)
    _ids: Iterator[int] = field(default_factory=itertools.count)
    _open: threading.local = field(default_factory=threading.local)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def begin(self, name: str, link: int | None = None) -> tuple:
        """Open a span inside the one open on this thread; returns the
        token :meth:`end` closes.  Its ``id`` is ``token[0]``."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        span_id = next(self._ids)
        token = (span_id, name, stack[-1] if stack else None, link,
                 len(stack), self.clock.monotonic())
        stack.append(span_id)
        return token

    def current(self) -> int | None:
        """The ``id`` of the innermost span open on this thread."""
        stack = getattr(self._open, "stack", None)
        return stack[-1] if stack else None

    def end(self, token: tuple) -> None:
        """Close ``token``'s span, and with it any span opened inside it
        that an exception left open (those are not recorded)."""
        end = self.clock.monotonic()
        span_id, name, parent, link, depth, start = token
        stack = getattr(self._open, "stack", None)
        if stack is not None:
            del stack[depth:]
        elapsed = end - start
        with self._lock:
            self._ring.append(Span(span_id, name, start, end, parent, link))
            totals = self._totals.get(name)
            if totals is None:
                self._totals[name] = [1, elapsed, elapsed]
            else:
                totals[0] += 1
                totals[1] += elapsed
                totals[2] = max(totals[2], elapsed)

    @contextlib.contextmanager
    def span(self, name: str, link: int | None = None):
        token = self.begin(name, link)
        try:
            yield token[0]
        finally:
            self.end(token)

    def spans(self) -> list[Span]:
        """The ring's spans in epoch seconds, oldest closed first (a child
        closes before its parent)."""
        with self._lock:
            ring = list(self._ring)
        offset = self._epoch_offset()
        return [s._replace(start=s.start + offset, end=s.end + offset)
                for s in ring]

    def _epoch_offset(self) -> float:
        """``clock.time()`` less ``clock.monotonic()``: each epoch read
        is put at the middle of two monotonic reads around it, and the
        tightest of five brackets is kept (a single pair can read
        microseconds apart)."""
        best = None
        for _ in range(5):
            before = self.clock.monotonic()
            epoch = self.clock.time()
            after = self.clock.monotonic()
            if best is None or after - before < best[0]:
                best = (after - before, epoch - (before + after) / 2)
        return best[1]

    def summary(self) -> dict:
        """Per-span ``{count, total_s, mean_s, p50_s, p99_s, max_s}``:
        count, total and max over the timer's life, the quantiles over
        the spans of that name still in the ring."""
        with self._lock:
            totals = {k: list(v) for k, v in self._totals.items()}
            recent: dict[str, list[float]] = {}
            for s in self._ring:
                recent.setdefault(s.name, []).append(s.end - s.start)
        out = {}
        for name, (count, total, longest) in totals.items():
            ordered = sorted(recent.get(name) or [longest])
            n = len(ordered)
            out[name] = {
                "count": count,
                "total_s": total,
                "mean_s": total / count,
                "p50_s": ordered[n // 2],
                "p99_s": ordered[min(n - 1, (n * 99) // 100)],
                "max_s": longest,
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()
