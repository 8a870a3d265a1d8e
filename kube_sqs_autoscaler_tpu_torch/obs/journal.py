"""Flight recorder: bounded tick ring + append-only JSONL journal.

The port's copy of ``kube_sqs_autoscaler_tpu/obs/journal.py``: it writes
and reads the reference's schema version, so each package reads the
other's journals.

The Prometheus gauges expose the controller's *current* state; once a
bad scaling episode has passed there is nothing left to diagnose or
re-score.  This module records everything the loop does, two ways:

- :class:`TickRing`   — a bounded in-memory ring of the most recent
  :class:`~..core.events.TickRecord` s, cheap enough to always run behind
  the metrics server; feeds ``/debug/ticks`` and ``/debug/trace``.
- :class:`TickJournal` — an append-only, schema-versioned JSONL file
  (``--journal-path``): one header line carrying the schema version and
  the run's configuration meta, then one line per tick.  Lines are
  written and flushed one at a time so a crash loses at most the tick in
  flight; the reader tolerates a torn final line.  Rotation is by size
  (``max_bytes``): the live file is renamed to ``<path>.1`` and a fresh
  header starts the new file.

Both implement the :class:`~..core.events.TickObserver` protocol and fan
out alongside the Prometheus observer via
:class:`~..core.events.MultiObserver`.  :func:`read_journal` loads a
journal back into records (the reference's ``sim.replay`` re-drives
them).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from typing import Any

from ..core.events import TickRecord

log = logging.getLogger(__name__)

#: Bump on any backward-incompatible change to the line format.  The
#: reader refuses a mismatched journal loudly rather than mis-replaying it.
JOURNAL_SCHEMA_VERSION = 1

_HEADER_KIND = "header"
_TICK_KIND = "tick"


class JournalSchemaError(RuntimeError):
    """The file is not a journal, or its schema version is unsupported."""


def _is_header_line(line: str) -> bool:
    try:
        data = json.loads(line)
    except ValueError:
        return False
    return isinstance(data, dict) and data.get("kind") == _HEADER_KIND


class TickRing:
    """Bounded in-memory ring of the most recent tick records.

    Thread-safe: the loop thread appends, HTTP handler threads snapshot.
    """

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._records: collections.deque[TickRecord] = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def on_tick(self, record: TickRecord) -> None:
        with self._lock:
            self._records.append(record)

    def snapshot(self, last: int | None = None) -> list[TickRecord]:
        """The ring's contents oldest-first (``last`` limits to the tail)."""
        with self._lock:
            records = list(self._records)
        if last is not None and last >= 0:
            records = records[len(records) - min(last, len(records)):]
        return records

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


class TickJournal:
    """Append-only JSONL tick journal with size-based rotation.

    ``meta`` is the run configuration the header carries — everything
    :mod:`..sim.replay` needs to re-drive the episode (poll interval,
    policy thresholds/cooldowns, scaler bounds, world parameters for
    sim-recorded episodes).  Restarting onto an existing path appends a
    fresh header; the reader keeps the first header's meta.
    """

    def __init__(
        self,
        path: str,
        meta: dict[str, Any] | None = None,
        max_bytes: int = 64 * 1024 * 1024,
    ) -> None:
        if max_bytes < 4096:
            raise ValueError(f"max_bytes must be >= 4096, got {max_bytes}")
        self.path = path
        self.meta = dict(meta or {})
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._closed = False  # deliberate close(); distinct from I/O failure
        self._fh = open(path, "a", encoding="utf-8")
        self._size = self._fh.tell()
        self._needs_header = False  # set when a rotation loses its header
        if self._size and not self._ends_with_newline():
            # Restarting onto a crash-torn journal: terminate the torn
            # fragment so this run's header starts its own line (the reader
            # tolerates a torn line right before a header) instead of
            # merging with the fragment into one permanently corrupt line.
            self._fh.write("\n")
            self._fh.flush()
            self._size += 1
        self._write_line(self._header_line())

    def _ends_with_newline(self) -> bool:
        with open(self.path, "rb") as fh:
            fh.seek(-1, os.SEEK_END)
            return fh.read(1) == b"\n"

    def _header_line(self, continuation: bool = False) -> str:
        header: dict[str, Any] = {
            "kind": _HEADER_KIND,
            "schema": JOURNAL_SCHEMA_VERSION,
            "meta": self.meta,
        }
        if continuation:
            # Rotation, not restart: the ticks that follow continue the SAME
            # loop episode (warm cooldown/forecast state), unlike a fresh
            # header appended by a controller restart.  Replay uses this to
            # rejoin the episode across <path>.1 instead of wrongly
            # re-applying the startup-grace window.
            header["continuation"] = True
        return json.dumps(header, separators=(",", ":"))

    def _write_line(self, line: str) -> None:
        # line-at-a-time + flush: a crash loses at most the tick in flight,
        # and a torn tail is skipped by read_journal.  Size is counted in
        # encoded BYTES (the file is UTF-8; non-ASCII error messages or
        # meta would otherwise blow past max_bytes uncounted).
        self._fh.write(line + "\n")
        self._fh.flush()
        self._size += len(line.encode("utf-8")) + 1

    def on_tick(self, record: TickRecord) -> None:
        line = json.dumps(
            {"kind": _TICK_KIND, **record.to_dict()}, separators=(",", ":")
        )
        with self._lock:
            self._append_locked(line)

    def append_event(self, kind: str, payload: dict) -> None:
        """Append one non-tick event line (e.g. the knob actuator's
        ``kind="knob"`` changes).  Same crash-safety discipline as tick
        lines (line-at-a-time + flush, rotation-aware); readers that
        don't know the kind skip it (the episode parser's
        forward-compatibility rule), :func:`read_journal_events` finds
        it."""
        if kind in (_HEADER_KIND, _TICK_KIND):
            raise ValueError(
                f"kind {kind!r} is reserved for the journal itself"
            )
        line = json.dumps(
            {"kind": kind, **payload}, separators=(",", ":")
        )
        with self._lock:
            self._append_locked(line)

    def _append_locked(self, line: str) -> None:
        """One journal line through the shared rotation/reopen/header
        machinery; caller holds the lock."""
        if self._closed:
            return
        if self._fh.closed and not self._reopen():
            return  # transient failure: drop this line, retry next write
        if (
            not self._needs_header
            and self._size + len(line.encode("utf-8")) + 1 > self.max_bytes
        ):
            try:
                self._rotate()
            except OSError:
                # A transient filesystem error (permissions, read-only
                # remount, ENOSPC) must not kill the recorder forever:
                # keep appending to the live file and retry the
                # rotation at the next size check.
                log.exception(
                    "journal rotation failed; continuing in place"
                )
                if self._fh.closed and not self._reopen():
                    return
        if self._needs_header:
            # the rename succeeded but the continuation header did not
            # land (e.g. ENOSPC): a tick line first would leave the
            # file headerless and permanently unreadable — the header
            # MUST precede any tick, so drop lines until it lands
            try:
                self._write_line(self._header_line(continuation=True))
            except OSError:
                log.exception("journal header retry failed; line dropped")
                return
            self._needs_header = False
        self._write_line(line)

    def _reopen(self) -> bool:
        """Re-establish the file handle after an I/O failure mid-rotation.

        Every tick retries, so recording resumes as soon as the filesystem
        recovers — a dropped tick, never a permanently dead recorder.
        """
        try:
            self._fh = open(self.path, "a", encoding="utf-8")
            self._size = self._fh.tell()
        except OSError:
            log.exception("journal reopen failed; tick dropped")
            return False
        return True

    def _rotate(self) -> None:
        """Rename the live file to ``<path>.1`` and start a fresh journal
        (one rotated generation kept — the flight-recorder contract is
        "recent history", not unbounded archival).  The new file opens with
        a *continuation* header: the episode keeps running across the
        rotation boundary."""
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        # From here the live path is headerless (or nonexistent, if the
        # open below fails): whatever happens next, a continuation header
        # must land before any tick line, else the file is unreadable.
        self._needs_header = True
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self._write_line(self._header_line(continuation=True))
        self._needs_header = False

    def tear(self, record: TickRecord) -> None:
        """Crash-injection seam (``sim.faults.CrashingJournal``): write
        HALF of the record's line — no newline, no flush discipline —
        modeling the process dying mid-``write``.  The torn fragment is
        exactly what :func:`parse_journal_episodes` already tolerates at
        a file tail, and what a restarting :class:`TickJournal` heals by
        newline-terminating before its fresh header."""
        line = json.dumps(
            {"kind": _TICK_KIND, **record.to_dict()}, separators=(",", ":")
        )
        with self._lock:
            if self._closed or self._fh.closed:
                return
            fragment = line[: max(1, len(line) // 2)]
            self._fh.write(fragment)
            self._fh.flush()
            self._size += len(fragment.encode("utf-8"))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "TickJournal":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def parse_journal_episodes(
    lines: "list[str]",
) -> list[tuple[dict[str, Any], list[TickRecord]]]:
    """Parse journal lines → one ``(meta, records)`` pair per episode.

    Every header line starts a new episode (a journal accumulates one per
    controller restart onto the same ``--journal-path``).  Raises
    :class:`JournalSchemaError` unless the first line is a header, and on
    ANY header — including restart headers mid-file — whose schema version
    is not the supported one: ticks written by a foreign build must never
    be silently parsed under this build's schema.
    """
    if not lines:
        raise JournalSchemaError("empty journal")
    try:
        first = json.loads(lines[0])
    except ValueError as err:
        raise JournalSchemaError(f"journal header is not JSON: {err}") from err
    if not isinstance(first, dict) or first.get("kind") != _HEADER_KIND:
        raise JournalSchemaError("journal does not start with a header line")
    episodes: list[tuple[dict[str, Any], list[TickRecord]]] = []
    for index, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            data = json.loads(line)
        except ValueError:
            data = None
        if not isinstance(data, dict):
            if index == len(lines) - 1:
                continue  # torn final line from a crash mid-write: tolerated
            if _is_header_line(lines[index + 1]):
                # torn crash line healed by a restart: the next run's
                # header follows immediately (TickJournal newline-
                # terminates the fragment on reopen) — lose that one tick,
                # keep both episodes readable
                continue
            raise JournalSchemaError(f"corrupt journal line {index + 1}")
        kind = data.get("kind")
        if kind == _HEADER_KIND:
            if data.get("schema") != JOURNAL_SCHEMA_VERSION:
                raise JournalSchemaError(
                    f"journal schema {data.get('schema')!r} unsupported"
                    f" (this build reads {JOURNAL_SCHEMA_VERSION})"
                )
            meta = dict(data.get("meta") or {})
            if data.get("continuation"):
                # reserved marker: this "episode" continues the previous
                # one across a rotation boundary (see TickJournal._rotate)
                meta["_continuation"] = True
            episodes.append((meta, []))
        elif kind == _TICK_KIND:
            episodes[-1][1].append(TickRecord.from_dict(data))
        # unknown kinds are skipped (forward compatibility)
    return episodes


def parse_journal_lines(
    lines: "list[str]",
) -> tuple[dict[str, Any], list[TickRecord]]:
    """Parse journal lines → ``(meta, records)`` flattened across episodes
    (first header's meta stands; see :func:`parse_journal_episodes` for the
    per-episode view replay needs)."""
    episodes = parse_journal_episodes(lines)
    meta = episodes[0][0]
    records = [record for _, episode in episodes for record in episode]
    return meta, records


def read_journal(path: str) -> tuple[dict[str, Any], list[TickRecord]]:
    """Load a journal file → ``(meta, records)``, all episodes flattened."""
    return parse_journal_lines(_read_lines(path))


def read_journal_episodes(
    path: str,
) -> list[tuple[dict[str, Any], list[TickRecord]]]:
    """Load a journal file → one ``(meta, records)`` pair per episode
    (controller restart = new episode)."""
    return parse_journal_episodes(_read_lines(path))


def read_journal_events(
    path: str, kind: str, *, rejoin: bool = False
) -> "list[dict]":
    """Load every non-tick event line of ``kind`` from a journal, in
    file order (e.g. ``kind="knob"`` for the knob actuator's changes,
    ``kind="request"`` for closed lifecycle traces).  Torn/corrupt
    lines and foreign kinds are skipped — this reader is for sidecar
    event streams, so it is deliberately lenient where the episode
    parser is strict.  ``rejoin=True`` prepends the one kept rotated
    generation (``<path>.1``) so events that rotated out mid-run stay
    visible, mirroring :func:`~..sim.replay`'s episode rejoin."""
    lines: list[str] = []
    rotated = path + ".1"
    if rejoin and os.path.exists(rotated):
        lines.extend(_read_lines(rotated))
    lines.extend(_read_lines(path))
    events: list[dict] = []
    for line in lines:
        if not line.strip():
            continue
        try:
            data = json.loads(line)
        except ValueError:
            continue
        if isinstance(data, dict) and data.get("kind") == kind:
            events.append(data)
    return events


def _read_lines(path: str) -> "list[str]":
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read().splitlines()
