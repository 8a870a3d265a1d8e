"""Durable control-plane state: the controller is a failure domain.

The reference deployment "relies on Kubernetes restarting a crashed
controller pod" (obs/server.py) — and a restart of *this* controller
used to silently lose every piece of accumulated control state: cooldown
stamps, circuit-breaker state, forecaster history, the learned policy's
replica/cooldown mirror, the fleet's exactly-once reply registry, the
DRR/EDF accounting and flood classifications that make fair queueing
work, and the overload-ladder tier.  This module makes all of it a
*snapshot*: one crash-safe, schema-versioned JSON file the loop rewrites
atomically each tick, plus a startup **rehydration** path that restores
what is still true and discards what is not.

Design rules (each one is load-bearing):

- **atomic write-rename** — the snapshot is written to ``<path>.tmp``,
  flushed, fsynced, then ``os.replace``d over the live file, so a crash
  mid-write can never tear the snapshot a restart will read (the tmp
  file tears instead, and is simply overwritten next tick).  The
  *reader* is still torn-write tolerant like the journal reader: a
  truncated, corrupt, wrong-kind, hash-mismatched, or future-schema
  file is a **cold start with a logged reason — never a crash loop**.
- **time is rebased, never trusted** — the loop's clock is monotonic
  and restarts with the process, so raw clock values in a snapshot are
  meaningless to the next boot.  Every saved instant is shifted by
  ``rebase = (now - downtime) - saved_clock``, where ``downtime`` is
  measured on the **wall clock** carried in the snapshot.  A cooldown
  that had 12 s left keeps exactly 12 s minus the downtime; a breaker
  opened 40 s ago stays open for the remainder of its reset window.
- **expire by wall-clock age** (kube-controller style) — each
  registered section carries a TTL; a snapshot older than a section's
  TTL expires that section (counted, surfaced as
  ``state_records_expired``), and a snapshot older than
  ``max_age_s`` cold-starts entirely.  Stale memory is worse than no
  memory.
- **trust the observed world over the remembered one** — after the
  sections import, providers exposing ``reconcile_observed`` are handed
  the *actual* replica count read through the Scaler seam; the learned
  policy's mirror adopts it instead of its remembered trajectory.
- **journal-tail rehydration** — the snapshot is written *after* the
  tick's journal line, so the journal can be one tick ahead (snapshot
  write failed, or the crash tore exactly between them).  Rehydration
  re-drives the tail records (rebased) through every provider's
  ``on_tick`` and advances the restored cooldown stamps for any
  actuation the tail proves happened.
- **write-ahead actuation intent** — the dangerous crash window is
  *after the scaler RPC, before anything durable recorded it*: a warm
  restart that restored the pre-actuation stamp would re-fire inside
  the cooldown (the double-scale the reference's cold restart is
  accidentally immune to, because startup grace over-cools).  The loop
  therefore journals an **intent** (direction + instant, its own tiny
  atomic file) *before* every scaler call; the snapshot that covers
  the completed tick clears it.  Rehydration treats an unresolved
  intent as "may have actuated": the matching cooldown stamp advances
  to the intent instant.  Pessimistic by design — a crash after a
  *failed* actuation costs one skipped window, never a double-scale.

Providers implement the :class:`StateProvider` protocol —
``export_state()`` returning a JSON-able dict with a ``"records"``
count, ``import_state(state, rebase=, now=, max_age_s=)`` returning how
many records were restored.  In the port the controller registers the
resilience layer's section (``core/resilience.py``); the fleet pools
carry the same surface.

The port's copy of ``kube_sqs_autoscaler_tpu/core/durable.py``: the same
snapshot schema version, body layout and content hash, so a snapshot
either package wrote rehydrates the other's loop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, runtime_checkable

from .policy import PolicyState, initial_state

log = logging.getLogger(__name__)

#: Bump on any backward-incompatible change to the snapshot body.  The
#: reader refuses a mismatched snapshot by COLD-STARTING (never by
#: crashing): a rolled-back controller reading a newer build's state
#: must degrade to the reference behavior, not crash-loop the pod.
SNAPSHOT_SCHEMA_VERSION = 1

_SNAPSHOT_KIND = "control-plane-snapshot"
_INTENT_KIND = "actuation-intent"


class ControllerCrash(BaseException):
    """A simulated kill of the controller process (crash injection).

    Derives from ``BaseException`` on purpose: the loop's never-dies
    guards catch ``Exception`` only, so a crash injected at any seam
    propagates instantly — no retry, no stale hold, no observer, no
    snapshot — exactly like the process vanishing at that instant.
    """


@runtime_checkable
class StateProvider(Protocol):
    """One subsystem's durable-state surface."""

    def export_state(self) -> dict:
        """The subsystem's state as a JSON-able dict (``"records"``
        counts the restorable units inside, for recovery accounting)."""
        ...

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        """Restore from an exported dict; every saved clock instant
        shifts by ``rebase``.  Returns records actually restored
        (a provider may drop internally-expired ones)."""
        ...


@dataclass(frozen=True)
class _StoreEvent:
    """Restart/rehydrate instant for the Chrome-trace timeline (shaped
    like a :class:`~..fleet.pool.FleetEvent`; ``restart-*`` names land
    in their own trace category)."""

    name: str
    t: float
    args: dict = field(default_factory=dict)


@dataclass
class RehydrationReport:
    """What one startup recovered, expired, and refused."""

    cold_start: bool
    reason: str | None = None
    downtime_s: float = 0.0
    snapshot_age_s: float = 0.0
    records_recovered: int = 0
    records_expired: int = 0
    sections_recovered: list[str] = field(default_factory=list)
    sections_expired: list[str] = field(default_factory=list)
    snapshot_hash: str | None = None
    restarts: int = 0
    journal_tail_ticks: int = 0
    intent_applied: str | None = None
    duration_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _content_hash(body: dict) -> str:
    """sha256 of the canonical body (hash key excluded) — names exactly
    which state survived, for the journal restart header and the gates."""
    scrubbed = {k: v for k, v in body.items() if k != "hash"}
    canonical = json.dumps(scrubbed, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()[:16]


def _atomic_write(path: str, text: str) -> None:
    """write → flush → fsync → rename: the snapshot is either the old
    complete file or the new complete file, never a tear."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class DurableStateStore:
    """The controller's crash-safe memory: one snapshot file, rewritten
    atomically each tick; one rehydration at boot.

    ``wall_clock`` measures downtime across restarts (``time.time`` in
    production; a ``FakeClock.now`` in deterministic tests — the two
    processes of a restart must share it, exactly like SentTimestamp).
    ``max_age_s`` > 0 cold-starts when the snapshot is older than that
    (a controller down for an hour should not resurrect hour-old
    cooldowns as if they were news).  Providers register with
    :meth:`register`; order is preserved (export and import run in
    registration order).
    """

    def __init__(
        self,
        path: str,
        *,
        wall_clock: Callable[[], float] | None = None,
        max_age_s: float = 0.0,
        journal_path: str | None = None,
    ) -> None:
        if not path:
            raise ValueError("the durable store needs a snapshot path")
        if max_age_s < 0:
            raise ValueError(f"max_age_s must be >= 0, got {max_age_s}")
        self.path = path
        self.wall_clock = wall_clock or time.time
        self.max_age_s = max_age_s
        self.journal_path = journal_path
        self._providers: dict[str, tuple[Any, float | None]] = {}
        self.snapshots_written = 0
        self.snapshot_hash: str | None = None
        self.restarts = 0  # restored from the snapshot chain at rehydrate
        self.last_report: RehydrationReport | None = None
        self._restored_policy: PolicyState | None = None
        self._rehydrated = False
        self.metrics = None  # optional ControllerMetrics sink
        self.events: deque[_StoreEvent] = deque(maxlen=256)

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------

    def register(
        self, name: str, provider: Any, ttl_s: float | None = None
    ) -> None:
        """Register one named section.  ``ttl_s`` is the section's
        wall-clock expiry: a snapshot older than it restores nothing
        for this section (``None`` = never expires)."""
        if name in self._providers:
            raise ValueError(f"duplicate durable section {name!r}")
        if ttl_s is not None and ttl_s < 0:
            raise ValueError(f"ttl_s must be >= 0, got {ttl_s}")
        self._providers[name] = (provider, ttl_s)

    # ------------------------------------------------------------------
    # Snapshot (the per-tick write)
    # ------------------------------------------------------------------

    def snapshot(
        self,
        *,
        clock_now: float,
        policy_state: PolicyState,
        ticks: int = 0,
        last_tick_start: float | None = None,
    ) -> None:
        """Serialize the whole control plane and atomically replace the
        snapshot file.  Also clears any resolved actuation intent: the
        snapshot covers the tick the intent belonged to."""
        sections = {}
        for name, (provider, _ttl) in self._providers.items():
            try:
                sections[name] = provider.export_state()
            except Exception:
                # one broken exporter must not cost the others their
                # durability (and must never kill the loop)
                log.exception("durable section %r export failed", name)
        body = {
            "kind": _SNAPSHOT_KIND,
            "schema": SNAPSHOT_SCHEMA_VERSION,
            "saved_wall": self.wall_clock(),
            "saved_clock": clock_now,
            "ticks": ticks,
            "restarts": self.restarts,
            "policy": {
                "last_scale_up": policy_state.last_scale_up,
                "last_scale_down": policy_state.last_scale_down,
            },
            "last_tick_start": (
                clock_now if last_tick_start is None else last_tick_start
            ),
            "sections": sections,
        }
        body["hash"] = _content_hash(body)
        _atomic_write(self.path, json.dumps(body, separators=(",", ":")))
        self.snapshot_hash = body["hash"]
        self.snapshots_written += 1
        self._clear_intent()

    # ------------------------------------------------------------------
    # Write-ahead actuation intent
    # ------------------------------------------------------------------

    @property
    def intent_path(self) -> str:
        return self.path + ".intent"

    def note_intent(self, direction: str, clock_now: float) -> None:
        """Record "about to actuate ``direction``" durably, BEFORE the
        scaler RPC.  Rehydration treats an unresolved intent as "may
        have actuated" and advances the matching cooldown stamp — the
        pessimism that makes the after-actuate-before-journal crash
        window double-scale-proof."""
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up'/'down', got {direction!r}")
        body = {
            "kind": _INTENT_KIND,
            "direction": direction,
            "clock": clock_now,
            "wall": self.wall_clock(),
        }
        _atomic_write(self.intent_path, json.dumps(body))

    def _clear_intent(self) -> None:
        try:
            os.remove(self.intent_path)
        except FileNotFoundError:
            pass
        except OSError:
            # a stale intent is conservative (one skipped window), a
            # dead loop is not — never raise out of the snapshot path
            log.exception("could not clear actuation intent")

    def _load_intent(self, saved_wall: float) -> dict | None:
        """The unresolved intent, if one outlives the snapshot (a
        resolved intent is removed by :meth:`snapshot`; the wall-clock
        comparison is belt and braces for a failed removal)."""
        try:
            with open(self.intent_path, "r", encoding="utf-8") as fh:
                body = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(body, dict) or body.get("kind") != _INTENT_KIND:
            return None
        if body.get("direction") not in ("up", "down"):
            return None
        try:
            wall, clock = float(body["wall"]), float(body["clock"])
        except (KeyError, TypeError, ValueError):
            return None
        if wall < saved_wall:
            return None  # older than the snapshot: already resolved
        return {"direction": body["direction"], "clock": clock, "wall": wall}

    # ------------------------------------------------------------------
    # Load + rehydrate
    # ------------------------------------------------------------------

    def _load(self) -> tuple[dict | None, str | None]:
        """``(body, refusal_reason)`` — a missing/torn/corrupt/foreign
        snapshot returns ``(None, reason)``; this method never raises."""
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return None, None  # first boot: silent cold start
        except OSError as err:
            return None, f"snapshot unreadable: {err}"
        try:
            body = json.loads(raw)
        except ValueError:
            return None, "snapshot corrupt (not valid JSON — torn write?)"
        if not isinstance(body, dict) or body.get("kind") != _SNAPSHOT_KIND:
            return None, "snapshot is not a control-plane snapshot"
        schema = body.get("schema")
        if schema != SNAPSHOT_SCHEMA_VERSION:
            return None, (
                f"snapshot schema {schema!r} unsupported (this build "
                f"reads {SNAPSHOT_SCHEMA_VERSION}) — refusing a foreign "
                "build's state"
            )
        if body.get("hash") != _content_hash(body):
            return None, "snapshot content hash mismatch (corrupt)"
        return body, None

    def rehydrate(
        self,
        clock_now: float,
        *,
        observed_replicas: int | None = None,
    ) -> RehydrationReport:
        """Restore the control plane from snapshot + journal tail.

        Idempotent per store instance (one boot rehydrates once).  On
        ANY refusal the report says why and the loop cold-starts with
        the reference's ``initial_state`` grace — rehydration must
        never be able to crash-loop the controller.
        """
        if self._rehydrated:
            assert self.last_report is not None
            return self.last_report
        self._rehydrated = True
        if self.metrics is not None:
            begin = getattr(self.metrics, "begin_rehydration", None)
            if begin is not None:
                begin()
        started = time.perf_counter()
        self._event("restart-detected", clock_now)
        body, reason = self._load()
        restart_seen = body is not None or reason is not None
        if body is None:
            # a refused file is still a restart (the pod DID come back):
            # the chain stays monotone in the snapshots this boot writes,
            # even though the corrupt predecessor's count is unreadable
            self.restarts = 1 if restart_seen else 0
            report = RehydrationReport(
                cold_start=True, reason=reason, restarts=self.restarts,
            )
            if reason is not None:
                log.warning("Cold start: %s", reason)
            return self._finish(report, clock_now, started)
        downtime = max(0.0, self.wall_clock() - float(body["saved_wall"]))
        self.restarts = int(body.get("restarts", 0)) + 1
        if self.max_age_s and downtime > self.max_age_s:
            report = RehydrationReport(
                cold_start=True,
                reason=(
                    f"snapshot is {downtime:.0f}s old, past the "
                    f"{self.max_age_s:g}s limit — stale memory is worse "
                    "than no memory"
                ),
                downtime_s=downtime, snapshot_age_s=downtime,
                snapshot_hash=body.get("hash"), restarts=self.restarts,
            )
            log.warning("Cold start: %s", report.reason)
            return self._finish(report, clock_now, started)

        rebase = (clock_now - downtime) - float(body["saved_clock"])
        report = RehydrationReport(
            cold_start=False, downtime_s=downtime,
            snapshot_age_s=downtime, snapshot_hash=body.get("hash"),
            restarts=self.restarts,
        )
        sections = body.get("sections") or {}
        for name, (provider, ttl) in self._providers.items():
            section = sections.get(name)
            if not isinstance(section, dict):
                continue
            declared = int(section.get("records", 0) or 0)
            if ttl is not None and downtime > ttl:
                report.records_expired += declared
                report.sections_expired.append(name)
                continue
            try:
                recovered = int(provider.import_state(
                    section, rebase=rebase, now=clock_now,
                    max_age_s=ttl or 0.0,
                ))
            except Exception:
                log.exception("durable section %r import failed", name)
                report.records_expired += declared
                report.sections_expired.append(name)
                continue
            report.records_recovered += recovered
            report.records_expired += max(0, declared - recovered)
            report.sections_recovered.append(name)

        # cooldown stamps, rebased onto this boot's clock
        policy = body.get("policy") or {}
        try:
            state = PolicyState(
                last_scale_up=float(policy["last_scale_up"]) + rebase,
                last_scale_down=float(policy["last_scale_down"]) + rebase,
            )
        except (KeyError, TypeError, ValueError):
            state = initial_state(clock_now)

        # journal tail: ticks the journal recorded after the snapshot's
        # last covered tick (the crash windows between journal line and
        # snapshot write) — re-driven through every provider's on_tick
        last_covered = float(body.get("last_tick_start", body["saved_clock"]))
        state, tail = self._replay_journal_tail(state, last_covered, rebase)
        report.journal_tail_ticks = tail

        # unresolved write-ahead intent: assume the RPC landed
        intent = self._load_intent(float(body["saved_wall"]))
        if intent is not None:
            stamp = intent["clock"] + rebase
            if intent["direction"] == "up":
                state = dataclasses.replace(
                    state, last_scale_up=max(state.last_scale_up, stamp)
                )
            else:
                state = dataclasses.replace(
                    state, last_scale_down=max(state.last_scale_down, stamp)
                )
            report.intent_applied = intent["direction"]
            log.warning(
                "Unresolved scale-%s intent from the crashed boot: "
                "assuming it actuated (cooldown stamp advanced — "
                "pessimistic, never double-scales)", intent["direction"],
            )
        # The intent is NOT cleared here: the advanced stamp only
        # becomes durable at this boot's first snapshot, and a second
        # crash before that tick must find the intent again (clearing
        # now would re-open the exact double-scale window it closes).
        # snapshot() clears it once a covering snapshot exists, and the
        # wall-clock guard in _load_intent makes any leftover a no-op.

        # the observed world outranks the remembered one
        if observed_replicas is not None:
            for name, (provider, _ttl) in self._providers.items():
                reconcile = getattr(provider, "reconcile_observed", None)
                if reconcile is not None:
                    try:
                        reconcile(int(observed_replicas))
                    except Exception:
                        log.exception("durable section %r reconcile failed",
                                      name)

        self._restored_policy = state
        log.info(
            "Warm restart: recovered %d record(s) across %s, expired %d, "
            "downtime %.1fs, %d journal-tail tick(s)",
            report.records_recovered, report.sections_recovered or "nothing",
            report.records_expired, downtime, tail,
        )
        return self._finish(report, clock_now, started)

    def _replay_journal_tail(
        self, state: PolicyState, last_covered: float, rebase: float
    ) -> tuple[PolicyState, int]:
        """Re-drive post-snapshot journal records (rebased) through the
        providers and the cooldown stamps.  Only the crashed boot's
        episode is in the snapshot's clock domain, so the tail is the
        journal's newest non-empty boot (rotation continuations
        included, restart headers excluded)."""
        if not self.journal_path:
            return state, 0
        # Deferred, optional use of the obs layer: the reader is only
        # needed when a journal is actually configured, and importing it
        # lazily keeps the core package import-free of obs at module
        # load (obs imports core at module level; this must not cycle).
        try:
            from ..obs.journal import read_journal_episodes

            episodes = read_journal_episodes(self.journal_path)
        except Exception:
            return state, 0  # no journal / unreadable: nothing to stitch
        # newest boot = trailing continuation episodes plus the first
        # non-continuation episode under them, skipping empty trailers
        boot: list = []
        for meta, records in reversed(episodes):
            if not records and not boot:
                continue
            boot = list(records) + boot
            if not meta.get("_continuation"):
                break
        applied = 0
        for record in boot:
            if record.start <= last_covered + 1e-9:
                continue
            rebased = dataclasses.replace(
                record, start=record.start + rebase
            )
            applied += 1
            if rebased.scaled("up"):
                state = dataclasses.replace(
                    state,
                    last_scale_up=max(state.last_scale_up, rebased.start),
                )
            if rebased.scaled("down"):
                state = dataclasses.replace(
                    state,
                    last_scale_down=max(state.last_scale_down, rebased.start),
                )
            for _name, (provider, _ttl) in self._providers.items():
                on_tick = getattr(provider, "on_tick", None)
                if on_tick is not None:
                    try:
                        on_tick(rebased)
                    except Exception:
                        log.exception("journal-tail replay failed for %r",
                                      _name)
        return state, applied

    def _finish(
        self, report: RehydrationReport, clock_now: float, started: float
    ) -> RehydrationReport:
        report.duration_s = time.perf_counter() - started
        self.last_report = report
        self._event(
            "restart-rehydrated", clock_now,
            cold_start=report.cold_start,
            recovered=report.records_recovered,
            expired=report.records_expired,
            snapshot_hash=report.snapshot_hash,
        )
        if self.metrics is not None:
            sink = getattr(self.metrics, "set_rehydration", None)
            if sink is not None:
                try:
                    sink(report)
                except Exception:
                    log.exception("rehydration metrics export failed")
        return report

    def restored_policy_state(self) -> PolicyState | None:
        """The rebased cooldown stamps (``None`` = cold start)."""
        return self._restored_policy

    def take_restored_policy_state(self) -> PolicyState | None:
        """Consume the restored stamps (one episode gets them).  A
        SECOND ``run()`` on the same loop is a fresh episode by the
        loop's contract — it must get the reference startup grace, not
        the boot-time stamps re-applied over whatever the first episode
        actuated."""
        state, self._restored_policy = self._restored_policy, None
        return state

    def restart_journal_meta(self) -> dict:
        """The restart block for a freshly-reopened journal's header:
        which snapshot the new boot rose from and how much state
        actually survived — ``sim.replay.stitch_restart_episodes``
        pairs it with the pre-crash episode."""
        report = self.last_report
        if report is None:
            return {}
        return {
            "snapshot_hash": report.snapshot_hash,
            "records_recovered": report.records_recovered,
            "records_expired": report.records_expired,
            "cold_start": report.cold_start,
            "restarts": report.restarts,
            "downtime_s": round(report.downtime_s, 3),
        }

    def journal_meta_after_rehydrate(
        self,
        clock_now: float,
        meta: dict,
        *,
        observed_replicas: int | None = None,
    ) -> dict:
        """Rehydrate (idempotent), then return ``meta`` with the
        restart block stamped in — the ONE correct ordering for a boot
        that records a journal: rehydration must run BEFORE the journal
        reopens on ``journal_path`` (the tail replay reads the
        pre-crash file state, and the fresh header must carry the
        restart block), so this helper makes the ordering uninvertible
        at every call site."""
        self.rehydrate(clock_now, observed_replicas=observed_replicas)
        restart = self.restart_journal_meta()
        return {**meta, "restart": restart} if restart else dict(meta)

    def _event(self, name: str, t: float, **args) -> None:
        self.events.append(_StoreEvent(name, t, args))
