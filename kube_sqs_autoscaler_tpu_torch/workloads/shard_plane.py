"""The sharded serving plane: engine shards gang-stepped in one dispatch.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/shard_plane.py``
without the comms and lifecycle hooks.  On a serving mesh (``mesh=``, the
batcher's) each data rank steps whole shards of the rows (``shards`` must
divide by the ``data`` axis) at its heads over ``model``.  A
fleet of independent :class:`~.continuous.ContinuousWorker` replicas
steps its engines one after another from one Python thread; this plane
runs the whole fleet's decode as one call over a shard axis:

- **slot state** is the :class:`~.continuous.ContinuousBatcher`'s flat
  ``[S*B]`` rows (shard ``s`` owns rows ``[s*B, (s+1)*B)``), so the
  insert, the liveness state and the cache are the batcher's own;
- **one gang step a cycle**: :func:`~.decode.gang_block_decode` advances
  every shard up to ``decode_block`` tokens in one :func:`~.decode.
  block_decode` of the family's decode step over all ``S*B`` rows (either
  model family, as the batcher), and reduces a ``[S]`` free-slot
  summary and a ``[S]`` health flag on the device;
- **one admission plane**: a refill's requests go to the freest admitting
  shard one at a time (ties to the lowest shard) and prefill as one
  ``[M, P]`` insert over global rows, through the CUDA flash forward on
  the card, however the refill splits across shards;
- **one settle copy a cycle**: the cycle's deferred first tokens and the
  settled block's tokens, counts, free summary and health flags go to the
  host behind one :class:`~.continuous._HostCopy`, enqueued after the
  refill's inserts and before the next gang step, and the host waits once
  for its event while the next block runs;
- **scale by mask**: :meth:`ShardedBatcher.set_shard_active` flips a
  device ``[S]`` bit and its host mirror; a masked shard admits nothing
  and its rows in flight decode to completion (drain);
- **tenancy** (``tenancy``, a :class:`~.tenancy.TenancyConfig`): the
  batcher's per-tenant attribution, and with ``tenancy.prefix_pool > 0``
  one :class:`~.tenancy.PrefixPool` partition per shard.  A prefixed
  admission routes affinity first (:meth:`ShardedBatcher._route_prefixed`):
  a tenant's first admission pins it to the freest shard, its home, where
  its prefix entry stays resident; a spill to another shard when home is
  full or trails pays one foreign install and leaves the home in place.

Both cache layouts and the shared prefix reach the plane as the batcher's
knobs (``quantized_kv``, ``prefix_cache``): the flat rows hold int8 codes
and scales, or start past the prefix, and the gang step runs the layout's
decode step, as the reference's plane composes them.

The health sentinels behind the pool's quarantine (NaN logits, no
progress, a device mask that disagrees with the host's) are read from
that one copy, so detection costs no extra wait.  Greedy outputs equal
``S`` independent engines': rows never interact.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import numpy as np
import torch

from .continuous import ContinuousBatcher, _HostCopy, _Slot, _to_device
from .decode import gang_block_decode


class _ProbingFlags(list):
    """``shard_probing`` as the plain list the pool's quarantine state
    machine writes in place; every write invalidates the plane's cached
    admission availability, so the half-open cap holds at the next
    refill."""

    def __init__(self, flags, owner) -> None:
        super().__init__(flags)
        self._owner = owner

    def __setitem__(self, index, value) -> None:
        super().__setitem__(index, value)
        self._owner._invalidate_admission_cache()


def _stream_mark(device: torch.device):
    """An event recorded on ``device``'s stream now (``None`` off the
    card): :meth:`ShardedBatcher._step_gang` asks it whether the block it
    just dispatched was still running when the settle finished."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class ShardedBatcher(ContinuousBatcher):
    """``shards`` gang-stepped engine shards of ``shard_slots`` slots each
    behind one admission plane.

    Takes the :class:`~.continuous.ContinuousBatcher` knobs, with
    ``batch_size`` replaced by ``shards`` x ``shard_slots``; plain decode
    path only (no beams, no speculative slots).  Counters beyond the
    batcher's: ``gang_cycles`` (cycles that dispatched a gang block, equal
    to ``decode_dispatches``) and ``summary_transfers`` (settled blocks
    whose ``[S]`` summary reached the host).  ``host_transfers`` counts one
    per cycle that fetched anything, as the reference's plane does without
    a comms scheduler."""

    def __init__(
        self,
        params: dict,
        config,
        *,
        shards: int,
        shard_slots: int,
        prompt_len: int,
        generate_tokens: int,
        **kwargs,
    ) -> None:
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        if shard_slots < 1:
            raise ValueError(f"shard_slots={shard_slots} must be >= 1")
        if kwargs.get("beams", 1) > 1 or kwargs.get("draft_layers", 0):
            raise ValueError(
                "the sharded plane applies to the plain continuous decode "
                "path (not beams / speculative slots)"
            )
        mesh = kwargs.get("mesh")
        if mesh is not None and shards % mesh.shape["data"]:
            # each data rank steps WHOLE shards of the [S*B] rows; checked
            # before the base constructor allocates the cache
            raise ValueError(
                f"shards ({shards}) not divisible by the mesh's data "
                f"axis ({mesh.shape['data']})"
            )
        self.shards = shards
        self.shard_slots = shard_slots
        # admission availability per shard, memoized until the next
        # change of eligibility (_admission_rows_by_shard)
        self._avail_cache: list[list[int]] | None = None
        super().__init__(
            params, config, batch_size=shards * shard_slots,
            prompt_len=prompt_len, generate_tokens=generate_tokens,
            **kwargs,
        )
        with torch.inference_mode():
            # the device scale mask (True = the shard admits) and the
            # fault seams (sim.faults.FleetFaultPlan); the host mirrors
            # below are what the router reads
            self._shard_active = torch.ones(shards, dtype=torch.bool,
                                            device=self.device)
            self._shard_poison = torch.zeros(shards, dtype=torch.bool,
                                             device=self.device)
            self._shard_wedge = torch.zeros(shards, dtype=torch.bool,
                                            device=self.device)
        self.shard_admitting = [True] * shards
        # half-open probe: a probing shard admits at most one request
        self.shard_probing = _ProbingFlags([False] * shards, self)
        self.shard_poisoned = [False] * shards
        self.shard_wedged = [False] * shards
        # discard a NaN-flagged shard's whole settled block?  Only safe
        # under a supervisor that quarantines and evacuates the rows
        # (ShardedWorkerPool opts in); standalone, requests complete and the
        # health flag still reports the corruption
        self.discard_bad_blocks = False
        # health sentinels, updated at each settle from the one copy: the
        # last [S] NaN flags, tokens per shard of the settled block (gang
        # only and with first tokens), completions, consecutive busy
        # settles with no progress, and device-vs-host mask mismatches
        self.last_health_bad: np.ndarray | None = None
        self.shard_last_progress = [0] * shards
        self.shard_last_gang_progress = [0] * shards
        self.shard_last_completed = [0] * shards
        self.shard_stall_cycles = [0] * shards
        self.last_settle_busy = [0] * shards
        self.mask_mismatch = [False] * shards
        # settles to skip in the mismatch check after a mask-on flip: the
        # next settled summary predates the flip
        self._mask_grace = [0] * shards
        self.shard_tokens = [0] * shards
        self.shard_ttft: list[deque] = [deque(maxlen=1024)
                                        for _ in range(shards)]
        # the last settled [S] free-slot summary (None until a block
        # settles): one cycle behind the host's own bookkeeping
        self.last_free_summary: np.ndarray | None = None
        self.gang_cycles = 0
        self.summary_transfers = 0
        self._gang_fn = gang_block_decode
        # the gang step takes any block >= 1, so the decode_block knob
        # applies at any constructed size
        self._block_engine = True

    # -- engine identity -------------------------------------------------

    def _engine_key(self) -> tuple:
        return super()._engine_key() + (self.shards, self.shard_slots)

    def adopt_engine(self, source: ContinuousBatcher) -> None:
        if not isinstance(source, ShardedBatcher):
            raise ValueError("a sharded plane adopts from a sharded donor only")
        super().adopt_engine(source)  # checks the whole engine key
        self._gang_fn = source._gang_fn

    # -- scale: mask flips -----------------------------------------------

    def set_shard_active(self, shard: int, active: bool) -> None:
        """Flip shard ``shard``'s admission mask, on the device and in the
        host mirror: a masked shard admits nothing and its rows in flight
        decode to completion; unmasking is the same flip back."""
        self._check_shard(shard)
        self._invalidate_admission_cache()
        self.shard_admitting[shard] = bool(active)
        with torch.inference_mode():
            self._shard_active[shard] = bool(active)
        if active:
            self._mask_grace[shard] = 2

    # -- fault seams (flag flips folded into the next gang step) ---------

    def inject_poison(self, shard: int, poisoned: bool = True) -> None:
        """Poisoned-logits fault: the shard's decode logits become NaN; the
        health flag reports it at the same settle."""
        self._check_shard(shard)
        self.shard_poisoned[shard] = bool(poisoned)
        with torch.inference_mode():
            self._shard_poison[shard] = bool(poisoned)

    def inject_wedge(self, shard: int, wedged: bool = True) -> None:
        """Wedged-shard fault: the shard's rows freeze (compute, emit and
        advance nothing), the no-progress signature."""
        self._check_shard(shard)
        self.shard_wedged[shard] = bool(wedged)
        with torch.inference_mode():
            self._shard_wedge[shard] = bool(wedged)

    def corrupt_active_mask(self, shard: int) -> None:
        """Mask-corruption fault: clear the device bit and leave the host
        mirror, so the summary and the router disagree;
        :meth:`set_shard_active` heals it."""
        self._check_shard(shard)
        with torch.inference_mode():
            self._shard_active[shard] = False

    def _check_shard(self, shard: int) -> None:
        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} out of range [0, {self.shards})")

    # -- evacuation (the pool's quarantine path) -------------------------

    def kill_rows(self, rows) -> None:
        """Stop the device rows of evacuated requests: done, no budget, so
        later gang blocks freeze them (a block already in flight may still
        step them once; its tokens land on free slots and are dropped)."""
        rows = list(rows)
        if not rows:
            return
        idx = _to_device(np.asarray(rows, np.int64), self.device)
        with torch.inference_mode():
            self._done[idx] = True
            self._remaining[idx] = 0

    def take_shard_inflight(self, shard: int) -> list[tuple]:
        """Remove and return the shard's unfinished requests as
        ``(payload, produced, budget, submitted_at)`` (the
        :meth:`~.continuous.ContinuousBatcher.submit_resume` record less
        the prompt); their slots are freed and their device rows killed.
        Deferred first tokens are settled first, so a row admitted this
        cycle carries its first token along."""
        from ..obs.lifecycle import request_key

        self._check_shard(shard)
        self._invalidate_admission_cache()
        lc = self.lifecycle
        evac_t0 = lc.now_fn() if lc is not None else None
        self._settle_pending_firsts()
        taken, killed, rids = [], [], []
        for row in self.shard_rows(shard):
            slot = self.slots[row]
            if not self._needs_decode(slot):
                continue
            taken.append((slot.payload, list(slot.produced), slot.budget,
                          slot.submitted_at))
            rids.append(request_key(slot.payload))
            if lc is not None:
                # the trace survives the move: the resume (or the queue's
                # redelivery) continues the same chain
                lc.note(rids[-1], "evacuated")
            self.slots[row] = _Slot()
            killed.append(row)
        self.kill_rows(killed)
        evac_op = None
        if killed and self.comms is not None and self.comms.enabled:
            from ..comms.ops import EVACUATION_KV

            # the rows leave the draining shard for host staging
            evac_op = self.comms.record(
                EVACUATION_KV, "host", source=f"shard:{shard}",
                nbytes=self._row_kv_nbytes() * len(killed),
                args={"shard": shard, "rows": len(killed)},
            )
        if killed and lc is not None:
            # the evacuation is a transfer: a paired window on each
            # evacuated trace, so attribute_slo can name it
            done_t = lc.now_fn()
            route = evac_op.args.get("route") if evac_op is not None else None
            for rid in rids:
                if rid is None:
                    continue
                if route is not None:
                    # appended before the stamps, so the i-th route stays
                    # zipped onto the i-th transfer span
                    lc.route(rid, route)
                lc.stamp(rid, "transfer", t=evac_t0)
                lc.stamp(rid, "transfer_done", t=done_t)
                lc.note(rid, "transfer_evacuation_kv")
        return taken

    def clear_shard_health(self, shard: int) -> None:
        """Reset the shard's sentinels (at quarantine, so readings from
        before it count neither for nor against the probe)."""
        self.shard_stall_cycles[shard] = 0
        self.shard_last_progress[shard] = 0
        self.shard_last_gang_progress[shard] = 0
        self.shard_last_completed[shard] = 0
        self.last_settle_busy[shard] = 0
        self.mask_mismatch[shard] = False
        if self.last_health_bad is not None:
            self.last_health_bad = np.array(self.last_health_bad)
            self.last_health_bad[shard] = False

    def shard_suspects(self, stall_grace: int = 3) -> list[tuple[int, str]]:
        """Shards the last settle's sentinels indict, with the cause:
        ``poisoned-logits`` (NaN flag), ``no-progress`` (busy rows and no
        token for ``stall_grace`` settles in a row) or ``mask-mismatch``
        (the device mask left the host's).  Quarantine is the pool's."""
        suspects = []
        bad = self.last_health_bad
        for s in range(self.shards):
            if bad is not None and bool(bad[s]):
                suspects.append((s, "poisoned-logits"))
            elif self.shard_stall_cycles[s] >= stall_grace:
                suspects.append((s, "no-progress"))
            elif self.mask_mismatch[s]:
                suspects.append((s, "mask-mismatch"))
        return suspects

    def shard_rows(self, shard: int) -> range:
        return range(shard * self.shard_slots, (shard + 1) * self.shard_slots)

    def shard_busy(self, shard: int) -> int:
        """Slots of ``shard`` holding a request (host view)."""
        return sum(self.slots[row].busy for row in self.shard_rows(shard))

    def shard_free(self, shard: int) -> int:
        return self.shard_slots - self.shard_busy(shard)

    # -- the admission plane: freest-first routing -----------------------

    def _invalidate_admission_cache(self) -> None:
        self._avail_cache = None

    def _admission_rows_by_shard(self) -> list[list[int]]:
        """The admission-eligible rows of each shard: free, unquiesced
        rows of admitting shards, at most one while a shard probes, at most
        ``slot_limit - busy`` under the slot limit.  Memoized until an
        eligibility change (:meth:`_invalidate_admission_cache`), so one
        scan serves a cycle's reads; callers treat the lists as
        read-only."""
        if self._avail_cache is not None:
            return self._avail_cache
        per_shard = [
            [row for row in self.shard_rows(s)
             if not self.slots[row].busy and row not in self._tainted]
            if self.shard_admitting[s] else []
            for s in range(self.shards)
        ]
        for s in range(self.shards):
            if self.shard_probing[s]:
                per_shard[s] = per_shard[s][: max(0, 1 - self.shard_busy(s))]
        if self.slot_limit is not None:
            for s in range(self.shards):
                if per_shard[s]:
                    cap = max(0, self.slot_limit - self.shard_busy(s))
                    per_shard[s] = per_shard[s][:cap]
        self._avail_cache = per_shard
        return per_shard

    @property
    def free_slots(self) -> list[int]:
        """Admission-eligible rows in routing order: each next request
        goes to the shard with the most eligible rows left (ties to the
        lowest shard), so a refill larger than one shard's room splits
        across shards.  ``submit_many`` taking this order is the router."""
        self.free_slot_scans += 1
        per_shard = self._admission_rows_by_shard()
        order: list[int] = []
        heads = [0] * self.shards
        while True:
            best, best_avail = -1, 0
            for s in range(self.shards):
                avail = len(per_shard[s]) - heads[s]
                if avail > best_avail:  # strict: ties keep the lowest s
                    best, best_avail = s, avail
            if best < 0:
                break
            order.append(per_shard[best][heads[best]])
            heads[best] += 1
        return order

    def _route_prefixed(self, keys: list) -> list[int]:
        """Rows for a prefixed admission batch, affinity first, then
        freest.  A key's first admission makes the freest shard (ties to
        the lowest index, as :attr:`free_slots`) its home, where its prefix
        entry is resident in the shard's pool partition; later admissions
        stay home unless home has no eligible row or the freest shard
        leads it by ``tenancy.sticky_imbalance`` free rows or more (0: the
        shard's slot count, so only a full home yields).  A spill goes to
        the freest shard and leaves the home in place: it pays one foreign
        install and the key goes home at its next refill.  The home map
        is LRU-touched on every lookup and capped at 4096 keys;
        ``tenancy.sticky=False`` routes freest first."""
        per_shard = self._admission_rows_by_shard()
        heads = [0] * self.shards
        sticky = self.tenancy is not None and self.tenancy.sticky
        threshold = (self.tenancy.sticky_imbalance
                     if self.tenancy is not None
                     and self.tenancy.sticky_imbalance
                     else self.shard_slots)

        def avail(s: int) -> int:
            return len(per_shard[s]) - heads[s]

        def freest() -> int:
            best, best_avail = -1, 0
            for s in range(self.shards):
                if avail(s) > best_avail:  # strict: ties keep the lowest s
                    best, best_avail = s, avail(s)
            return best

        rows: list[int] = []
        for key in keys:
            pick = None
            home = self._tenant_home.get(key)
            if home is not None:
                # touched on every lookup: the cap evicts cold keys, never
                # a busy long-lived tenant's home
                self._tenant_home.move_to_end(key)
            if sticky and home is not None and avail(home) > 0:
                top = freest()
                if top < 0 or avail(top) - avail(home) < threshold:
                    pick = home
            if pick is None:
                pick = freest()
                if pick < 0:
                    raise RuntimeError(
                        "no admission-eligible slot for a routed request "
                        "(caller must size batches by free_slots)"
                    )
                if sticky and home is None:
                    self._tenant_home[key] = pick
                    self._tenant_home.move_to_end(key)
                    while len(self._tenant_home) > 4096:
                        self._tenant_home.popitem(last=False)
            rows.append(per_shard[pick][heads[pick]])
            heads[pick] += 1
        return rows

    def _pool_shard_of(self, row: int) -> int:
        return row // self.shard_slots

    def _free_slot_count(self) -> int:
        return sum(len(rows) for rows in self._admission_rows_by_shard())

    # -- the engine cycle ------------------------------------------------

    def step(self) -> list[tuple[Any, np.ndarray]]:
        """Dispatch one gang block over every shard's busy slots, then
        settle the previous block and the cycle's first tokens from one
        host copy; returns the finished ``(payload, tokens)`` pairs, as the
        block engine does."""
        if self.active == 0 and not self._tainted:
            return []
        return self._step_gang()

    def _defer_firsts(self, firsts: torch.Tensor, rows: list[int]) -> None:
        # kept on the device: the cycle's settle copies them with the block
        self._pending_firsts.append((firsts, list(rows)))

    def _settle_pending_firsts(self) -> None:
        """Settle the deferred first tokens outside a cycle (evacuation):
        one copy, counted as the reference counts, one per insert."""
        if not self._pending_firsts:
            return
        pending, self._pending_firsts = self._pending_firsts, []
        with torch.inference_mode():
            copy = _HostCopy(*[firsts for firsts, _ in pending])
        values = copy.wait()
        blocking = 0
        for firsts, _ in pending:
            op = self._first_ops.pop(id(firsts), None)
            if self.comms is not None and op is not None and op.dispatched:
                self.comms.finish(op)
            else:
                blocking += 1
        self.host_transfers += blocking
        self._record_firsts([(vals, rows)
                             for vals, (_, rows) in zip(values, pending)])

    def _record_firsts(self, pending_host: list) -> None:
        for _, rows in pending_host:
            for row in rows:
                self.shard_tokens[row // self.shard_slots] += 1
        super()._record_firsts(pending_host)

    def _note_ttft(self, row: int, ttft: float) -> None:
        self.shard_ttft[row // self.shard_slots].append(ttft)

    def _first_pull(self, entry) -> tuple:
        # the plane's first tokens stay on the device until the cycle's
        # one combined copy, whose wait the step itself makes
        return entry, None

    def _block_pull(self, block) -> tuple:
        # the gang block's tokens, counts, free summary and health flags
        return block[:4], None

    def _comms_source(self, rows) -> str:
        # a pull of one shard's rows leaves from that shard; a gang-wide
        # pull stays the generic device endpoint
        if rows:
            shards = {row // self.shard_slots for row in rows}
            if len(shards) == 1:
                return f"shard:{shards.pop()}"
        return super()._comms_source(rows)

    def _step_gang(self) -> list[tuple[Any, np.ndarray]]:
        pending_firsts, self._pending_firsts = self._pending_firsts, []
        pending = self._pending_block
        arrays = [firsts for firsts, _ in pending_firsts]
        if pending is not None:
            arrays += pending[:4]
        copy = None
        with torch.inference_mode():
            if arrays:
                # behind this cycle's inserts and the pending block, ahead
                # of the block dispatched below: its wait covers no new work
                copy = _HostCopy(*arrays)
            new_block, mark = None, None
            busy = self.active
            if busy and self._pending_decode_block is None:
                # a staged decode_block change skips one dispatch, so the
                # block in flight settles at the old size
                (self.cache, self._current, self._done, self._remaining,
                 tokens, counts, free, bad) = self._gang_fn(
                    self.params, self.cache, self._current, self._done,
                    self._remaining, self._block_keys(), self._shard_active,
                    self.config, self._step_fn, shards=self.shards,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, eos_id=self.eos_id,
                    poison=(self._shard_poison if any(self.shard_poisoned)
                            else None),
                    wedge=(self._shard_wedge if any(self.shard_wedged)
                           else None),
                )
                mark = _stream_mark(self.device)
                self.decode_dispatches += 1
                self.gang_cycles += 1
                new_block = (tokens, counts, free, bad, busy,
                             [self.shard_busy(s) for s in range(self.shards)],
                             list(self.slots))
        if self.comms is not None:
            # the dispatch-ahead window: the pulls of this cycle's settle
            # are scheduled while the gang block above computes
            self._comms_flush(pending_firsts, pending,
                              overlapped=(new_block is not None
                                          or pending is not None))
        self._pending_block = new_block
        if copy is not None:
            host = copy.wait()
            if self.comms is None:
                self.host_transfers += 1
            else:
                self._finish_gang_pulls(pending_firsts, pending)
            firsts_host, block_host = (host[: len(pending_firsts)],
                                       host[len(pending_firsts):])
            # first tokens count as shard progress: a budget-1 row is never
            # live in a gang block
            firsts_by_shard = [0] * self.shards
            for _, rows in pending_firsts:
                for row in rows:
                    firsts_by_shard[row // self.shard_slots] += 1
            if pending_firsts:
                self._record_firsts([
                    (vals, rows)
                    for vals, (_, rows) in zip(firsts_host, pending_firsts)])
            if pending is not None:
                self._settle_block(pending, block_host, firsts_by_shard)
                if mark is not None and not mark.query():
                    self.overlapped_settles += 1
        # every block dispatched before the last quiesce has settled, so
        # the quiesced rows may take requests again
        if self._tainted:
            self._invalidate_admission_cache()
            self._tainted.clear()
        if self._pending_block is None:
            self._apply_pending_decode_block()
        busy_before = [self.shard_busy(s) for s in range(self.shards)]
        finished = self._finish_ready()
        for s in range(self.shards):
            self.shard_last_completed[s] = busy_before[s] - self.shard_busy(s)
        if pending is not None:
            self._update_mask_mismatch()
        return finished

    def _finish_gang_pulls(self, pending_firsts, pending) -> None:
        """Close the settle pulls of a cycle's combined copy; the copy
        counts as a blocking host transfer unless every array in it was
        pulled inside the window."""
        block_op, self._block_op = self._block_op, None
        first_ops = [self._first_ops.pop(id(firsts), None)
                     for firsts, _ in pending_firsts]
        prefetched = [op for op in first_ops
                      if op is not None and op.dispatched]
        block_prefetched = block_op is not None and block_op.dispatched
        for op in prefetched:
            self.comms.finish(op)
        if block_prefetched:
            self.comms.finish(block_op)
        if (len(prefetched) != len(pending_firsts)
                or (pending is not None and not block_prefetched)):
            self.host_transfers += 1

    def _settle_block(self, pending, block_host, firsts_by_shard) -> None:
        """Emit a settled gang block's tokens and update the sentinels."""
        toks_host, counts_host, free_host, bad_host = block_host
        _, _, _, _, dispatched_busy, busy_by_shard, owners = pending
        self.last_free_summary = free_host
        self.last_health_bad = np.asarray(bad_host, bool)
        self.summary_transfers += 1
        self.block_settles += 1
        self.block_capacity += self.decode_block * dispatched_busy
        progress = counts_host.reshape(self.shards, self.shard_slots).sum(1)
        for s in range(self.shards):
            total = int(progress[s]) + firsts_by_shard[s]
            self.shard_last_progress[s] = total
            self.shard_last_gang_progress[s] = int(progress[s])
            self.last_settle_busy[s] = busy_by_shard[s]
            # busy rows at dispatch and no token back: a wedged shard (a
            # poisoned one keeps progressing; its NaN flag catches it)
            if busy_by_shard[s] > 0 and total == 0:
                self.shard_stall_cycles[s] += 1
            else:
                self.shard_stall_cycles[s] = 0
        for row, slot in enumerate(self.slots):
            if not slot.busy or slot is not owners[row]:
                # a row evacuated after the dispatch, whose slot a later
                # admission may already hold: the block computed the old
                # request there
                continue
            shard = row // self.shard_slots
            if self.discard_bad_blocks and self.last_health_bad[shard]:
                # garbage from NaN logits never reaches a slot; quarantine
                # re-decodes the rows from their last clean token
                continue
            for token in toks_host[: int(counts_host[row]), row]:
                if slot.done or len(slot.produced) >= slot.budget:
                    break
                self._emit(slot, int(token))
                self.shard_tokens[shard] += 1
                self.block_tokens += 1

    def _update_mask_mismatch(self) -> None:
        """Compare the settled ``[S]`` free summary with the host's slots.
        For an honestly admitting shard the device can only over-report
        free slots (its summary is one block older), so ``device == 0 <
        host free`` means the device mask diverged.  No transfer."""
        summary = self.last_free_summary
        if summary is None:
            return
        for s in range(self.shards):
            if self._mask_grace[s] > 0:
                self._mask_grace[s] -= 1
                self.mask_mismatch[s] = False
                continue
            self.mask_mismatch[s] = (
                self.shard_admitting[s]
                and int(summary[s]) == 0
                and self.shard_free(s) > 0
            )

    # -- observability ---------------------------------------------------

    def shard_stats(self, served_since: float | None = None) -> list[dict]:
        """Per-shard gauge rows: admitting, probing, busy slots,
        ``device_free`` (the last settled summary, None before one),
        the NaN flag, stall count, tokens and tokens/s since
        ``served_since``."""
        now = time.perf_counter()
        elapsed = (now - served_since
                   if served_since is not None and now > served_since
                   else 0.0)
        summary = self.last_free_summary
        bad = self.last_health_bad
        return [
            {
                "shard": s,
                "active": self.shard_admitting[s],
                "probing": self.shard_probing[s],
                "active_slots": self.shard_busy(s),
                "device_free": (int(summary[s]) if summary is not None
                                else None),
                "bad": bool(bad[s]) if bad is not None else False,
                "stall_cycles": self.shard_stall_cycles[s],
                "tokens": self.shard_tokens[s],
                "tokens_per_second": (self.shard_tokens[s] / elapsed
                                      if elapsed > 0 else 0.0),
            }
            for s in range(self.shards)
        ]
