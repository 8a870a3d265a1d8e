"""The prefill plane: admission-only replicas that hand their KV to the
decode plane.

Counterpart of ``kube_sqs_autoscaler_tpu/planes/prefill.py`` (without the
lifecycle notes).  A :class:`PrefillWorker` is a
:class:`~..fleet.worker.FleetWorker` whose cycle never dispatches a decode
step: it receives, runs the batched ``[M, P]`` admission insert (the CUDA
flash forward on the card), settles the first tokens (time to first
token is measured here, so prefills never queue behind gang blocks), and
offers every started row for handoff to the decode plane
(:meth:`~.engine.DecodePlaneBatcher.submit_handoff`).  Everything else is
the fleet worker's: TTL sheds, malformed bodies, tenancy staging, the
replies of requests that complete at prefill (budget 1, or eos as the
first token), the reply registry's dedup, and the kill and hang seams.
"""

from __future__ import annotations

import time

from ..fleet.worker import FleetWorker
from ..workloads.continuous import _Slot


class PrefillWorker(FleetWorker):
    """One prefill-plane replica: ``batch_size`` plain prefill slots (never
    the sharded plane), with the decode plane's ``generate_tokens``, so
    the handoff's budgets and the resume bucket line up."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("sharded", False)
        super().__init__(*args, **kwargs)
        if self.batcher.beams > 1 or self.batcher.draft_layers:
            raise ValueError(
                "the prefill plane runs the plain admission insert "
                "(drafting happens on the decode plane)"
            )
        self.handed_off = 0

    def run_once(self) -> int:
        """One prefill cycle: refill free slots (the batched insert),
        settle the first tokens and reply what completed at prefill.  Rows
        that need decoding stay busy with one token until the pool moves
        them (:meth:`ready_handoffs`)."""
        if self.killed or self.hung:
            return 0
        if self._served_since is None:
            self._served_since = time.perf_counter()
        self._refill()
        self.batcher._settle_pending_firsts()
        done = self.batcher._finish_ready()
        for message, tokens in done:
            self._settle(message, tokens)
        if done:
            self._poll_backoff = 0
        self.processed += len(done)
        self._update_metrics()
        return len(done)

    def ready_handoffs(self) -> list[tuple]:
        """Started, unfinished rows as ``(src_row, payload, produced,
        budget, submitted_at, tenant)`` handoff records.  A row stays busy,
        its cache rows untouched, until :meth:`complete_handoff` frees it,
        so the decode plane's copy reads live donor rows."""
        return [
            (row, slot.payload, list(slot.produced), slot.budget,
             slot.submitted_at, slot.tenant)
            for row, slot in enumerate(self.batcher.slots)
            if (slot.busy and slot.produced and not slot.done
                and len(slot.produced) < slot.budget)
        ]

    def complete_handoff(self, rows: list[int]) -> None:
        """Free the handed-off rows, after the decode plane's copy was
        enqueued: the next insert into them runs after the copy on the
        stream."""
        for row in rows:
            if self.lifecycle is not None:
                from ..obs.lifecycle import request_key

                # the donor half of the handoff audit: every handed_off
                # note pairs with a decode-plane handoff stamp
                self.lifecycle.note(
                    request_key(self.batcher.slots[row].payload),
                    "handed_off")
            self.batcher.slots[row] = _Slot()
        self.batcher._invalidate_admission_cache()
        self.handed_off += len(rows)
        if rows:
            self._poll_backoff = 0
